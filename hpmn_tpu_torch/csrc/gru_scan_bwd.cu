// GRU scan backward for Hopper (sm_90a): one launch sweeps one whole layer
// in reverse.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_bwd_kernel (its mask and no-mask
// forms, with and without the AUGRU gate scale), in both of its chains: f32
// (K2, hpmn_gru_scan_bwd; K2-scale, hpmn_gru_scan_bwd_scale) and
// dtype=bfloat16 (K2-bf16, hpmn_gru_scan_bwd_bf16; K2-scale-bf16,
// hpmn_gru_scan_bwd_scale_bf16). Per step t = T-1 .. 0, for batch row b,
// with m_t = 1 when there is no mask, a_t = 1 and zs = z in the no-scale
// forms:
//
//   h_prev = h_seq[t-1]            (h0, or zeros, at t = 0)
//   r, z, c, g_c recomputed from x_t and h_prev with gru_scan_fwd.cu's
//   formulas, bit for bit (gru_chain.cuh's project() and gates, the same
//   fmaf order); zs = z*a_t
//   gtot = dh_seq[t] + dh;   gcell = gtot * m_t
//   dzs = gcell*(c - h_prev); dc = gcell*zs*(1-c^2)
//   dz = dzs*a_t*z*(1-z);     dr = dc*g_c*r*(1-r)
//   dh = gcell*(1-zs) + (gtot - gcell) + [dr|dz|dc*r] @ wh^T
//   dx_t = [dr|dz|dc] @ wx^T
//   dWx += x_t^T [dr|dz|dc];  dWh += h_prev^T [dr|dz|dc*r];  db += [dr|dz|dc]
//   dscale[t, b] = sum_j dzs*z     (the scale forms: DIEN's attention
//                                   gradient, pallas_gru.py:255)
//
// (gtot - gcell) is the pass-through of a masked step: a padded step carries
// h unchanged, so its gradient flows to h_prev untouched. The scale is a
// compile-time flag (kScale): without it the instantiations are K2's and
// K2-bf16's code as they were, bit for bit. With it, a_t is loaded a step
// ahead with the step's other inputs, and dscale's sum over the 32 hidden
// units is a __shfl_xor_sync tree (gru_chain.cuh's warp_sum) that reads
// only the step's gate gradients, beside the dh carry's chain; lane 0
// writes dscale[t, b] in the stream type. Shared memory is unchanged.
//
// The bf16 chain rounds where the TPU kernel's does: x, h_seq, dh_seq and
// the mask are bf16 and dx is written as bf16; the dh carry stays f32, and
// gtot = bf16(dh_seq[t] + dh). dzs, dc, dz, dr, dc*r and the carry's own
// term gcell - gcell*z (+ gtot - gcell with a mask) are bf16, op by op;
// dh = f32(that term) + [dr|dz|dc*r] @ wh^T, summed in f32, and dx =
// bf16([dr|dz|dc] @ wx^T). The weight gradients are f32 sums of products
// of bf16 values, written as f32 partials; rounding them to the weights'
// bf16 is the wrapper's (as pallas_gru.py's _bwd does after its tile sum).
// The bf16 ops are native bf16 instructions (gru_chain.cuh); the weights
// stay f32 in shared memory, so the layout and the rows per block are the
// f32 form's.
//
// What bounds it: the recurrence, as in the forward. Each step needs the dh
// of the step after it, and per step and row the work is small: about 36k
// FLOPs in five 32-wide products (recompute x@wx and h@wh, dh, dx, the two
// weight-gradient outer products). Per row and step it streams 128 B of x,
// h_seq and dh_seq each in and 128 B of dx out (half that in bf16).
// Latency and issue bound it.
//
// What the design does about it. The layout is the forward's: the whole
// reverse loop in one launch, one warp per batch row, lane j owning hidden
// unit j, the dh carry in a register, operands broadcast with __shfl_sync,
// the next step's loads issued one step ahead.
//
// - The transposed products (dh and dx read wh and wx along rows: lane j
//   needs w[j][g*32+k] for a k shared by the warp, a 32-way bank conflict)
//   read transposed copies of wh and wx kept in shared memory beside the
//   row-major ones the recompute reads, so every read is conflict-free.
// - The weight gradients are accumulated in shared memory, one slice per
//   warp, where lane j owns column j of each gate block: no atomics, no
//   bank conflicts, and no 195 register accumulators per lane. At the end
//   the block sums its warps' slices and writes one partial per block; the
//   wrapper sums the partials (as the TPU kernel emits one per batch tile).
//
// The step's gate gradients, the dh/dx products, the weight-gradient
// accumulation and the shared-memory layout live in gru_chain.cuh, shared
// with the strided backward K4 (gru_scan_stride_bwd.cu).
//
// The port's forward keeps the whole h_seq, so the backward reads h_{t-1}
// from it: it needs no boundary states and no padding of T to 8.
//
// x and mask are read with a time stride (the next HPMN layer's input is the
// view h_seq[period-1::period]); h_seq, dh_seq and dx are contiguous.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kMaxChunks;  // d_in <= 96
using hpmn::load_f;
constexpr int kMaxWarps = 4;  // batch rows per block, at most

int rows_per_block(int d_in) {
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t free_bytes =
      hpmn::kMaxSmem - hpmn::weights_floats(d_in_pad) * 4;
  int w = (int)(free_bytes / (hpmn::acc_floats(d_in_pad) * 4));
  return w < kMaxWarps ? w : kMaxWarps;
}

struct StepIn {
  float x[kMaxChunks];  // lane k of chunk c: x_t[32*c + k]
  float hp;             // h_prev[lane]
  float dhs;            // dh_seq[t][lane]
  float m;              // mask_t (the f32 chain)
  float a;              // scale_t (the f32 chain; kScale)
  hpmn::B hpb, mb, ab;  // h_prev[lane], mask_t and scale_t as the bf16
                        // chain's values
};

template <typename S, bool kScale>
__device__ __forceinline__ void load_step(
    StepIn& s, int t, int row, int lane, int B, int d_in, int n_chunks,
    const S* __restrict__ x, long long x_tstride,
    const S* __restrict__ mask, long long m_tstride,
    const S* __restrict__ scale, long long s_tstride,
    const S* __restrict__ h0, const S* __restrict__ hseq,
    const S* __restrict__ dhseq) {
  const S* x_row = x + (long long)t * x_tstride + (long long)row * d_in;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = 32 * c + lane;
    s.x[c] = (c < n_chunks && k < d_in) ? load_f(x_row + k) : 0.0f;
  }
  if (t > 0)
    s.hp = load_f(hseq + ((long long)(t - 1) * B + row) * kDm + lane);
  else
    s.hp = h0 != nullptr ? load_f(h0 + (long long)row * kDm + lane) : 0.0f;
  s.dhs = load_f(dhseq + ((long long)t * B + row) * kDm + lane);
  s.m = mask != nullptr ? load_f(mask + (long long)t * m_tstride + row)
                        : 1.0f;
  if constexpr (kScale)
    s.a = load_f(scale + (long long)t * s_tstride + row);
  else
    s.a = 1.0f;  // unread: step_grad_* ignores it without kScale
  if constexpr (hpmn::kIsBf16<S>) {  // exact: the values are bf16
    s.hpb = hpmn::to_b(s.hp);
    s.mb = hpmn::to_b(s.m);
    s.ab = hpmn::to_b(s.a);
  }
}

// S: the stream type, float (K2) or __nv_bfloat16 (K2-bf16). kScale: the
// AUGRU forms, reading scale [T, B] (time stride s_tstride) and writing
// dscale [T, B] (contiguous).
template <typename S, bool kScale>
__global__ void __launch_bounds__(kMaxWarps * 32)
gru_scan_bwd_kernel(const S* __restrict__ x, long long x_tstride,
                    const S* __restrict__ mask, long long m_tstride,
                    const S* __restrict__ scale, long long s_tstride,
                    const S* __restrict__ wx, const S* __restrict__ wh,
                    const S* __restrict__ bias,
                    const S* __restrict__ h0,
                    const S* __restrict__ hseq,
                    const S* __restrict__ dhseq,
                    S* __restrict__ dx, S* __restrict__ dscale,
                    float* __restrict__ dh0,
                    float* __restrict__ dwx_part, float* __restrict__ dwh_part,
                    float* __restrict__ db_part, int T, int B, int d_in) {
  extern __shared__ float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * warps + warp;
  const hpmn::BwdSmem sm =
      hpmn::load_bwd_smem(smem, wx, wh, d_in, d_in_pad, warps, warp);

  if (row < B) {  // a warp past the last row skips to the block sum
    const float b_r = load_f(bias + lane);
    const float b_z = load_f(bias + kDm + lane);
    const float b_c = load_f(bias + 2 * kDm + lane);
    float dh = 0.0f;
    float db_r = 0.0f, db_z = 0.0f, db_c = 0.0f;
    StepIn cur;
    load_step<S, kScale>(cur, T - 1, row, lane, B, d_in, n_chunks, x,
                         x_tstride, mask, m_tstride, scale, s_tstride, h0,
                         hseq, dhseq);
    for (int t = T - 1; t >= 0; --t) {
      StepIn nxt;  // step t-1, loaded before this step's math
      if (t > 0)
        load_step<S, kScale>(nxt, t - 1, row, lane, B, d_in, n_chunks, x,
                             x_tstride, mask, m_tstride, scale, s_tstride,
                             h0, hseq, dhseq);

      // Recompute the forward's gates (gru_scan_fwd.cu, the same order).
      const hpmn::Proj p =
          hpmn::project(cur.x, n_chunks, cur.hp, sm.wx, sm.wh, lane);
      hpmn::StepGrad sg;
      if constexpr (hpmn::kIsBf16<S>)
        sg = hpmn::step_grad_bf16<kScale>(
            hpmn::gates_bf16(p, b_r, b_z, b_c), cur.hpb,
            hpmn::to_b(cur.dhs + dh), cur.mb, mask != nullptr, cur.ab);
      else
        sg = hpmn::step_grad_f32<kScale>(hpmn::gates_f32(p, b_r, b_z, b_c),
                                         cur.hp, cur.dhs + dh, cur.m, cur.a);

      const float dh_new = hpmn::backprop_step(
          sg, sm, n_chunks, d_in, d_in_pad, lane,
          dx + ((long long)t * B + row) * d_in);
      hpmn::accumulate_wgrad(cur.x, cur.hp, sg, sm, n_chunks, d_in_pad,
                             lane);
      if constexpr (kScale) {
        const float da = hpmn::warp_sum(sg.da);
        if (lane == 0) hpmn::store_f(dscale + (long long)t * B + row, da);
      }
      db_r += sg.dr;
      db_z += sg.dz;
      db_c += sg.dc;
      dh = dh_new;
      if (t > 0) cur = nxt;
    }
    dh0[(long long)row * kDm + lane] = dh;
    float* acc_b = sm.acc + (d_in_pad + kDm) * hpmn::kG;
    acc_b[lane] = db_r;
    acc_b[kDm + lane] = db_z;
    acc_b[2 * kDm + lane] = db_c;
  }
  __syncthreads();
  hpmn::write_wgrad_partials(sm, warps, d_in, d_in_pad, dwx_part, dwh_part,
                             db_part);
}

// x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B] (time
// stride m_tstride) or null, scale [T,B] (time stride s_tstride; the scale
// forms only, not null), wx [d_in,96], wh [32,96], b [96], h0 [B,32] or
// null, hseq and dhseq [T,B,32] contiguous, all of one type S: float for K2,
// bf16 for K2-bf16. Writes dx [T,B,d_in] (S), dscale [T,B] (S; the scale
// forms) and dh0 [B,32] (f32, the carry), all contiguous, and per block the
// f32 partials dwx_part [d_in,96], dwh_part [32,96] and db_part [96].
// Launches on `stream`; returns cudaGetLastError().
template <typename S, bool kScale>
int launch(const S* x, long long x_tstride, const S* mask, long long m_tstride,
           const S* scale, long long s_tstride, const S* wx, const S* wh,
           const S* b, const S* h0, const S* hseq, const S* dhseq, S* dx,
           S* dscale, float* dh0, float* dwx_part, float* dwh_part,
           float* db_part, int T, int B, int d_in, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1
      || (kScale && (scale == nullptr || dscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const int warps = rows_per_block(d_in);
  const size_t smem =
      (hpmn::weights_floats(d_in_pad) + warps * hpmn::acc_floats(d_in_pad)) *
      4;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_bwd_kernel<S, kScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + warps - 1) / warps;
  gru_scan_bwd_kernel<S, kScale>
      <<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
          x, x_tstride, mask, m_tstride, scale, s_tstride, wx, wh, b, h0,
          hseq, dhseq, dx, dscale, dh0, dwx_part, dwh_part, db_part, T, B,
          d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch rows per block for this d_in: the wrapper allocates one weight-
// gradient partial per block, ceil(B / rows) of them.
extern "C" int hpmn_gru_scan_bwd_rows_per_block(int d_in) {
  if (d_in < 1 || d_in > 32 * kMaxChunks) return 0;
  return rows_per_block(d_in);
}

extern "C" int hpmn_gru_scan_bwd(const float* x, long long x_tstride,
                                 const float* mask, long long m_tstride,
                                 const float* wx, const float* wh,
                                 const float* b, const float* h0,
                                 const float* hseq, const float* dhseq,
                                 float* dx, float* dh0, float* dwx_part,
                                 float* dwh_part, float* db_part, int T,
                                 int B, int d_in, void* stream) {
  return launch<float, false>(x, x_tstride, mask, m_tstride, nullptr, 0, wx,
                              wh, b, h0, hseq, dhseq, dx, nullptr, dh0,
                              dwx_part, dwh_part, db_part, T, B, d_in,
                              stream);
}

extern "C" int hpmn_gru_scan_bwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* wx, const __nv_bfloat16* wh,
    const __nv_bfloat16* b, const __nv_bfloat16* h0,
    const __nv_bfloat16* hseq, const __nv_bfloat16* dhseq,
    __nv_bfloat16* dx, float* dh0, float* dwx_part, float* dwh_part,
    float* db_part, int T, int B, int d_in, void* stream) {
  return launch<__nv_bfloat16, false>(
      x, x_tstride, mask, m_tstride, nullptr, 0, wx, wh, b, h0, hseq, dhseq,
      dx, nullptr, dh0, dwx_part, dwh_part, db_part, T, B, d_in, stream);
}

// K2-scale and K2-scale-bf16: as above, plus scale [T,B] (time stride
// s_tstride, unit batch stride; not null), the AUGRU's a_t, and its
// gradient dscale [T,B] (contiguous, not null), of the stream type.
extern "C" int hpmn_gru_scan_bwd_scale(
    const float* x, long long x_tstride, const float* mask,
    long long m_tstride, const float* scale, long long s_tstride,
    const float* wx, const float* wh, const float* b, const float* h0,
    const float* hseq, const float* dhseq, float* dx, float* dscale,
    float* dh0, float* dwx_part, float* dwh_part, float* db_part, int T,
    int B, int d_in, void* stream) {
  return launch<float, true>(x, x_tstride, mask, m_tstride, scale, s_tstride,
                             wx, wh, b, h0, hseq, dhseq, dx, dscale, dh0,
                             dwx_part, dwh_part, db_part, T, B, d_in, stream);
}

extern "C" int hpmn_gru_scan_bwd_scale_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* scale, long long s_tstride,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* h0, const __nv_bfloat16* hseq,
    const __nv_bfloat16* dhseq, __nv_bfloat16* dx, __nv_bfloat16* dscale,
    float* dh0, float* dwx_part, float* dwh_part, float* db_part, int T,
    int B, int d_in, void* stream) {
  return launch<__nv_bfloat16, true>(
      x, x_tstride, mask, m_tstride, scale, s_tstride, wx, wh, b, h0, hseq,
      dhseq, dx, dscale, dh0, dwx_part, dwh_part, db_part, T, B, d_in,
      stream);
}

// GRU scan backward for Hopper (sm_90a).
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_bwd_kernel (its mask and no-mask
// forms, with and without the AUGRU gate scale), in both of its chains: f32
// (K2, hpmn_gru_scan_bwd_ws; K2-scale, hpmn_gru_scan_bwd_scale_ws) and
// dtype=bfloat16 (K2-bf16, hpmn_gru_scan_bwd_bf16_ws; K2-scale-bf16,
// hpmn_gru_scan_bwd_scale_bf16_ws). Per step t = T-1 .. 0, for batch row b,
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
// h unchanged, so its gradient flows to h_prev untouched.
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
// stay f32 in shared memory, so the layout is the f32 form's.
//
// What bounds it: the recurrence. Each step needs the dh of the step after
// it; per step and row the work is small (about 36k FLOPs in five 32-wide
// products: the recompute's x@wx and h@wh, dh, dx and the two weight-
// gradient outer products), and only the recompute, the gate gradients and
// dh's product are on the chain from one step to the next. dx and the
// weight gradients read only the step's gate gradients, and dscale only
// the step's gate values.
//
// Every form is therefore two kernels per chunk of steps, run by one C
// entry point from the last chunk to the first:
//
// - the recurrence (gru_scan_bwd_rec_kernel, here; kScale for the scale
//   forms): one warp per batch row and block, lane j owning hidden unit j,
//   the dh carry in a register, wh in registers in both of its layouts, the
//   next step's loads (a_t among them) issued one step ahead. Per step it
//   recomputes the gates, takes the gate gradients and dh's product with
//   wh^T, and writes the gate gradients [dr, dz, dc, dc*r] of lane k as 4
//   values into a workspace dg [Tc, B, 32, 4] of the stream type (in bf16
//   they are bf16 values, so storing them is exact); the scale forms'
//   dz carries a_t already, so dg's layout is the same. The carry crosses a
//   chunk boundary through dh0 [B, 32] (f32), which holds dh0 after the
//   first chunk. In the scale forms dscale[t, b] is a __shfl_xor_sync tree
//   over the 32 hidden units (gru_chain.cuh's warp_sum) beside the dh
//   carry's chain; lane 0 writes it in the stream type.
// - the pass (gru_bwd_pass.cu), the same for every form: dx and each row's
//   weight-gradient sums from x, h_prev and dg, in parallel over rows and
//   steps, each sum in the recurrence's own order (see there); after the
//   last chunk, one partial per group of rows_per_block(d_in) rows. The
//   wrapper sums the partials (as the TPU kernel emits one per batch tile).
//
// Every output is that of the one-kernel loop that every form once was (dx
// and the weight gradients inside the reverse loop), bit for bit, whatever
// the chunk: the carry and the sums cross chunks in f32, unrounded, and
// dscale's tree is the loop's.
//
// The port's forward keeps the whole h_seq, so the backward reads h_{t-1}
// from it: it needs no boundary states and no padding of T to 8.
//
// x, mask and scale are read with a time stride (the next HPMN layer's input
// is the view h_seq[period-1::period]); h_seq, dh_seq, dx and dscale are
// contiguous.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kMaxChunks;  // d_in <= 96
using hpmn::load_f;
constexpr int kMaxWarps = 4;  // batch rows per group, at most

// The group of batch rows that each weight-gradient partial sums: the rows
// per block of the one-kernel loop that K2 and K2-scale once were (its
// shared memory held a weight-gradient slice per row), whose partials'
// bits every form keeps.
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

// The recurrence of K2 (S = float) and K2-bf16 (S = __nv_bfloat16) over the
// chunk [t0, t0 + n), and with kScale that of K2-scale and K2-scale-bf16:
// the one-kernel loop that K2 and the scale forms once were, with dx, the
// weight-gradient sums and db taken out. Per step it writes the gate
// gradients into dg [n, B, 32, 4] (S) at (t - t0, row, lane). dh [B, 32]
// (f32) carries dh in (`carry_in`; else it starts at zero) and out. With
// kScale it reads scale [T, B] (time stride s_tstride) with the step's other
// loads, one step ahead; dz already carries the factor a_t
// (step_grad_*<true>), so dg keeps its layout and the pass is K2's; and lane
// 0 writes dscale[t, row] (S), the warp_sum of the step's da over the 32
// hidden units, the one-kernel loop's shuffle tree. dscale reads only the
// step's own gate values, so nothing of it crosses a chunk.
//
// One warp, one batch row, per block (4 rows per block took 1.37x as long
// in f32; PERF.md). Both of the step's products with wh read it from
// registers: the recompute's h @ wh (lane j: wh[k][32g + j]) and dh's
// [dr|dz|dc*r] @ wh^T (lane j: wh[j][32g + k]), 192 floats a lane; x_t
// and h_prev, and the gate gradients, are broadcast through shared memory
// as float4s (one 16-byte load for 4 of k) instead of one __shfl_sync per
// value; wx stays in shared memory. The fmaf orders are project()'s and
// backprop_step()'s, so the bits are the one-kernel loop's.
template <typename S, bool kScale>
__global__ void __launch_bounds__(32)
gru_scan_bwd_rec_kernel(const S* __restrict__ x, long long x_tstride,
                        const S* __restrict__ mask, long long m_tstride,
                        const S* __restrict__ scale, long long s_tstride,
                        const S* __restrict__ wx, const S* __restrict__ wh,
                        const S* __restrict__ bias,
                        const S* __restrict__ h0,
                        const S* __restrict__ hseq,
                        const S* __restrict__ dhseq, S* __restrict__ dg,
                        S* __restrict__ dscale, float* __restrict__ dh,
                        int t0, int n, bool carry_in, int B, int d_in) {
  extern __shared__ __align__(16) float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  float* s_wx = smem;                         // [d_in_pad][96], zero past d_in
  float* s_xh = s_wx + d_in_pad * hpmn::kG;   // x_t [d_in_pad], h_prev [32]
  float4* s_g = reinterpret_cast<float4*>(s_xh + d_in_pad + kDm);  // [32]
  for (int i = lane; i < d_in_pad * hpmn::kG; i += 32)
    s_wx[i] = i / hpmn::kG < d_in ? load_f(wx + i) : 0.0f;
  float wh_k[3][kDm];  // wh[k][32g + lane]: the recompute's h @ wh
  float wh_t[3][kDm];  // wh[lane][32g + k]: dh's products with wh^T
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < kDm; ++k) {
      wh_k[g][k] = load_f(wh + k * hpmn::kG + g * kDm + lane);
      wh_t[g][k] = load_f(wh + lane * hpmn::kG + g * kDm + k);
    }

  const float b_r = load_f(bias + lane);
  const float b_z = load_f(bias + kDm + lane);
  const float b_c = load_f(bias + 2 * kDm + lane);
  float dhc = carry_in ? dh[(long long)row * kDm + lane] : 0.0f;
  StepIn cur;
  load_step<S, kScale>(cur, t0 + n - 1, row, lane, B, d_in, n_chunks, x,
                       x_tstride, mask, m_tstride, scale, s_tstride, h0,
                       hseq, dhseq);
  for (int t = t0 + n - 1; t >= t0; --t) {
    StepIn nxt;  // step t-1, loaded before this step's math
    if (t > t0)
      load_step<S, kScale>(nxt, t - 1, row, lane, B, d_in, n_chunks, x,
                           x_tstride, mask, m_tstride, scale, s_tstride, h0,
                           hseq, dhseq);

    // Recompute the forward's gates: project()'s sums, the same order.
    __syncwarp();  // every lane is done with the last step's broadcasts
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
      if (c < n_chunks) s_xh[32 * c + lane] = cur.x[c];
    s_xh[d_in_pad + lane] = cur.hp;
    __syncwarp();
    hpmn::Proj p;
    p.ar = p.az = p.ac = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < n_chunks) {
#pragma unroll
        for (int k4 = 0; k4 < 8; ++k4) {
          const float4 q =
              *reinterpret_cast<const float4*>(s_xh + 32 * c + 4 * k4);
          const float xq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* w = s_wx + (32 * c + 4 * k4 + e) * hpmn::kG;
            p.ar = fmaf(xq[e], w[lane], p.ar);
            p.az = fmaf(xq[e], w[kDm + lane], p.az);
            p.ac = fmaf(xq[e], w[2 * kDm + lane], p.ac);
          }
        }
      }
    }
    p.gr = p.gz = p.gc = 0.0f;
#pragma unroll
    for (int k4 = 0; k4 < 8; ++k4) {
      const float4 q =
          *reinterpret_cast<const float4*>(s_xh + d_in_pad + 4 * k4);
      const float hq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * k4 + e;
        p.gr = fmaf(hq[e], wh_k[0][k], p.gr);
        p.gz = fmaf(hq[e], wh_k[1][k], p.gz);
        p.gc = fmaf(hq[e], wh_k[2][k], p.gc);
      }
    }
    hpmn::StepGrad sg;
    if constexpr (hpmn::kIsBf16<S>)
      sg = hpmn::step_grad_bf16<kScale>(
          hpmn::gates_bf16(p, b_r, b_z, b_c), cur.hpb,
          hpmn::to_b(cur.dhs + dhc), cur.mb, mask != nullptr, cur.ab);
    else
      sg = hpmn::step_grad_f32<kScale>(hpmn::gates_f32(p, b_r, b_z, b_c),
                                       cur.hp, cur.dhs + dhc, cur.m, cur.a);
    hpmn::store4(dg + (((long long)(t - t0) * B + row) * kDm + lane) * 4,
                 sg.dr, sg.dz, sg.dc, sg.dcr);

    // dh_prev = carry + [dr|dz|dc*r] @ wh^T: backprop_step()'s chain over k
    // (dr, dz, dc*r interleaved); in bf16 the carry's term is added after
    // the f32 sum of the products.
    s_g[lane] = make_float4(sg.dr, sg.dz, sg.dc, sg.dcr);
    __syncwarp();
    float dh_new = hpmn::kIsBf16<S> ? 0.0f : sg.carry;
#pragma unroll
    for (int k = 0; k < kDm; ++k) {
      const float4 d = s_g[k];
      dh_new = fmaf(d.x, wh_t[0][k], dh_new);
      dh_new = fmaf(d.y, wh_t[1][k], dh_new);
      dh_new = fmaf(d.w, wh_t[2][k], dh_new);
    }
    if constexpr (kScale) {
      const float da = hpmn::warp_sum(sg.da);
      if (lane == 0) hpmn::store_f(dscale + (long long)t * B + row, da);
    }
    dhc = hpmn::kIsBf16<S> ? sg.carry + dh_new : dh_new;
    if (t > t0) cur = nxt;
  }
  dh[(long long)row * kDm + lane] = dhc;
}

}  // namespace

// Batch rows per weight-gradient partial for this d_in: the wrapper
// allocates ceil(B / rows) partials.
extern "C" int hpmn_gru_scan_bwd_rows_per_block(int d_in) {
  if (d_in < 1 || d_in > 32 * kMaxChunks) return 0;
  return rows_per_block(d_in);
}

namespace {

// K2, K2-bf16 and, with kScale, K2-scale and K2-scale-bf16: every chunk of
// t_chunk steps from the last (the chunk at t = 0 the shorter), the
// recurrence then the pass, then the partials.
template <typename S, bool kScale>
int launch_ws(const S* x, long long x_tstride, const S* mask,
              long long m_tstride, const S* scale, long long s_tstride,
              const S* wx, const S* wh, const S* b, const S* h0,
              const S* hseq, const S* dhseq, S* dx, float* dh0,
              float* dwx_part, float* dwh_part, float* db_part, S* dscale,
              S* dg, float* acc, int t_chunk, int T, int B, int d_in,
              void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1 || t_chunk < 1
      || dg == nullptr || acc == nullptr
      || (kScale && (scale == nullptr || dscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t smem =
      ((size_t)d_in_pad * hpmn::kG + d_in_pad + kDm + 4 * kDm) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_bwd_rec_kernel<S, kScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int hi = T; hi > 0;) {
    const int n = t_chunk < hi ? t_chunk : hi;
    const int t0 = hi - n;
    gru_scan_bwd_rec_kernel<S, kScale><<<B, 32, smem, st>>>(
        x, x_tstride, mask, m_tstride, scale, s_tstride, wx, wh, b, h0,
        hseq, dhseq, dg, dscale, dh0, t0, n, hi < T, B, d_in);
    int code = (int)cudaGetLastError();
    if (code != 0) return code;
    code = hpmn::launch_bwd_pass<S>(x, x_tstride, wx, h0, hseq, 1, dg, dx,
                                    acc, t0, n, hi == T, B, d_in, st);
    if (code != 0) return code;
    hi = t0;
  }
  return hpmn::launch_wgrad_partials(acc, rows_per_block(d_in), B, d_in,
                                     dwx_part, dwh_part, db_part, st);
}

}  // namespace

// K2: x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B]
// (time stride m_tstride) or null, wx [d_in,96], wh [32,96], b [96], h0
// [B,32] or null, hseq and dhseq [T,B,32] contiguous, all float32. Writes
// dx [T,B,d_in] and dh0 [B,32], and one f32 partial per group of
// hpmn_gru_scan_bwd_rows_per_block(d_in) rows: dwx_part [d_in,96],
// dwh_part [32,96], db_part [96]. Workspaces: dg [t_chunk,B,128] (float32)
// and acc [B, (d_in_pad + 33) * 96] (f32, d_in_pad = d_in rounded up to
// 32). Runs on `stream`; returns the first nonzero cudaGetLastError()
// after a launch, or 0.
extern "C" int hpmn_gru_scan_bwd_ws(const float* x, long long x_tstride,
                                    const float* mask, long long m_tstride,
                                    const float* wx, const float* wh,
                                    const float* b, const float* h0,
                                    const float* hseq, const float* dhseq,
                                    float* dx, float* dh0, float* dwx_part,
                                    float* dwh_part, float* db_part,
                                    float* dg, float* acc, int t_chunk,
                                    int T, int B, int d_in, void* stream) {
  return launch_ws<float, false>(x, x_tstride, mask, m_tstride, nullptr, 0,
                                 wx, wh, b, h0, hseq, dhseq, dx, dh0,
                                 dwx_part, dwh_part, db_part, nullptr, dg,
                                 acc, t_chunk, T, B, d_in, stream);
}

// K2-bf16: as K2, with x, mask, the weights, h0, hseq, dhseq, dx and dg in
// bf16 (dh0, the partials and acc f32).
extern "C" int hpmn_gru_scan_bwd_bf16_ws(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* wx, const __nv_bfloat16* wh,
    const __nv_bfloat16* b, const __nv_bfloat16* h0,
    const __nv_bfloat16* hseq, const __nv_bfloat16* dhseq,
    __nv_bfloat16* dx, float* dh0, float* dwx_part, float* dwh_part,
    float* db_part, __nv_bfloat16* dg, float* acc, int t_chunk, int T, int B,
    int d_in, void* stream) {
  return launch_ws<__nv_bfloat16, false>(
      x, x_tstride, mask, m_tstride, nullptr, 0, wx, wh, b, h0, hseq, dhseq,
      dx, dh0, dwx_part, dwh_part, db_part, nullptr, dg, acc, t_chunk, T, B,
      d_in, stream);
}

// K2-scale: as K2, with scale [T,B] (time stride s_tstride, unit batch
// stride; not null), the AUGRU's a_t, after the mask; and its gradient
// dscale [T,B] (contiguous, not null) after the partials.
extern "C" int hpmn_gru_scan_bwd_scale_ws(
    const float* x, long long x_tstride, const float* mask,
    long long m_tstride, const float* scale, long long s_tstride,
    const float* wx, const float* wh, const float* b, const float* h0,
    const float* hseq, const float* dhseq, float* dx, float* dh0,
    float* dwx_part, float* dwh_part, float* db_part, float* dscale,
    float* dg, float* acc, int t_chunk, int T, int B, int d_in,
    void* stream) {
  return launch_ws<float, true>(x, x_tstride, mask, m_tstride, scale,
                                s_tstride, wx, wh, b, h0, hseq, dhseq, dx,
                                dh0, dwx_part, dwh_part, db_part, dscale, dg,
                                acc, t_chunk, T, B, d_in, stream);
}

// K2-scale-bf16: as K2-bf16, with the scale and dscale of K2-scale in bf16.
extern "C" int hpmn_gru_scan_bwd_scale_bf16_ws(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* scale, long long s_tstride,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* h0, const __nv_bfloat16* hseq,
    const __nv_bfloat16* dhseq, __nv_bfloat16* dx, float* dh0,
    float* dwx_part, float* dwh_part, float* db_part, __nv_bfloat16* dscale,
    __nv_bfloat16* dg, float* acc, int t_chunk, int T, int B, int d_in,
    void* stream) {
  return launch_ws<__nv_bfloat16, true>(
      x, x_tstride, mask, m_tstride, scale, s_tstride, wx, wh, b, h0, hseq,
      dhseq, dx, dh0, dwx_part, dwh_part, db_part, dscale, dg, acc, t_chunk,
      T, B, d_in, stream);
}

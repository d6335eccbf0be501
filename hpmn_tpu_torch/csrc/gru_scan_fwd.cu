// GRU scan forward for Hopper (sm_90a): one launch scans one whole layer.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_fwd_kernel (its mask and no-mask
// forms, with and without the AUGRU gate scale), in both of its chains:
// f32 (K1, hpmn_gru_scan_fwd; K1-scale, hpmn_gru_scan_fwd_scale) and
// dtype=bfloat16 (K1-bf16, hpmn_gru_scan_fwd_bf16; K1-scale-bf16,
// hpmn_gru_scan_fwd_scale_bf16; the chain is described in gru_chain.cuh).
// Per step, for batch row b:
//
//   xp = x_t @ wx + b          (input projection, computed here as in the
//                               TPU kernel, not hoisted out to a library)
//   g  = h @ wh
//   r = sigmoid(xp_r + g_r);  z = sigmoid(xp_z + g_z)
//   c = tanh(xp_c + r * g_c)  (linear before reset)
//   zs = z * a_t               (the scale forms: DIEN's AUGRU; else zs = z)
//   h_cell = h + zs * (c - h); h' = h + m_t * (h_cell - h)
//
// With no mask, the f32 form takes m_t = 1 and the bf16 form h' = h_cell, as
// the TPU kernel's has_mask=False does (in bf16 the two can differ by a
// rounding). The scale is a compile-time flag (kScale): without it the
// instantiations are the code of K1 and K1-bf16 as they were, bit for bit.
// a [T, B] is read like the mask, one value per row and step, loaded
// before the step's projections so that its latency hides behind them;
// zs adds one multiply to the step's chain.
//
// What bounds it: the recurrence. Step t needs h_{t-1}, so one row's T steps
// run one after another and the work per step is small (d_m = 32: 192 FMAs
// per hidden unit for both projections). The kernel is latency-bound, not
// bound by bytes (x and h_seq stream once: 256 B per row and step in f32,
// 128 B in bf16) or FLOPs. The bf16 form moves half the bytes, which are
// not on that chain, and adds to the chain: its gate ops are bf16 ops
// (one native instruction each, gru_chain.cuh) with conversions around
// the three tanhf and the four pre-activation roundings. On the H100 it
// takes longer than the f32 form (PERF.md).
//
// What the design does about it: the whole time loop runs inside the
// kernel, with the carry in registers, so no launch or device-memory round
// trip sits between steps. One warp owns one batch row and lane j owns hidden
// unit j, so a step needs no block barrier: x_t and h_{t-1} reach every lane
// through __shfl_sync, and wx and wh sit in shared memory (as f32, converted
// once from the bf16 weights in the bf16 form), where lane j reads column j
// of each block (consecutive words, no bank conflicts). The next step's x
// row is loaded one step ahead to hide its latency. h_seq is written at
// [t, b, :], one contiguous row per warp and step.
//
// The TPU kernel's packed [wx_r|wx_z|wx_c|0] / [wh_r|wh_z|0|wh_c] weights
// (a 128-lane trick), its padding of T to a multiple of 8 and its boundary
// states (inputs of the backward kernel only) are not carried over.
//
// Time strides: x and mask are read at x + t*x_tstride and mask +
// t*m_tstride, so the next HPMN layer's input h_seq[period-1::period] is
// passed as a strided view with no copy.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kMaxChunks;  // d_in <= 96: weights fit 48 KB of smem
constexpr int kWarps = 4;  // batch rows per block

// S: the stream type, float (K1) or __nv_bfloat16 (K1-bf16). kScale: the
// AUGRU forms, reading scale [T, B] (time stride s_tstride).
template <typename S, bool kScale>
__global__ void __launch_bounds__(kWarps * 32)
gru_scan_fwd_kernel(const S* __restrict__ x, long long x_tstride,
                    const S* __restrict__ mask, long long m_tstride,
                    const S* __restrict__ scale, long long s_tstride,
                    const S* __restrict__ wx, const S* __restrict__ wh,
                    const S* __restrict__ bias,
                    const S* __restrict__ h0, S* __restrict__ hseq,
                    int T, int B, int d_in) {
  using hpmn::load_f;
  extern __shared__ float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  float* s_wx = smem;                        // [d_in_pad][3*kDm], zero rows
  float* s_wh = smem + d_in_pad * 3 * kDm;   // [kDm][3*kDm]
  for (int i = threadIdx.x; i < d_in_pad * 3 * kDm; i += blockDim.x)
    s_wx[i] = i < d_in * 3 * kDm ? load_f(wx + i) : 0.0f;
  for (int i = threadIdx.x; i < kDm * 3 * kDm; i += blockDim.x)
    s_wh[i] = load_f(wh + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave; no barrier follows

  const float b_r = load_f(bias + lane);
  const float b_z = load_f(bias + kDm + lane);
  const float b_c = load_f(bias + 2 * kDm + lane);
  float h = h0 != nullptr ? load_f(h0 + (long long)row * kDm + lane) : 0.0f;
  hpmn::B hb = hpmn::to_b(h);  // the bf16 chain's carry (h is its f32 copy)

  // x_t of this row, lane k of chunk c holding element 32*c + k.
  float xv[kMaxChunks];
  const S* x_row = x + (long long)row * d_in;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = 32 * c + lane;
    xv[c] = (c < n_chunks && k < d_in && T > 0) ? load_f(x_row + k) : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    // Issue the next step's loads before this step's math.
    float xn[kMaxChunks];
    const bool more = t + 1 < T;
    const S* x_next = x_row + (long long)(t + 1) * x_tstride;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int k = 32 * c + lane;
      xn[c] = (more && c < n_chunks && k < d_in) ? load_f(x_next + k) : 0.0f;
    }
    const S* m_ptr = mask + (long long)t * m_tstride + row;
    const float m = mask != nullptr ? load_f(m_ptr) : 1.0f;  // f32 chain
    const hpmn::B mb = mask != nullptr ? hpmn::load_b(m_ptr) : hpmn::one_b();
    float a = 1.0f;  // the scale, f32 chain
    hpmn::B ab = hpmn::one_b();  // the scale, bf16 chain
    if constexpr (kScale) {
      const S* a_ptr = scale + (long long)t * s_tstride + row;
      if constexpr (hpmn::kIsBf16<S>)
        ab = hpmn::load_b(a_ptr);
      else
        a = load_f(a_ptr);
    }

    const hpmn::Proj p = hpmn::project(xv, n_chunks, h, s_wx, s_wh, lane);
    S* h_out = hseq + ((long long)t * B + row) * kDm + lane;
    if constexpr (hpmn::kIsBf16<S>) {
      using hpmn::add_b;
      using hpmn::mul_b;
      using hpmn::sub_b;
      const hpmn::GatesB g = hpmn::gates_bf16(p, b_r, b_z, b_c);
      const hpmn::B zs = kScale ? mul_b(g.z, ab) : g.z;
      const hpmn::B h_cell = add_b(hb, mul_b(zs, sub_b(g.c, hb)));
      hb = mask != nullptr ? add_b(hb, mul_b(mb, sub_b(h_cell, hb))) : h_cell;
      h = hpmn::to_f(hb);
      *h_out = hb;
    } else {
      const hpmn::Gates g = hpmn::gates_f32(p, b_r, b_z, b_c);
      const float zs = kScale ? g.z * a : g.z;
      const float h_cell = h + zs * (g.c - h);
      h = h + m * (h_cell - h);
      hpmn::store_f(h_out, h);
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) xv[c] = xn[c];
  }
}

template <typename S, bool kScale>
int launch(const S* x, long long x_tstride, const S* mask, long long m_tstride,
           const S* scale, long long s_tstride, const S* wx, const S* wh,
           const S* b, const S* h0, S* hseq, int T, int B, int d_in,
           void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1
      || (kScale && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t smem = (size_t)(d_in_pad + kDm) * 3 * kDm * sizeof(float);
  const int grid = (B + kWarps - 1) / kWarps;
  gru_scan_fwd_kernel<S, kScale>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          x, x_tstride, mask, m_tstride, scale, s_tstride, wx, wh, b, h0,
          hseq, T, B, d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B] (time
// stride m_tstride) or null, wx [d_in,96], wh [32,96], b [96], h0 [B,32] or
// null, hseq [T,B,32] contiguous, all of one type: float for K1, bf16 for
// K1-bf16. Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int hpmn_gru_scan_fwd(const float* x, long long x_tstride,
                                 const float* mask, long long m_tstride,
                                 const float* wx, const float* wh,
                                 const float* b, const float* h0, float* hseq,
                                 int T, int B, int d_in, void* stream) {
  return launch<float, false>(x, x_tstride, mask, m_tstride, nullptr, 0, wx,
                              wh, b, h0, hseq, T, B, d_in, stream);
}

extern "C" int hpmn_gru_scan_fwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* wx, const __nv_bfloat16* wh,
    const __nv_bfloat16* b, const __nv_bfloat16* h0, __nv_bfloat16* hseq,
    int T, int B, int d_in, void* stream) {
  return launch<__nv_bfloat16, false>(x, x_tstride, mask, m_tstride, nullptr,
                                      0, wx, wh, b, h0, hseq, T, B, d_in,
                                      stream);
}

// K1-scale and K1-scale-bf16: as above, plus scale [T,B] (time stride
// s_tstride, unit batch stride; not null), the AUGRU's a_t, of the same
// type.
extern "C" int hpmn_gru_scan_fwd_scale(
    const float* x, long long x_tstride, const float* mask,
    long long m_tstride, const float* scale, long long s_tstride,
    const float* wx, const float* wh, const float* b, const float* h0,
    float* hseq, int T, int B, int d_in, void* stream) {
  return launch<float, true>(x, x_tstride, mask, m_tstride, scale, s_tstride,
                             wx, wh, b, h0, hseq, T, B, d_in, stream);
}

extern "C" int hpmn_gru_scan_fwd_scale_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* scale, long long s_tstride,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* h0, __nv_bfloat16* hseq, int T, int B, int d_in,
    void* stream) {
  return launch<__nv_bfloat16, true>(x, x_tstride, mask, m_tstride, scale,
                                     s_tstride, wx, wh, b, h0, hseq, T, B,
                                     d_in, stream);
}

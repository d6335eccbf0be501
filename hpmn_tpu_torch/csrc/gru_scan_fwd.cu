// GRU scan forward for Hopper (sm_90a): one call scans one whole layer.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_fwd_kernel (its mask and no-mask
// forms, with and without the AUGRU gate scale), in both of its chains:
// f32 (K1, hpmn_gru_scan_fwd_ws; K1-scale, hpmn_gru_scan_fwd_scale_ws) and
// dtype=bfloat16 (K1-bf16, hpmn_gru_scan_fwd_bf16_ws; K1-scale-bf16,
// hpmn_gru_scan_fwd_scale_bf16_ws; the chain is described in
// gru_chain.cuh). Its recurrence also runs the strided forward, which
// replaces _fwd_stride_kernel (K3, hpmn_gru_scan_stride_fwd_ws; K3-bf16,
// hpmn_gru_scan_stride_fwd_bf16_ws; gru_scan_stride_fwd.cu has what it
// writes).
// Per step, for batch row b:
//
//   xp = x_t @ wx + b          (input projection)
//   g  = h @ wh
//   r = sigmoid(xp_r + g_r);  z = sigmoid(xp_z + g_z)
//   c = tanh(xp_c + r * g_c)  (linear before reset)
//   zs = z * a_t               (the scale forms: DIEN's AUGRU; else zs = z)
//   h_cell = h + zs * (c - h); h' = h + m_t * (h_cell - h)
//
// With no mask, the f32 forms take m_t = 1 and the bf16 forms h' = h_cell,
// as the TPU kernel's has_mask=False does (in bf16 the two can differ by a
// rounding).
//
// What bounds it: the recurrence. Step t needs h_{t-1}, so one row's T steps
// run one after another and the work per step is small (d_m = 32). The
// kernels are latency-bound, not bound by bytes (x and h_seq stream once:
// 256 B per row and step in f32, 128 B in bf16) or FLOPs. What every form
// does about it: the whole time loop runs inside one launch, with the carry
// in registers, so no launch or device-memory round trip sits between
// steps; one warp owns one batch row and lane j owns hidden unit j, so a
// step needs no block barrier. h_seq is written at [t, b, :], one
// contiguous row per warp and step.
//
// Every form runs in two kernels per chunk of time steps:
//
// 1. gru_input_proj.cu computes the x half of the step's products for the
//    chunk into an f32 workspace [Tc, B, 96] that the caller allocates:
//    the half that does not depend on h, as one tiled pass bound by bytes.
//    Each output is the fmaf chain of project()'s x part: in f32 xp = x @
//    wx + b, so xp_r is p.ar + b_r bit for bit; in bf16 the r and z blocks
//    are x @ wx without the bias (the chain sums (x@wx + h@wh) + b) and the
//    c block the chain's pre_c, ac + b_c rounded to bf16.
// 2. gru_scan_fwd_xp_kernel runs the recurrence: lane j holds its 96
//    weights wh[:, j], wh[:, 32+j], wh[:, 64+j] in registers (as f32, from
//    bf16 in the bf16 forms), loaded once, so a step makes no shared-memory
//    weight load; h_{t-1} reaches every lane through 32 __shfl_sync in f32
//    (one store per lane, __syncwarp and 8 broadcast 16-byte shared-memory
//    loads took 9% longer on the H100, PERF.md) and, in bf16, where 4 such
//    loads carry all 32 values, through shared memory (3-16% faster than
//    shuffles), converted to f32 (an exact shift); g = h @ wh is fmaf from
//    0.0f over k = 0 ... 31, project()'s order. A step is shorter than a
//    load from device memory, so xp is fetched kAhead steps ahead into a
//    ring in shared memory by cp.async, and the step waits on its own group
//    only (a ring of register loads, each waited on by the step that uses
//    it, took K1 and K1-bf16 about 40% and 60% longer, PERF.md); the mask
//    and, in the scale forms (kScale), the gate scale a_t [T, B], each in
//    the stream type, converted where it is used, ride rings of registers
//    (a bf16 value is below cp.async's 4-byte minimum). The gates and the
//    update are gru_chain.cuh's gates_f32_xp and update_f32 in f32,
//    gates_bf16_xp and the bf16 ops in bf16: the same expressions as K2's
//    and K4's (and their bf16 forms'), so a backward recomputes these
//    gates bit for bit. The scale adds one multiply to the step's chain:
//    zs = z * a_t in f32, zs = mul_b(z, a_t) in bf16.
//
// The chunks run one after another on the caller's stream; chunk i starts
// from the last row of chunk i-1's h_seq, which is the carry itself (f32 in
// K1 and K1-scale, bf16 in their bf16 forms), so the result does not depend
// on the chunk length. The workspace's size is the caller's choice
// (ops/cuda_gru.py caps it).
//
// K3 and K3-bf16 are the same two kernels per chunk: the projection, then
// the recurrence with the StrideOut policy (one loop, the output a
// compile-time choice), which writes the strided rows, the boundary states
// and h_T in place of h_seq, counted from the absolute step, and updates h
// with stride_update (in bf16 that is K1-bf16's no-mask h_cell, so
// K3-bf16's rows are K1-bf16's bit for bit). Chunk i starts from h_T,
// where chunk i-1 left its carry in the stream type, so the outputs do not
// depend on the chunk length either. The projection's and the gates' bits
// are project()'s and gates_*'s, which K4's replay has shown on the card,
// so K3's outputs are its one-kernel form's (gru_scan_stride_fwd.cu) bit
// for bit. K3 has no scale form.
//
// The TPU kernel's packed [wx_r|wx_z|wx_c|0] / [wh_r|wh_z|0|wh_c] weights
// (a 128-lane trick), its padding of T to a multiple of 8 and its boundary
// states (inputs of the backward kernel only) are not carried over.
//
// Time strides: x, the mask and the scale are read at x + t*x_tstride,
// mask + t*m_tstride and scale + t*s_tstride, so the next HPMN layer's
// input h_seq[period-1::period] is passed as a strided view with no copy.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kG;
using hpmn::kMaxChunks;  // d_in <= 96: x_t in up to three 32-chunks
// The recurrence: batch rows per block, and steps of xp loaded ahead
// (PERF.md has the times of 2 and 8 of each).
constexpr int kRecWarps = 4;
constexpr int kAhead = 4;

// One step's xp row (r, z, c blocks at lane j) into `slot` [96] of this
// warp's ring in shared memory, by cp.async in a group of its own: each
// lane copies, and later reads, only its own three words, so no barrier
// orders them. With kMasked, the step's mask value into m, and with kScale
// its gate scale into a (each in the stream type, unconverted). The caller
// clamps t to the chunk's last step.
template <typename S, bool kMasked, bool kScale>
__device__ __forceinline__ void fetch_xp(float* slot, S& m, S& a,
                                         const float* xp, const S* mask,
                                         long long m_tstride, const S* scale,
                                         long long s_tstride, int t, int B,
                                         int row, int lane) {
  const float* p = xp + ((long long)t * B + row) * kG + lane;
#pragma unroll
  for (int g = 0; g < 3; ++g)
    hpmn::copy_async(slot + g * kDm + lane, p + g * kDm);
  hpmn::copy_async_commit();
  if constexpr (kMasked) m = mask[(long long)t * m_tstride + row];
  if constexpr (kScale) a = scale[(long long)t * s_tstride + row];
}

// Where the recurrence writes its states, a compile-time policy of one
// loop. DenseOut (K1, K1-bf16, K1-scale, K1-scale-bf16): every state, hseq [T, B, 32] contiguous
// (the chunk's rows).
template <typename S>
struct DenseOut {
  static constexpr bool kStrided = false;
  S* hseq;
};

// StrideOut (K3, K3-bf16; gru_scan_stride_fwd.cu has the outputs' meaning):
// hs [T/period, B, 32], hbound [ceil(T/kStrideChunk), B, 32] and hT [B,
// 32], contiguous, for the whole layer, indexed by the absolute step
// t_first + t of the chunk's step t: hs[(t_first+t+1)/period - 1] after a
// step where (t_first+t+1) % period == 0, hbound[(t_first+t)/kStrideChunk]
// before a step where (t_first+t) % kStrideChunk == 0, and hT after the
// chunk's last step (the next chunk's h0).
template <typename S>
struct StrideOut {
  static constexpr bool kStrided = true;
  S* hs;
  S* hbound;
  S* hT;
  int t_first;
  int period;
};

// K1's and K1-bf16's recurrence over one chunk, with kScale K1-scale's
// and K1-scale-bf16's, and K3's and K3-bf16's (Out = StrideOut: no mask,
// no scale): xp [T, B, 96] contiguous (from gru_input_proj.cu, in the
// chain's layout), mask [T, B] (time stride m_tstride; read only with
// kMasked), scale [T, B] (time stride s_tstride, unit batch stride; read
// only with kScale), wh [32, 96], bias [96] (read in bf16 only: the r and z
// blocks' biases, which the bf16 layout leaves out), h0 [B, 32] or null
// (K3's later chunks pass out.hT: each lane reads its own word before it
// writes it), and the outputs `out`; S is the stream type. K3's f32 update
// is stride_update's h + z*(c - h), K1's update_f32's h + 1*(h_cell - h)
// (they differ by ulps); in bf16 both are h_cell, op by op.
template <typename S, bool kMasked, typename Out, bool kScale>
__global__ void __launch_bounds__(kRecWarps * 32)
gru_scan_fwd_xp_kernel(const float* __restrict__ xp,
                       const S* __restrict__ mask, long long m_tstride,
                       const S* __restrict__ scale, long long s_tstride,
                       const S* __restrict__ wh, const S* __restrict__ bias,
                       const S* h0, Out out, int T, int B) {
  static_assert(!(kScale && Out::kStrided), "K3 has no scale form");
  using hpmn::load_f;
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  __shared__ float s_xp[kRecWarps][kAhead][kG];  // the xp ring
  __shared__ __align__(16) hpmn::B s_h[kRecWarps][2][kDm];  // bf16 only
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRecWarps + warp;
  if (row >= B) return;  // whole warps leave; no block barrier follows

  float w_r[kDm], w_z[kDm], w_c[kDm];
#pragma unroll
  for (int k = 0; k < kDm; ++k) {
    w_r[k] = load_f(wh + k * kG + lane);
    w_z[k] = load_f(wh + k * kG + kDm + lane);
    w_c[k] = load_f(wh + k * kG + 2 * kDm + lane);
  }
  float b_r = 0.0f, b_z = 0.0f;
  if constexpr (kBf16) {
    b_r = load_f(bias + lane);
    b_z = load_f(bias + kDm + lane);
  }
  // The carry: h in f32, hb in bf16 (from a bf16 h0, exact).
  float h = h0 != nullptr ? load_f(h0 + (long long)row * kDm + lane) : 0.0f;
  hpmn::B hb = hpmn::to_b(h);

  // K3's outputs: this row's word, and the strided rows' countdown.
  const long long out_off = (long long)row * kDm + lane;
  const long long row_stride = (long long)B * kDm;
  S* hs_out = nullptr;
  int to_fire = 0;
  if constexpr (Out::kStrided) {
    hs_out = out.hs + (long long)(out.t_first / out.period) * row_stride +
             out_off;
    to_fire = out.period - out.t_first % out.period;
  }
  // The carry in the stream type (bf16: hb, exact; f32: h).
  auto state = [&]() -> S {
    if constexpr (kBf16)
      return hb;
    else
      return h;
  };

  // The ring: step t's xp in slot t % kAhead, fetched kAhead steps ahead.
  float* ring = &s_xp[warp][0][0];
  S ring_m[kAhead] = {};  // the mask's ring (unread without kMasked)
  S ring_a[kAhead] = {};  // the scale's ring (unread without kScale)
#pragma unroll
  for (int s = 0; s < kAhead; ++s)
    fetch_xp<S, kMasked, kScale>(ring + s * kG, ring_m[s], ring_a[s], xp,
                                 mask, m_tstride, scale, s_tstride,
                                 s < T ? s : T - 1, B, row, lane);
  for (int t0 = 0; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int t = t0 + s;
      if (t >= T) break;
      if constexpr (Out::kStrided) {
        const int ta = out.t_first + t;
        if (ta % hpmn::kStrideChunk == 0)
          out.hbound[(long long)(ta / hpmn::kStrideChunk) * row_stride +
                     out_off] = state();
      }
      hpmn::copy_async_wait<kAhead - 1>();  // step t's group has landed
      const float xp_r = ring[s * kG + lane];
      const float xp_z = ring[s * kG + kDm + lane];
      const float xp_c = ring[s * kG + 2 * kDm + lane];
      const S m = ring_m[s];
      const S a = ring_a[s];

      float g_r = 0.0f, g_z = 0.0f, g_c = 0.0f;
      if constexpr (kBf16) {
        // h_{t-1}: each lane stores its bf16 carry, and four broadcast
        // 16-byte loads read all 32 (16 __shfl_sync of bf16 pairs took 3%
        // longer, 32 of f32 16% longer, PERF.md). Two buffers, so that
        // one __syncwarp a step orders this step's stores after the last
        // step's loads. A bf16 is the high half of its f32.
        hpmn::B* sh = s_h[warp][t & 1];
        sh[lane] = hb;
        __syncwarp();
        const uint4* q = reinterpret_cast<const uint4*>(sh);
#pragma unroll
        for (int v = 0; v < kDm / 8; ++v) {
          const uint4 u = q[v];
          const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * v + i;  // h_2j and h_2j+1
            const float h_lo = __uint_as_float(wd[i] << 16);
            const float h_hi = __uint_as_float(wd[i] & 0xffff0000u);
            g_r = fmaf(h_lo, w_r[2 * j], g_r);
            g_z = fmaf(h_lo, w_z[2 * j], g_z);
            g_c = fmaf(h_lo, w_c[2 * j], g_c);
            g_r = fmaf(h_hi, w_r[2 * j + 1], g_r);
            g_z = fmaf(h_hi, w_z[2 * j + 1], g_z);
            g_c = fmaf(h_hi, w_c[2 * j + 1], g_c);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kDm; ++k) {
          const float hk = __shfl_sync(hpmn::kFull, h, k);
          g_r = fmaf(hk, w_r[k], g_r);
          g_z = fmaf(hk, w_z[k], g_z);
          g_c = fmaf(hk, w_c[k], g_c);
        }
      }
      if constexpr (kBf16) {
        using hpmn::add_b;
        using hpmn::mul_b;
        using hpmn::sub_b;
        const hpmn::GatesB g = hpmn::gates_bf16_xp(xp_r, xp_z, xp_c, g_r,
                                                   g_z, g_c, b_r, b_z);
        const hpmn::B zs = kScale ? mul_b(g.z, a) : g.z;
        const hpmn::B h_cell = add_b(hb, mul_b(zs, sub_b(g.c, hb)));
        hb = kMasked ? add_b(hb, mul_b(m, sub_b(h_cell, hb))) : h_cell;
      } else {
        const hpmn::Gates g = hpmn::gates_f32_xp(xp_r, xp_z, xp_c, g_r, g_z,
                                                 g_c);
        if constexpr (Out::kStrided)
          h = hpmn::stride_update(g, h);
        else if constexpr (kScale)
          h = hpmn::update_f32(g.z * a, g.c, h, kMasked ? m : 1.0f);
        else
          h = hpmn::update_f32(g.z, g.c, h, kMasked ? m : 1.0f);
      }
      if constexpr (Out::kStrided) {
        if (--to_fire == 0) {
          *hs_out = state();
          hs_out += row_stride;
          to_fire = out.period;
        }
      } else {
        out.hseq[((long long)t * B + row) * kDm + lane] = state();
      }
      // The slot's words were read above (their values are used), so it
      // takes step t + kAhead.
      fetch_xp<S, kMasked, kScale>(ring + s * kG, ring_m[s], ring_a[s], xp,
                                   mask, m_tstride, scale, s_tstride,
                                   t + kAhead < T ? t + kAhead : T - 1, B,
                                   row, lane);
    }
  }
  if constexpr (Out::kStrided) out.hT[out_off] = state();
}

// K1 and K1-bf16, with kScale K1-scale and K1-scale-bf16: the chunks of
// t_chunk steps (the last one shorter), each a projection into ws then the
// recurrence, on `stream`.
template <typename S, bool kScale>
int scan_fwd_ws(const S* x, long long x_tstride, const S* mask,
                long long m_tstride, const S* scale, long long s_tstride,
                const S* wx, const S* wh, const S* b, const S* h0, S* hseq,
                float* ws, int t_chunk, int T, int B, int d_in,
                void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1 || t_chunk < 1
      || ws == nullptr || (kScale && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = (B + kRecWarps - 1) / kRecWarps;
  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int n = t_chunk < T - t0 ? t_chunk : T - t0;
    int code = hpmn::launch_input_proj(x + t0 * x_tstride, x_tstride, wx, b,
                                       ws, n, B, d_in, st);
    if (code != 0) return code;
    const S* h_in = t0 == 0 ? h0 : hseq + ((long long)(t0 - 1) * B) * kDm;
    S* h_out = hseq + (long long)t0 * B * kDm;
    const DenseOut<S> out{h_out};
    const S* a_in = kScale ? scale + t0 * s_tstride : nullptr;
    if (mask != nullptr)
      gru_scan_fwd_xp_kernel<S, true, DenseOut<S>, kScale>
          <<<grid, kRecWarps * 32, 0, st>>>(ws, mask + t0 * m_tstride,
                                            m_tstride, a_in, s_tstride, wh,
                                            b, h_in, out, n, B);
    else
      gru_scan_fwd_xp_kernel<S, false, DenseOut<S>, kScale>
          <<<grid, kRecWarps * 32, 0, st>>>(ws, nullptr, 0, a_in, s_tstride,
                                            wh, b, h_in, out, n, B);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  return 0;
}

// K3 and K3-bf16: the chunks of t_chunk steps (the last one shorter), each
// a projection into ws then the recurrence with the strided outputs, on
// `stream`. Chunk i starts from h_T, where chunk i-1 left its last state.
template <typename S>
int scan_stride_fwd_ws(const S* x, long long x_tstride, const S* wx,
                       const S* wh, const S* b, const S* h0, S* hs,
                       S* hbound, S* hT, float* ws, int t_chunk, int T, int B,
                       int d_in, int period, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1 || t_chunk < 1
      || period < 2 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = (B + kRecWarps - 1) / kRecWarps;
  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int n = t_chunk < T - t0 ? t_chunk : T - t0;
    int code = hpmn::launch_input_proj(x + t0 * x_tstride, x_tstride, wx, b,
                                       ws, n, B, d_in, st);
    if (code != 0) return code;
    const StrideOut<S> out{hs, hbound, hT, t0, period};
    gru_scan_fwd_xp_kernel<S, false, StrideOut<S>, false>
        <<<grid, kRecWarps * 32, 0, st>>>(ws, nullptr, 0, nullptr, 0, wh, b,
                                          t0 == 0 ? h0 : hT, out, n, B);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// K1: x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B]
// (time stride m_tstride) or null, wx [d_in,96], wh [32,96], b [96], h0
// [B,32] or null, hseq [T,B,32] contiguous, all float32, and the f32
// workspace ws [t_chunk, B, 96] contiguous. Runs the chunks of t_chunk
// steps (the last one shorter), each a projection into ws then the
// recurrence, on `stream`; returns the first nonzero cudaGetLastError()
// after a launch, or 0.
extern "C" int hpmn_gru_scan_fwd_ws(const float* x, long long x_tstride,
                                    const float* mask, long long m_tstride,
                                    const float* wx, const float* wh,
                                    const float* b, const float* h0,
                                    float* hseq, float* ws, int t_chunk,
                                    int T, int B, int d_in, void* stream) {
  return scan_fwd_ws<float, false>(x, x_tstride, mask, m_tstride, nullptr,
                                   0, wx, wh, b, h0, hseq, ws, t_chunk, T, B,
                                   d_in, stream);
}

// K1-bf16: as K1, every tensor bf16 but the workspace, which stays f32.
extern "C" int hpmn_gru_scan_fwd_bf16_ws(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* wx, const __nv_bfloat16* wh,
    const __nv_bfloat16* b, const __nv_bfloat16* h0, __nv_bfloat16* hseq,
    float* ws, int t_chunk, int T, int B, int d_in, void* stream) {
  return scan_fwd_ws<__nv_bfloat16, false>(x, x_tstride, mask, m_tstride,
                                           nullptr, 0, wx, wh, b, h0, hseq,
                                           ws, t_chunk, T, B, d_in, stream);
}

// K3: x [T,B,d_in] (time stride x_tstride, rows contiguous), wx [d_in,96],
// wh [32,96], b [96], h0 [B,32] or null, all float32, and the f32
// workspace ws [t_chunk, B, 96] contiguous. Writes hs [T/period,B,32],
// hbound [ceil(T/hpmn_gru_scan_stride_chunk()),B,32] and hT [B,32],
// contiguous float32 (gru_scan_stride_fwd.cu has their meaning), period >=
// 2. Runs the chunks of t_chunk steps (the last one shorter), each a
// projection into ws then the recurrence, on `stream`; returns the first
// nonzero cudaGetLastError() after a launch, or 0.
extern "C" int hpmn_gru_scan_stride_fwd_ws(
    const float* x, long long x_tstride, const float* wx, const float* wh,
    const float* b, const float* h0, float* hs, float* hbound, float* hT,
    float* ws, int t_chunk, int T, int B, int d_in, int period,
    void* stream) {
  return scan_stride_fwd_ws(x, x_tstride, wx, wh, b, h0, hs, hbound, hT, ws,
                            t_chunk, T, B, d_in, period, stream);
}

// K3-bf16: as K3, every tensor bf16 but the workspace, which stays f32.
extern "C" int hpmn_gru_scan_stride_fwd_bf16_ws(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* wh, const __nv_bfloat16* b, const __nv_bfloat16* h0,
    __nv_bfloat16* hs, __nv_bfloat16* hbound, __nv_bfloat16* hT, float* ws,
    int t_chunk, int T, int B, int d_in, int period, void* stream) {
  return scan_stride_fwd_ws(x, x_tstride, wx, wh, b, h0, hs, hbound, hT, ws,
                            t_chunk, T, B, d_in, period, stream);
}

// K1-scale and K1-scale-bf16: K1's arguments (K1-bf16's), plus scale [T,B]
// (time stride s_tstride, unit batch stride; not null), the AUGRU's a_t,
// of the stream type. Runs K1's chunks, the recurrence with the scale.
extern "C" int hpmn_gru_scan_fwd_scale_ws(
    const float* x, long long x_tstride, const float* mask,
    long long m_tstride, const float* scale, long long s_tstride,
    const float* wx, const float* wh, const float* b, const float* h0,
    float* hseq, float* ws, int t_chunk, int T, int B, int d_in,
    void* stream) {
  return scan_fwd_ws<float, true>(x, x_tstride, mask, m_tstride, scale,
                                  s_tstride, wx, wh, b, h0, hseq, ws, t_chunk,
                                  T, B, d_in, stream);
}

extern "C" int hpmn_gru_scan_fwd_scale_bf16_ws(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* scale, long long s_tstride,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* h0, __nv_bfloat16* hseq, float* ws, int t_chunk,
    int T, int B, int d_in, void* stream) {
  return scan_fwd_ws<__nv_bfloat16, true>(x, x_tstride, mask, m_tstride,
                                          scale, s_tstride, wx, wh, b, h0,
                                          hseq, ws, t_chunk, T, B, d_in,
                                          stream);
}

// K1-general, the width-general GRU scan forward (hpmn_gru_gen_fwd and
// its bf16 form, with and without the mask and the AUGRU scale): per chunk
// the projection (gru_general_gemm.cu) then the recurrence here.
// gru_general.cuh has the design.
//
// The same recurrence, with another output policy, runs K3-general, the
// width-general strided forward (hpmn_gru_gen_stride_fwd and its bf16
// form), and K4-general's replay (launch_replay, called from
// gru_general_bwd.cu).

#include "gru_general.cuh"

namespace {

using namespace hpmn_gen;

constexpr int kAhead = 4;  // the ring of xp, mask and scale

template <typename S, bool kScale>
struct FwdLoad {
  float xr, xz, xc;
  S m, a;
};

template <typename S, bool kScale>
__device__ __forceinline__ void fetch_fwd(FwdLoad<S, kScale>& s,
                                          const float* xp, const S* mask,
                                          long long m_tstride, const S* scale,
                                          long long s_tstride, int t, int B,
                                          int d_m, int row, int j) {
  const float* p = xp + ((long long)t * B + row) * 3 * d_m + j;
  s.xr = p[0];
  s.xz = p[d_m];
  s.xc = p[2 * d_m];
  if (mask != nullptr) s.m = mask[(long long)t * m_tstride + row];
  if constexpr (kScale) s.a = scale[(long long)t * s_tstride + row];
}

// Where the recurrence writes, a compile-time policy of one loop.
// GenDense (K1-general): every state, hseq [T, B, d_m] (the chunk's rows).
template <typename S>
struct GenDense {
  static constexpr bool kStrided = false, kReplay = false;
  S* hseq;
};

// GenStride (K3-general), csrc/gru_scan_fwd.cu's StrideOut at any d_m: hs
// [T/period, B, d_m], hbound [ceil(T/kStrideChunk), B, d_m] and hT [B,
// d_m] for the whole layer, indexed by the absolute step t_first + t of
// the chunk's step t: hs[(t_first+t+1)/period - 1] after a step where
// (t_first+t+1) % period == 0, hbound[(t_first+t)/kStrideChunk] before a
// step where (t_first+t) % kStrideChunk == 0, hT after the chunk's last
// step (the next chunk's h0).
template <typename S>
struct GenStride {
  static constexpr bool kStrided = true, kReplay = false;
  S* hs;
  S* hbound;
  S* hT;
  int t_first;
  int period;
};

// GenReplay (K4-general's replay of a workspace chunk from its boundary):
// each step's h_prev into hprev [n, B, d_m] and its h @ wh into gh [n, B,
// 3*d_m] f32 (HprevOp's layout), which K4-general's sweep reads in place
// of K2-general's h_seq and recompute.
template <typename S>
struct GenReplay {
  static constexpr bool kStrided = false, kReplay = true;
  S* hprev;
  float* gh;
};

// K1-general's recurrence over one chunk of T steps: xp [T, B, 3*d_m] f32
// (ProjOp's layout), mask [T, B] or null, scale [T, B] (kScale), wh [d_m,
// 3*d_m], bias (bf16: the r and z blocks' biases), h0 [B, d_m] or null
// (K3-general's later chunks pass out.hT: each thread reads its own word
// before it writes it), and the outputs `out`. GenStride and GenReplay take
// no mask and no scale and update h with gru_chain.cuh's stride_update, the
// TPU stride kernel's h + z*(c - h) (in bf16 that is the no-mask h_cell,
// op by op); GenDense's f32 update is update_f32's h + m*(h_cell - h).
template <typename S, bool kScale, bool kSmemW, typename Out>
__global__ void __launch_bounds__(kRecThreads)
gen_fwd_rec_kernel(const float* __restrict__ xp, const S* __restrict__ mask,
                   long long m_tstride, const S* __restrict__ scale,
                   long long s_tstride, const S* __restrict__ wh,
                   const S* __restrict__ bias, const S* h0, Out out, int T,
                   int B, int d_m, int rows) {
  constexpr bool kStrideStep = Out::kStrided || Out::kReplay;
  constexpr bool kDense = !kStrideStep;
  static_assert(!(kScale && kStrideStep), "K3-general has no scale form");
  using hpmn::add_b;
  using hpmn::mul_b;
  using hpmn::sub_b;
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  extern __shared__ __align__(16) float smem[];
  const int U = blockDim.x / rows;
  const int r = threadIdx.x / U, j = threadIdx.x - r * U;
  const int row = blockIdx.x * rows + r;
  const bool active = row < B && j < d_m;
  const bool masked = mask != nullptr;
  const int G = 3 * d_m;
  float* s_h = smem;                    // [2][rows][d_m]
  float* s_wh = smem + 2 * rows * d_m;  // [d_m][3*d_m] (kSmemW)
  if constexpr (kSmemW)
    for (int i = threadIdx.x; i < d_m * G; i += blockDim.x)
      s_wh[i] = load_f(wh + i);
  float h = 0.0f, b_r = 0.0f, b_z = 0.0f;
  if (active) {
    if (h0 != nullptr) h = load_f(h0 + (long long)row * d_m + j);
    s_h[r * d_m + j] = h;
    if constexpr (kBf16) {
      b_r = load_f(bias + j);
      b_z = load_f(bias + d_m + j);
    }
  }
  hpmn::B hb = hpmn::to_b(h);  // the bf16 carry (from a bf16 h0: exact)
  // The carry in the stream type (bf16: hb, exact; f32: h), and where
  // step t's row of a [., B, d_m] output keeps this thread's word.
  auto state = [&]() -> S {
    if constexpr (kBf16)
      return hb;
    else
      return h;
  };
  auto at = [&](long long t) { return (t * B + row) * d_m + j; };
  auto w_at = [&](int k, int g) -> float {
    if constexpr (kSmemW)
      return s_wh[k * G + g * d_m + j];
    else
      return load_f(wh + (long long)k * G + g * d_m + j);
  };

  FwdLoad<S, kScale> ring[kAhead];
  if (active) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s)
      fetch_fwd(ring[s], xp, mask, m_tstride, scale, s_tstride,
                s < T ? s : T - 1, B, d_m, row, j);
  }
  __syncthreads();
  for (int t0 = 0; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int t = t0 + s;
      if (t >= T) break;  // the same for every thread of the block
      const float* h_in = s_h + (t & 1) * rows * d_m + r * d_m;
      float* h_out = s_h + ((t + 1) & 1) * rows * d_m + r * d_m;
      if (active) {
        const FwdLoad<S, kScale> cur = ring[s];
        fetch_fwd(ring[s], xp, mask, m_tstride, scale, s_tstride,
                  t + kAhead < T ? t + kAhead : T - 1, B, d_m, row, j);
        if constexpr (Out::kStrided) {
          const int ta = out.t_first + t;
          if (ta % hpmn::kStrideChunk == 0)
            out.hbound[at(ta / hpmn::kStrideChunk)] = state();
        }
        if constexpr (Out::kReplay) out.hprev[at(t)] = state();
        float g_r = 0.0f, g_z = 0.0f, g_c = 0.0f;
        for (int k = 0; k < d_m; ++k) {
          const float hk = h_in[k];
          g_r = fmaf(hk, w_at(k, 0), g_r);
          g_z = fmaf(hk, w_at(k, 1), g_z);
          g_c = fmaf(hk, w_at(k, 2), g_c);
        }
        if constexpr (Out::kReplay) {
          float* q = out.gh + ((long long)t * B + row) * 3 * d_m + j;
          q[0] = g_r;
          q[d_m] = g_z;
          q[2 * d_m] = g_c;
        }
        float h_new;
        if constexpr (kBf16) {
          const hpmn::GatesB g = hpmn::gates_bf16_xp(cur.xr, cur.xz, cur.xc,
                                                     g_r, g_z, g_c, b_r, b_z);
          if constexpr (kStrideStep) {
            hb = hpmn::stride_update(g, hb);
          } else {
            const hpmn::B zs = kScale ? mul_b(g.z, cur.a) : g.z;
            const hpmn::B h_cell = add_b(hb, mul_b(zs, sub_b(g.c, hb)));
            hb = masked ? add_b(hb, mul_b(cur.m, sub_b(h_cell, hb)))
                        : h_cell;
          }
          h_new = hpmn::to_f(hb);
          if constexpr (kDense) out.hseq[at(t)] = hb;
        } else {
          const hpmn::Gates g = hpmn::gates_f32_xp(cur.xr, cur.xz, cur.xc,
                                                   g_r, g_z, g_c);
          const float m = masked ? cur.m : 1.0f;
          if constexpr (kStrideStep)
            h = hpmn::stride_update(g, h);
          else if constexpr (kScale)
            h = hpmn::update_f32(g.z * cur.a, g.c, h, m);
          else
            h = hpmn::update_f32(g.z, g.c, h, m);
          h_new = h;
          if constexpr (kDense) out.hseq[at(t)] = h;
        }
        if constexpr (Out::kStrided) {
          const int ta = out.t_first + t + 1;
          if (ta % out.period == 0) out.hs[at(ta / out.period - 1)] = state();
        }
        h_out[j] = h_new;
      }
      __syncthreads();
    }
  }
  if constexpr (Out::kStrided)
    if (active) out.hT[at(0)] = state();
}

template <typename S, bool kScale, bool kSmemW, typename Out>
int fwd_rec(const RecShape& rs, const float* xp, const S* mask,
            long long m_tstride, const S* scale, long long s_tstride,
            const S* wh, const S* b, const S* h0, Out out, int T, int B,
            int d_m, cudaStream_t st) {
  auto kernel = gen_fwd_rec_kernel<S, kScale, kSmemW, Out>;
  const int code = prepare(kernel, rs);
  if (code != 0) return code;
  const int grid = (B + rs.rows - 1) / rs.rows;
  kernel<<<grid, rs.threads, rs.smem, st>>>(xp, mask, m_tstride, scale,
                                            s_tstride, wh, b, h0, out, T, B,
                                            d_m, rs.rows);
  return (int)cudaGetLastError();
}

// The no-mask, no-scale recurrence of K3-general and K4-general's replay,
// wh in shared memory where it fits.
template <typename S, typename Out>
int stride_rec(const RecShape& rs, const float* xp, const S* wh, const S* b,
               const S* h0, Out out, int T, int B, int d_m, cudaStream_t st) {
  return rs.smem_w ? fwd_rec<S, false, true>(rs, xp, nullptr, 0, nullptr, 0,
                                             wh, b, h0, out, T, B, d_m, st)
                   : fwd_rec<S, false, false>(rs, xp, nullptr, 0, nullptr, 0,
                                              wh, b, h0, out, T, B, d_m, st);
}

// K1-general: the chunks of t_chunk steps (the last one shorter), each a
// projection into ws [t_chunk, B, 3*d_m] then the recurrence.
template <typename S>
int gen_fwd(const S* x, long long x_tstride, const S* mask,
            long long m_tstride, const S* scale, long long s_tstride,
            const S* wx, const S* wh, const S* b, const S* h0, S* hseq,
            float* ws, int t_chunk, int T, int B, int d_in, int d_m,
            void* stream) {
  if (!dims_ok(d_in, d_m) || B < 1 || T < 1 || t_chunk < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const RecShape rs = rec_shape(B, d_m, false);
  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int n = t_chunk < T - t0 ? t_chunk : T - t0;
    int code = launch_proj(x + t0 * x_tstride, x_tstride, wx, b, ws,
                           (long long)n * B, B, d_in, d_m, st);
    if (code != 0) return code;
    const S* h_in = t0 == 0 ? h0 : hseq + (long long)(t0 - 1) * B * d_m;
    const GenDense<S> h_out{hseq + (long long)t0 * B * d_m};
    const S* m_in = mask != nullptr ? mask + t0 * m_tstride : nullptr;
    if (scale != nullptr) {
      const S* a_in = scale + t0 * s_tstride;
      code = rs.smem_w
                 ? fwd_rec<S, true, true>(rs, ws, m_in, m_tstride, a_in,
                                          s_tstride, wh, b, h_in, h_out, n,
                                          B, d_m, st)
                 : fwd_rec<S, true, false>(rs, ws, m_in, m_tstride, a_in,
                                           s_tstride, wh, b, h_in, h_out, n,
                                           B, d_m, st);
    } else {
      code = rs.smem_w
                 ? fwd_rec<S, false, true>(rs, ws, m_in, m_tstride, nullptr,
                                           0, wh, b, h_in, h_out, n, B, d_m,
                                           st)
                 : fwd_rec<S, false, false>(rs, ws, m_in, m_tstride, nullptr,
                                            0, wh, b, h_in, h_out, n, B, d_m,
                                            st);
    }
    if (code != 0) return code;
  }
  return 0;
}

// K3-general: the chunks of t_chunk steps (the last one shorter), each a
// projection into ws [t_chunk, B, 3*d_m] then the recurrence with the
// strided outputs. Chunk i starts from h_T, where chunk i-1 left its last
// state in the stream type, so the outputs do not depend on the chunk.
template <typename S>
int gen_stride_fwd(const S* x, long long x_tstride, const S* wx,
                   const S* wh, const S* b, const S* h0, S* hs, S* hbound,
                   S* hT, float* ws, int t_chunk, int T, int B, int d_in,
                   int d_m, int period, void* stream) {
  if (!dims_ok(d_in, d_m) || B < 1 || T < 1 || t_chunk < 1 || period < 2
      || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const RecShape rs = rec_shape(B, d_m, false);
  for (int t0 = 0; t0 < T; t0 += t_chunk) {
    const int n = t_chunk < T - t0 ? t_chunk : T - t0;
    int code = launch_proj(x + t0 * x_tstride, x_tstride, wx, b, ws,
                           (long long)n * B, B, d_in, d_m, st);
    if (code != 0) return code;
    code = stride_rec(rs, ws, wh, b, t0 == 0 ? h0 : hT,
                      GenStride<S>{hs, hbound, hT, t0, period}, n, B, d_m,
                      st);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

namespace hpmn_gen {

template <typename S>
int launch_replay(const float* xp, const S* wh, const S* b, const S* h_start,
                  S* hprev, float* gh, int n, int B, int d_m,
                  cudaStream_t st) {
  return stride_rec(rec_shape(B, d_m, false), xp, wh, b, h_start,
                    GenReplay<S>{hprev, gh}, n, B, d_m, st);
}

template int launch_replay<float>(const float*, const float*, const float*,
                                  const float*, float*, float*, int, int, int,
                                  cudaStream_t);
template int launch_replay<__nv_bfloat16>(const float*, const __nv_bfloat16*,
                                          const __nv_bfloat16*,
                                          const __nv_bfloat16*,
                                          __nv_bfloat16*, float*, int, int,
                                          int, cudaStream_t);

}  // namespace hpmn_gen


// K1-general: x [T,B,d_in] (time stride x_tstride, rows contiguous), mask
// [T,B] (time stride m_tstride) or null, scale [T,B] (time stride
// s_tstride, unit batch stride) or null (null: K1-general without the
// AUGRU scale), wx [d_in,3*d_m], wh [d_m,3*d_m], b [3*d_m], h0 [B,d_m] or
// null, hseq [T,B,d_m] contiguous, all float32, and the f32 workspace ws
// [t_chunk,B,3*d_m]. 1 <= d_m <= 256, 1 <= d_in <= 512. Runs on `stream`;
// returns the first nonzero cudaGetLastError() after a launch, or 0.
extern "C" int hpmn_gru_gen_fwd(const float* x, long long x_tstride,
                                const float* mask, long long m_tstride,
                                const float* scale, long long s_tstride,
                                const float* wx, const float* wh,
                                const float* b, const float* h0, float* hseq,
                                float* ws, int t_chunk, int T, int B,
                                int d_in, int d_m, void* stream) {
  return gen_fwd<float>(x, x_tstride, mask, m_tstride, scale, s_tstride, wx,
                        wh, b, h0, hseq, ws, t_chunk, T, B, d_in, d_m,
                        stream);
}

// K1-general-bf16: as K1-general, every tensor bf16 but the workspace.
extern "C" int hpmn_gru_gen_fwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* scale, long long s_tstride,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* h0, __nv_bfloat16* hseq, float* ws, int t_chunk,
    int T, int B, int d_in, int d_m, void* stream) {
  return gen_fwd<__nv_bfloat16>(x, x_tstride, mask, m_tstride, scale,
                                s_tstride, wx, wh, b, h0, hseq, ws, t_chunk,
                                T, B, d_in, d_m, stream);
}


// K3-general: x [T,B,d_in] (time stride x_tstride, rows contiguous), wx
// [d_in,3*d_m], wh [d_m,3*d_m], b [3*d_m], h0 [B,d_m] or null, all float32,
// and the f32 workspace ws [t_chunk,B,3*d_m]. Writes hs [T/period,B,d_m],
// hbound [ceil(T/hpmn_gru_scan_stride_chunk()),B,d_m] and hT [B,d_m],
// contiguous float32 (GenStride has their meaning), period >= 2, 1 <= d_m
// <= 256, 1 <= d_in <= 512. Runs on `stream`; returns the first nonzero
// cudaGetLastError() after a launch, or 0.
extern "C" int hpmn_gru_gen_stride_fwd(const float* x, long long x_tstride,
                                       const float* wx, const float* wh,
                                       const float* b, const float* h0,
                                       float* hs, float* hbound, float* hT,
                                       float* ws, int t_chunk, int T, int B,
                                       int d_in, int d_m, int period,
                                       void* stream) {
  return gen_stride_fwd<float>(x, x_tstride, wx, wh, b, h0, hs, hbound, hT,
                               ws, t_chunk, T, B, d_in, d_m, period, stream);
}

// K3-general-bf16: as K3-general, every tensor bf16 but the workspace.
extern "C" int hpmn_gru_gen_stride_fwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* wh, const __nv_bfloat16* b, const __nv_bfloat16* h0,
    __nv_bfloat16* hs, __nv_bfloat16* hbound, __nv_bfloat16* hT, float* ws,
    int t_chunk, int T, int B, int d_in, int d_m, int period, void* stream) {
  return gen_stride_fwd<__nv_bfloat16>(x, x_tstride, wx, wh, b, h0, hs,
                                       hbound, hT, ws, t_chunk, T, B, d_in,
                                       d_m, period, stream);
}

// K2-general, the width-general GRU scan backward (hpmn_gru_gen_bwd and
// its bf16 form, with and without the mask and the AUGRU scale): per chunk
// the projection and h_prev @ wh (gru_general_gemm.cu), the recurrence
// here, then dx and the weight-gradient partials. gru_general.cuh has the
// design.
//
// K4-general, the width-general strided backward (hpmn_gru_gen_stride_bwd
// and its bf16 form), runs the same recurrence from what K3-general kept:
// per workspace chunk of steps (a multiple of kStrideChunk, from the last
// to the first) the projection, a replay of the chunk from its first
// boundary state with K3-general's own recurrence (gru_general_fwd.cu's
// launch_replay: each step's h_prev and h @ wh into workspaces, so the
// states are K3-general's bit for bit), the sweep reading h_prev from the
// replay's workspace and the strided cotangents in place of dh_seq, then
// dx and the weight-gradient partials over the workspaces. No dense
// [T, B, d_m] h_seq or dh_seq is written or read.

#include "gru_general.cuh"

namespace {

using namespace hpmn_gen;

struct BwdLoad {
  float xr, xz, xc, gr, gz, gc;  // the step's xp and h_prev @ wh
  float hp, dhs, m, a;
};

// Where the sweep reads h_prev and each step's output cotangent, a
// compile-time policy of one loop. DenseCot (K2-general): h_prev from h0
// and hseq [T, B, d_m] at the absolute step, the cotangent dhseq[t].
template <typename S>
struct DenseCot {
  static constexpr bool kStrided = false;
  const S* h0;
  const S* hseq;
  const S* dhseq;
};

// StrideCot (K4-general): h_prev from the replay's workspace hprev [n, B,
// d_m] (the chunk's steps), and the TPU stride kernel's cotangent gcell =
// (dh + dhs[(t+1)/period - 1]) + dhT, the first term where (t+1) % period
// == 0, the second at t = T - 1, in f32 (rounded once to bf16 in the bf16
// chain, as gru_scan_stride_bwd.cu's). dhs [T/period, B, d_m] and dhT [B,
// d_m] may be null (zero).
template <typename S>
struct StrideCot {
  static constexpr bool kStrided = true;
  const S* hprev;
  const S* dhs;
  const S* dhT;
  int period, T;
};

// K2-general's recurrence over the chunk [t0, t0 + n): xp and gh [n, B,
// 3*d_m] f32 (ProjOp's and HprevOp's, or the replay's), mask [T, B] or
// null, scale [T, B] (kScale), wh [d_m, 3*d_m], bias (bf16: r and z), the
// h_prev and cotangent policy `cot`; writes dg [n, B, d_m, 4] and, with
// kScale, dscale [T, B]. dh [B, d_m] f32 carries dh in (`carry_in`) and
// out.
template <typename S, bool kScale, bool kSmemW, typename Cot>
__global__ void __launch_bounds__(kRecThreads)
gen_bwd_rec_kernel(const float* __restrict__ xp, const float* __restrict__ gh,
                   const S* __restrict__ mask, long long m_tstride,
                   const S* __restrict__ scale, long long s_tstride,
                   const S* __restrict__ wh, const S* __restrict__ bias,
                   const Cot cot, S* __restrict__ dg, S* __restrict__ dscale,
                   float* __restrict__ dh, int t0, int n, bool carry_in,
                   int B, int d_m, int rows) {
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  extern __shared__ __align__(16) float smem[];
  const int U = blockDim.x / rows;
  const int wpr = U / 32;  // warps per row
  const int r = threadIdx.x / U, j = threadIdx.x - r * U;
  const int row = blockIdx.x * rows + r;
  const bool active = row < B && j < d_m;
  const bool masked = mask != nullptr;
  const int G = 3 * d_m;
  float4* s_g = reinterpret_cast<float4*>(smem);  // [2][rows][d_m]
  float* s_da = smem + 8 * rows * d_m;              // [2][rows][wpr]
  float* s_whT = s_da + 2 * rows * wpr;             // [3*d_m][d_m] (kSmemW)
  if constexpr (kSmemW)
    for (int i = threadIdx.x; i < G * d_m; i += blockDim.x) {
      const int gk = i / d_m, jj = i - gk * d_m;
      s_whT[i] = load_f(wh + (long long)jj * G + gk);
    }
  float b_r = 0.0f, b_z = 0.0f, dhc = 0.0f, dh_T = 0.0f;
  if (active) {
    if constexpr (kBf16) {
      b_r = load_f(bias + j);
      b_z = load_f(bias + d_m + j);
    }
    if (carry_in) dhc = dh[(long long)row * d_m + j];
    if constexpr (Cot::kStrided)
      if (cot.dhT != nullptr)
        dh_T = load_f(cot.dhT + (long long)row * d_m + j);
  }
  auto wt_at = [&](int g, int k) -> float {  // wh[j][g*d_m + k]
    if constexpr (kSmemW)
      return s_whT[(g * d_m + k) * d_m + j];
    else
      return load_f(wh + (long long)j * G + g * d_m + k);
  };
  auto load = [&](BwdLoad& s, int t) {
    const long long i = ((long long)(t - t0) * B + row) * G + j;
    s.xr = xp[i];
    s.xz = xp[i + d_m];
    s.xc = xp[i + 2 * d_m];
    s.gr = gh[i];
    s.gz = gh[i + d_m];
    s.gc = gh[i + 2 * d_m];
    if constexpr (Cot::kStrided) {
      s.hp = load_f(cot.hprev + ((long long)(t - t0) * B + row) * d_m + j);
      s.dhs = cot.dhs != nullptr && (t + 1) % cot.period == 0
                  ? load_f(cot.dhs + ((long long)((t + 1) / cot.period - 1) *
                                          B + row) * d_m + j)
                  : 0.0f;
    } else {
      s.hp = h_prev(cot.h0, cot.hseq, t, row, j, B, d_m);
      s.dhs = load_f(cot.dhseq + ((long long)t * B + row) * d_m + j);
    }
    s.m = masked ? load_f(mask + (long long)t * m_tstride + row) : 1.0f;
    s.a = kScale ? load_f(scale + (long long)t * s_tstride + row) : 1.0f;
  };
  BwdLoad cur{}, nxt{};
  if (active) load(cur, t0 + n - 1);
  __syncthreads();
  for (int t = t0 + n - 1; t >= t0; --t) {
    const int buf = t & 1;
    hpmn::StepGrad sg{};
    if (active) {
      if (t > t0) load(nxt, t - 1);
      float gin = cur.dhs + dhc;
      if constexpr (Cot::kStrided)
        if (t == cot.T - 1) gin = gin + dh_T;
      if constexpr (kBf16)
        sg = hpmn::step_grad_bf16<kScale>(
            hpmn::gates_bf16_xp(cur.xr, cur.xz, cur.xc, cur.gr, cur.gz,
                                cur.gc, b_r, b_z),
            hpmn::to_b(cur.hp), hpmn::to_b(gin), hpmn::to_b(cur.m), masked,
            hpmn::to_b(cur.a));
      else
        sg = hpmn::step_grad_f32<kScale>(
            hpmn::gates_f32_xp(cur.xr, cur.xz, cur.xc, cur.gr, cur.gz,
                               cur.gc),
            cur.hp, gin, cur.m, cur.a);
      hpmn::store4(dg + (((long long)(t - t0) * B + row) * d_m + j) * 4,
                   sg.dr, sg.dz, sg.dc, sg.dcr);
      s_g[(buf * rows + r) * d_m + j] =
          make_float4(sg.dr, sg.dz, sg.dc, sg.dcr);
    }
    if constexpr (kScale) {
      const float da = hpmn::warp_sum(sg.da);  // 0 from idle lanes
      if ((j & 31) == 0) s_da[(buf * rows + r) * wpr + (j >> 5)] = da;
    }
    __syncthreads();
    if (active) {
      const float4* gg = s_g + (buf * rows + r) * d_m;
      float dh_new = kBf16 ? 0.0f : sg.carry;
      for (int k = 0; k < d_m; ++k) {
        const float4 d = gg[k];
        dh_new = fmaf(d.x, wt_at(0, k), dh_new);
        dh_new = fmaf(d.y, wt_at(1, k), dh_new);
        dh_new = fmaf(d.w, wt_at(2, k), dh_new);
      }
      dhc = kBf16 ? sg.carry + dh_new : dh_new;
      if (kScale && j == 0) {
        float tot = 0.0f;
        for (int w = 0; w < wpr; ++w) tot += s_da[(buf * rows + r) * wpr + w];
        store_f(dscale + (long long)t * B + row, tot);
      }
      if (t > t0) cur = nxt;
    }
  }
  if (active) dh[(long long)row * d_m + j] = dhc;
}

template <typename S, bool kScale, bool kSmemW, typename Cot>
int bwd_rec(const RecShape& rs, const float* xp, const float* gh,
            const S* mask, long long m_tstride, const S* scale,
            long long s_tstride, const S* wh, const S* b, Cot cot, S* dg,
            S* dscale, float* dh, int t0, int n, bool carry_in, int B,
            int d_m, cudaStream_t st) {
  auto kernel = gen_bwd_rec_kernel<S, kScale, kSmemW, Cot>;
  const int code = prepare(kernel, rs);
  if (code != 0) return code;
  const int grid = (B + rs.rows - 1) / rs.rows;
  kernel<<<grid, rs.threads, rs.smem, st>>>(
      xp, gh, mask, m_tstride, scale, s_tstride, wh, b, cot, dg, dscale, dh,
      t0, n, carry_in, B, d_m, rs.rows);
  return (int)cudaGetLastError();
}

// K2-general: every chunk of t_chunk steps from the last (the chunk at t =
// 0 the shorter): the projection and the recompute of h_prev @ wh into ws
// (two [t_chunk, B, 3*d_m] f32 halves), the recurrence, then dx and the
// weight-gradient partials of the chunk's rows.
template <typename S>
int gen_bwd(const S* x, long long x_tstride, const S* mask,
            long long m_tstride, const S* scale, long long s_tstride,
            const S* wx, const S* wh, const S* b, const S* h0, const S* hseq,
            const S* dhseq, S* dx, float* dh0, float* dwx_part,
            float* dwh_part, float* db_part, S* dscale, float* ws, S* dg,
            int splits, int t_chunk, int T, int B, int d_in, int d_m,
            void* stream) {
  if (!dims_ok(d_in, d_m) || B < 1 || T < 1 || t_chunk < 1 || splits < 1
      || ws == nullptr || dg == nullptr
      || (scale != nullptr && dscale == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = 3 * d_m;
  const RecShape rs = rec_shape(B, d_m, true);
  float* xp = ws;
  float* gh = ws + (size_t)t_chunk * B * G;
  for (int hi = T; hi > 0;) {
    const int n = t_chunk < hi ? t_chunk : hi;
    const int t0 = hi - n;
    const long long rows = (long long)n * B;
    const bool first = hi == T;
    int code = launch_proj(x + t0 * x_tstride, x_tstride, wx, b, xp, rows,
                           B, d_in, d_m, st);
    if (code != 0) return code;
    code = launch_hprev(h0, hseq, wh, gh, t0, rows, B, d_m, st);
    if (code != 0) return code;
    const DenseCot<S> cot{h0, hseq, dhseq};
    if (scale != nullptr)
      code = rs.smem_w
                 ? bwd_rec<S, true, true>(rs, xp, gh, mask, m_tstride, scale,
                                          s_tstride, wh, b, cot, dg, dscale,
                                          dh0, t0, n, !first, B, d_m, st)
                 : bwd_rec<S, true, false>(rs, xp, gh, mask, m_tstride, scale,
                                           s_tstride, wh, b, cot, dg, dscale,
                                           dh0, t0, n, !first, B, d_m, st);
    else
      code = rs.smem_w
                 ? bwd_rec<S, false, true>(rs, xp, gh, mask, m_tstride,
                                           nullptr, 0, wh, b, cot, dg,
                                           nullptr, dh0, t0, n, !first, B,
                                           d_m, st)
                 : bwd_rec<S, false, false>(rs, xp, gh, mask, m_tstride,
                                            nullptr, 0, wh, b, cot, dg,
                                            nullptr, dh0, t0, n, !first, B,
                                            d_m, st);
    if (code != 0) return code;
    code = launch_dx(dg, wx, dx + (long long)t0 * B * d_in, rows, d_in, d_m,
                     st);
    if (code != 0) return code;
    code = launch_wgrad(x, x_tstride, h0, hseq, dg, dwx_part, dwh_part,
                        db_part, first, t0, rows, splits, B, d_in, d_m, false,
                        st);
    if (code != 0) return code;
    hi = t0;
  }
  return 0;
}

// K4-general: every workspace chunk of t_chunk steps (a multiple of
// kStrideChunk) from the last (the last in time the shorter): the
// projection into ws's first half, the replay from the chunk's boundary
// (h_prev into hprev, h @ wh into ws's second half), the sweep, then dx
// and the weight-gradient partials, whose h_prev reads hprev (its "h0" the
// chunk's first row, its "h_seq" the rows after it), one partial per
// slice of B / splits batch rows, so every output is the same bits over
// any chunk length.
template <typename S>
int gen_stride_bwd(const S* x, long long x_tstride, const S* wx,
                   const S* wh, const S* b, const S* hbound, const S* dhs,
                   const S* dhT, S* dx, float* dh0, float* dwx_part,
                   float* dwh_part, float* db_part, float* ws, S* dg,
                   S* hprev, int splits, int t_chunk, int T, int B, int d_in,
                   int d_m, int period, void* stream) {
  if (!dims_ok(d_in, d_m) || B < 1 || T < 1 || period < 2 || t_chunk < 1
      || t_chunk % hpmn::kStrideChunk != 0 || splits < 1 || B % splits != 0
      || ws == nullptr || dg == nullptr || hprev == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n_max = t_chunk < T ? t_chunk : T;  // the workspaces' steps
  if ((long long)n_max * B >= (1LL << 31))  // the products' 32-bit rows
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = 3 * d_m;
  const long long row_stride = (long long)B * d_m;
  const RecShape rs = rec_shape(B, d_m, true);
  float* xp = ws;
  float* gh = ws + (size_t)n_max * B * G;
  const int n_ws = (T + t_chunk - 1) / t_chunk;
  for (int wi = n_ws - 1; wi >= 0; --wi) {
    const int t0 = wi * t_chunk;
    const int n = T - t0 < t_chunk ? T - t0 : t_chunk;
    const long long rows = (long long)n * B;
    const bool first = wi == n_ws - 1;
    const S* x0 = x + t0 * x_tstride;
    int code = launch_proj(x0, x_tstride, wx, b, xp, rows, B, d_in, d_m, st);
    if (code != 0) return code;
    code = launch_replay(xp, wh, b,
                         hbound + (t0 / hpmn::kStrideChunk) * row_stride,
                         hprev, gh, n, B, d_m, st);
    if (code != 0) return code;
    const StrideCot<S> cot{hprev, dhs, dhT, period, T};
    code = rs.smem_w
               ? bwd_rec<S, false, true>(rs, xp, gh, nullptr, 0, nullptr, 0,
                                         wh, b, cot, dg, nullptr, dh0, t0, n,
                                         !first, B, d_m, st)
               : bwd_rec<S, false, false>(rs, xp, gh, nullptr, 0, nullptr, 0,
                                          wh, b, cot, dg, nullptr, dh0, t0, n,
                                          !first, B, d_m, st);
    if (code != 0) return code;
    code = launch_dx(dg, wx, dx + (long long)t0 * B * d_in, rows, d_in, d_m,
                     st);
    if (code != 0) return code;
    code = launch_wgrad(x0, x_tstride, hprev, hprev + row_stride, dg,
                        dwx_part, dwh_part, db_part, first, 0, rows, splits,
                        B, d_in, d_m, true, st);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// K2-general: K1-general's inputs, hseq and dhseq [T,B,d_m] contiguous;
// writes dx [T,B,d_in], dh0 [B,d_m] (f32), `splits` f32 partials
// dwx_part [splits,d_in,3*d_m], dwh_part [splits,d_m,3*d_m] and db_part
// [splits,3*d_m], and with a scale dscale [T,B] (contiguous). Workspaces:
// ws [2,t_chunk,B,3*d_m] f32 and dg [t_chunk,B,d_m,4] of x's type.
extern "C" int hpmn_gru_gen_bwd(
    const float* x, long long x_tstride, const float* mask,
    long long m_tstride, const float* scale, long long s_tstride,
    const float* wx, const float* wh, const float* b, const float* h0,
    const float* hseq, const float* dhseq, float* dx, float* dh0,
    float* dwx_part, float* dwh_part, float* db_part, float* dscale,
    float* ws, float* dg, int splits, int t_chunk, int T, int B, int d_in,
    int d_m, void* stream) {
  return gen_bwd<float>(x, x_tstride, mask, m_tstride, scale, s_tstride, wx,
                        wh, b, h0, hseq, dhseq, dx, dh0, dwx_part, dwh_part,
                        db_part, dscale, ws, dg, splits, t_chunk, T, B, d_in,
                        d_m, stream);
}

// K2-general-bf16: as K2-general, x, mask, scale, the weights, h0, hseq,
// dhseq, dx, dscale and dg bf16 (dh0, the partials and ws f32).
extern "C" int hpmn_gru_gen_bwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* scale, long long s_tstride,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* h0, const __nv_bfloat16* hseq,
    const __nv_bfloat16* dhseq, __nv_bfloat16* dx, float* dh0,
    float* dwx_part, float* dwh_part, float* db_part, __nv_bfloat16* dscale,
    float* ws, __nv_bfloat16* dg, int splits, int t_chunk, int T, int B,
    int d_in, int d_m, void* stream) {
  return gen_bwd<__nv_bfloat16>(x, x_tstride, mask, m_tstride, scale,
                                s_tstride, wx, wh, b, h0, hseq, dhseq, dx,
                                dh0, dwx_part, dwh_part, db_part, dscale, ws,
                                dg, splits, t_chunk, T, B, d_in, d_m, stream);
}


// K4-general: x [T,B,d_in] (time stride x_tstride, rows contiguous), wx
// [d_in,3*d_m], wh [d_m,3*d_m], b [3*d_m], hbound
// [ceil(T/hpmn_gru_scan_stride_chunk()),B,d_m] (K3-general's), dhs
// [T/period,B,d_m] or null, dhT [B,d_m] or null, all float32; writes dx
// [T,B,d_in], dh0 [B,d_m] and `splits` (a divisor of B) partials dwx_part
// [splits,d_in,3*d_m], dwh_part [splits,d_m,3*d_m] and db_part
// [splits,3*d_m] (f32). Workspaces, n = min(t_chunk, T) steps (t_chunk a
// multiple of hpmn_gru_scan_stride_chunk()): ws [2,n,B,3*d_m] f32, dg
// [n,B,d_m,4] and hprev [n,B,d_m] of x's type; after the call they hold
// the gate gradients and h_prev of the first workspace chunk. period >= 2,
// 1 <= d_m <= 256, 1 <= d_in <= 512. Runs on `stream`; returns the first
// nonzero cudaGetLastError() after a launch, or 0.
extern "C" int hpmn_gru_gen_stride_bwd(
    const float* x, long long x_tstride, const float* wx, const float* wh,
    const float* b, const float* hbound, const float* dhs, const float* dhT,
    float* dx, float* dh0, float* dwx_part, float* dwh_part, float* db_part,
    float* ws, float* dg, float* hprev, int splits, int t_chunk, int T,
    int B, int d_in, int d_m, int period, void* stream) {
  return gen_stride_bwd<float>(x, x_tstride, wx, wh, b, hbound, dhs, dhT, dx,
                               dh0, dwx_part, dwh_part, db_part, ws, dg,
                               hprev, splits, t_chunk, T, B, d_in, d_m,
                               period, stream);
}

// K4-general-bf16: as K4-general, x, the weights, hbound, dhs, dhT, dx, dg
// and hprev bf16 (dh0, the partials and ws f32).
extern "C" int hpmn_gru_gen_stride_bwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* hbound, const __nv_bfloat16* dhs,
    const __nv_bfloat16* dhT, __nv_bfloat16* dx, float* dh0, float* dwx_part,
    float* dwh_part, float* db_part, float* ws, __nv_bfloat16* dg,
    __nv_bfloat16* hprev, int splits, int t_chunk, int T, int B, int d_in,
    int d_m, int period, void* stream) {
  return gen_stride_bwd<__nv_bfloat16>(x, x_tstride, wx, wh, b, hbound, dhs,
                                       dhT, dx, dh0, dwx_part, dwh_part,
                                       db_part, ws, dg, hprev, splits,
                                       t_chunk, T, B, d_in, d_m, period,
                                       stream);
}

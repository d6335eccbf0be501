// K2-general, the width-general GRU scan backward (hpmn_gru_gen_bwd and
// its bf16 form, with and without the mask and the AUGRU scale): per chunk
// the projection and h_prev @ wh (gru_general_gemm.cu), the recurrence
// here, then dx and the weight-gradient partials. gru_general.cuh has the
// design.

#include "gru_general.cuh"

namespace {

using namespace hpmn_gen;

struct BwdLoad {
  float xr, xz, xc, gr, gz, gc;  // the step's xp and h_prev @ wh
  float hp, dhs, m, a;
};

// K2-general's recurrence over the chunk [t0, t0 + n): xp and gh [n, B,
// 3*d_m] f32 (ProjOp's and HprevOp's), mask [T, B] or null, scale [T, B]
// (kScale), wh [d_m, 3*d_m], bias (bf16: r and z), h0 [B, d_m] or null,
// hseq and dhseq [T, B, d_m]; writes dg [n, B, d_m, 4] and, with kScale,
// dscale [T, B]. dh [B, d_m] f32 carries dh in (`carry_in`) and out.
template <typename S, bool kScale, bool kSmemW>
__global__ void __launch_bounds__(kRecThreads)
gen_bwd_rec_kernel(const float* __restrict__ xp, const float* __restrict__ gh,
                   const S* __restrict__ mask, long long m_tstride,
                   const S* __restrict__ scale, long long s_tstride,
                   const S* __restrict__ wh, const S* __restrict__ bias,
                   const S* __restrict__ h0, const S* __restrict__ hseq,
                   const S* __restrict__ dhseq, S* __restrict__ dg,
                   S* __restrict__ dscale, float* __restrict__ dh, int t0,
                   int n, bool carry_in, int B, int d_m, int rows) {
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
  float b_r = 0.0f, b_z = 0.0f, dhc = 0.0f;
  if (active) {
    if constexpr (kBf16) {
      b_r = load_f(bias + j);
      b_z = load_f(bias + d_m + j);
    }
    if (carry_in) dhc = dh[(long long)row * d_m + j];
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
    s.hp = h_prev(h0, hseq, t, row, j, B, d_m);
    s.dhs = load_f(dhseq + ((long long)t * B + row) * d_m + j);
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
      if constexpr (kBf16)
        sg = hpmn::step_grad_bf16<kScale>(
            hpmn::gates_bf16_xp(cur.xr, cur.xz, cur.xc, cur.gr, cur.gz,
                                cur.gc, b_r, b_z),
            hpmn::to_b(cur.hp), hpmn::to_b(cur.dhs + dhc),
            hpmn::to_b(cur.m), masked, hpmn::to_b(cur.a));
      else
        sg = hpmn::step_grad_f32<kScale>(
            hpmn::gates_f32_xp(cur.xr, cur.xz, cur.xc, cur.gr, cur.gz,
                               cur.gc),
            cur.hp, cur.dhs + dhc, cur.m, cur.a);
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

template <typename S, bool kScale, bool kSmemW>
int bwd_rec(const RecShape& rs, const float* xp, const float* gh,
            const S* mask, long long m_tstride, const S* scale,
            long long s_tstride, const S* wh, const S* b, const S* h0,
            const S* hseq, const S* dhseq, S* dg, S* dscale, float* dh,
            int t0, int n, bool carry_in, int B, int d_m, cudaStream_t st) {
  auto kernel = gen_bwd_rec_kernel<S, kScale, kSmemW>;
  const int code = prepare(kernel, rs);
  if (code != 0) return code;
  const int grid = (B + rs.rows - 1) / rs.rows;
  kernel<<<grid, rs.threads, rs.smem, st>>>(
      xp, gh, mask, m_tstride, scale, s_tstride, wh, b, h0, hseq, dhseq, dg,
      dscale, dh, t0, n, carry_in, B, d_m, rs.rows);
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
    if (scale != nullptr)
      code = rs.smem_w
                 ? bwd_rec<S, true, true>(rs, xp, gh, mask, m_tstride, scale,
                                          s_tstride, wh, b, h0, hseq, dhseq,
                                          dg, dscale, dh0, t0, n, !first, B,
                                          d_m, st)
                 : bwd_rec<S, true, false>(rs, xp, gh, mask, m_tstride, scale,
                                           s_tstride, wh, b, h0, hseq, dhseq,
                                           dg, dscale, dh0, t0, n, !first, B,
                                           d_m, st);
    else
      code = rs.smem_w
                 ? bwd_rec<S, false, true>(rs, xp, gh, mask, m_tstride,
                                           nullptr, 0, wh, b, h0, hseq, dhseq,
                                           dg, nullptr, dh0, t0, n, !first, B,
                                           d_m, st)
                 : bwd_rec<S, false, false>(rs, xp, gh, mask, m_tstride,
                                            nullptr, 0, wh, b, h0, hseq,
                                            dhseq, dg, nullptr, dh0, t0, n,
                                            !first, B, d_m, st);
    if (code != 0) return code;
    code = launch_dx(dg, wx, dx + (long long)t0 * B * d_in, rows, d_in, d_m,
                     st);
    if (code != 0) return code;
    code = launch_wgrad(x, x_tstride, h0, hseq, dg, dwx_part, dwh_part,
                        db_part, first, t0, rows, splits, B, d_in, d_m, st);
    if (code != 0) return code;
    hi = t0;
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


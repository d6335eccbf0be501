// Strided-output GRU scan backward for Hopper (sm_90a): each layer swept in
// reverse, replaying the forward chunk by chunk.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_bwd_stride_kernel in both of its
// chains: f32 (K4, hpmn_gru_scan_stride_bwd_ws) and dtype=bfloat16
// (K4-bf16, hpmn_gru_scan_stride_bwd_bf16_ws). Its inputs are x, the chunk
// boundary states that K3 wrote, the cotangents of the strided rows dhs
// [T/period,B,32] and of h_T dhT [B,32] (either may be absent: zero). For
// each chunk of kStrideChunk steps, last first, for batch row b:
//
// 1. Replay the chunk forward from its boundary state with K3's step
//    (gru_chain.cuh: project()'s sums in its fmaf order, the gates,
//    stride_update; so the states are K3's bit for bit), keeping in this
//    warp's shared memory, per step, h_prev, the gates r, z, c, g_c and
//    the step's output cotangent (dhs at a firing step, else 0).
// 2. Sweep the chunk in reverse, K2's way, from what step 1 kept (no
//    recompute of the projections):
//
//      gcell = (dh + dhs[(t+1)/period - 1]) + dhT   the first term where
//              (t+1) % period == 0, the second at t = T-1 (in this order,
//              as the TPU kernel, all in f32; rounded once to bf16 in the
//              bf16 chain)
//      gru_chain.cuh::step_grad_* (no mask), then K2's products:
//      dh = carry + [dr|dz|dc*r] @ wh^T;  dx_t = [dr|dz|dc] @ wx^T
//      dWx += x_t^T [dr|dz|dc];  dWh += h_prev^T [dr|dz|dc*r];  db += ...
//
// The dh carry stays f32 in both chains; dx is written in the stream type;
// the weight gradients are f32 partials, one per group of
// rows_per_block(d_in) rows, summed by the wrapper, as K2's.
//
// What bounds it: the recurrence, twice per step: the replay is K1's chain
// and the sweep K2's without its recompute. Per row and step it reads x
// once and writes dx once; dhs is a third of a row per step at period 3.
// The dense path's h_seq (K1's output, 65.5 MB at layer 0 in f32 at B =
// 512, T = 1000) and its dense dh_seq are neither written nor read: the
// strided path's residual is the boundaries, 1/16 of that.
//
// K4 and K4-bf16 are three kernels per workspace chunk of steps (a
// multiple of kStrideChunk, so that no replayed chunk straddles two), run
// by one C entry point from the last chunk to the first, as K2
// (gru_scan_bwd.cu):
//
// - the input projection (gru_input_proj.cu, K1's first kernel) writes
//   the chunk's x @ wx into the f32 workspace xp [Tc, B, 96];
// - the recurrence (gru_scan_stride_bwd_rec_kernel, here) does 1 and 2 up
//   to the gate gradients and dh: one warp per batch row and block, wh in
//   registers in both of its layouts, xp read from shared memory (by
//   cp.async), h broadcast through shared memory as float4s. Per step of
//   the sweep it writes [dr, dz, dc, dc*r] into the workspace dg [Tc, B,
//   32, 4] and h_prev into hprev [Tc, B, 32] (both in the stream type; in
//   bf16 they are bf16 values, so storing them is exact) and takes dh's
//   product with wh^T. The carry crosses a workspace chunk through dh0
//   [B, 32] (f32).
// - the pass (gru_bwd_pass.cu) computes dx and each row's weight-gradient
//   sums from x, hprev and dg; after the last chunk, one partial per group
//   of rows_per_block(d_in) rows, the rows the one-kernel form's blocks
//   summed, in their order.
//
// Every output is the one-kernel form's bit for bit, whatever the chunk:
// the carry and the sums cross chunks in f32, unrounded.
//
// The one-kernel form (gru_scan_stride_bwd_kernel: the replay, then the
// sweep with dx and the weight gradients inside it, into per-warp
// shared-memory slices, gru_chain.cuh's BwdSmem layout) is kept behind its own entry
// points (hpmn_gru_scan_stride_bwd[_bf16]), which a comparison of the two
// forms calls; the wrappers call the three-kernel form.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kG;
using hpmn::kMaxChunks;  // d_in <= 96
using hpmn::kStrideChunk;
using hpmn::load_f;
constexpr int kMaxWarps = 4;  // batch rows per block, at most
// Per replayed step, floats: h_prev, r, z, c, g_c, the output cotangent
// (then, in the one-kernel form, x_t: d_in_pad).
constexpr int kSlots = 6 * kDm;

__host__ __device__ size_t replay_floats(int d_in_pad) {
  return (size_t)kStrideChunk * (kSlots + d_in_pad);
}

// Batch rows per block of the one-kernel form (its shared memory holds a
// weight-gradient slice and a replayed chunk per row), and the group of
// rows that each weight-gradient partial sums in both forms.
int rows_per_block(int d_in) {
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t free_bytes =
      hpmn::kMaxSmem - hpmn::weights_floats(d_in_pad) * 4;
  int w = (int)(free_bytes /
                ((hpmn::acc_floats(d_in_pad) + replay_floats(d_in_pad)) * 4));
  return w < kMaxWarps ? w : kMaxWarps;
}

// The one-kernel form. S: the stream type, float (K4) or __nv_bfloat16
// (K4-bf16).
template <typename S>
__global__ void __launch_bounds__(kMaxWarps * 32)
gru_scan_stride_bwd_kernel(const S* __restrict__ x, long long x_tstride,
                           const S* __restrict__ wx, const S* __restrict__ wh,
                           const S* __restrict__ bias,
                           const S* __restrict__ hbound,
                           const S* __restrict__ dhs,
                           const S* __restrict__ dhT, S* __restrict__ dx,
                           float* __restrict__ dh0,
                           float* __restrict__ dwx_part,
                           float* __restrict__ dwh_part,
                           float* __restrict__ db_part, int T, int B,
                           int d_in, int period) {
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  extern __shared__ float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * warps + warp;
  const hpmn::BwdSmem sm =
      hpmn::load_bwd_smem(smem, wx, wh, d_in, d_in_pad, warps, warp);
  const int step_n = kSlots + d_in_pad;  // floats per replayed step
  float* replay = sm.end + warp * replay_floats(d_in_pad);

  if (row < B) {  // a warp past the last row skips to the block sum
    const float b_r = load_f(bias + lane);
    const float b_z = load_f(bias + kDm + lane);
    const float b_c = load_f(bias + 2 * kDm + lane);
    const long long out_off = (long long)row * kDm + lane;
    const long long row_stride = (long long)B * kDm;  // one time row
    const S* x_row = x + (long long)row * d_in;
    const float dh_T = dhT != nullptr ? load_f(dhT + out_off) : 0.0f;
    float dh = 0.0f;
    float db_r = 0.0f, db_z = 0.0f, db_c = 0.0f;
    const int n_time_chunks = (T + kStrideChunk - 1) / kStrideChunk;
    for (int ci = n_time_chunks - 1; ci >= 0; --ci) {
      const int t0 = ci * kStrideChunk;
      const int n = T - t0 < kStrideChunk ? T - t0 : kStrideChunk;

      // 1. Replay the chunk from its boundary, as K3 ran it.
      float h = load_f(hbound + ci * row_stride + out_off);
      hpmn::B hb = hpmn::to_b(h);
      S xr[kMaxChunks];  // x, raw, a step ahead (gru_chain.cuh)
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) xr[c] = S();
      hpmn::load_x_raw(xr, x_row + (long long)t0 * x_tstride, true, n_chunks,
                       d_in, lane);
      float xv[kMaxChunks];
      for (int k = 0; k < n; ++k) {
        const int t = t0 + k;
        hpmn::convert_x(xr, xv);
        hpmn::load_x_raw(xr, x_row + (long long)(t + 1) * x_tstride,
                         k + 1 < n, n_chunks, d_in, lane);
        // The output cotangent: loaded here, kept after the math, so the
        // load's latency hides behind the step.
        const float cot =
            (t + 1) % period == 0 && dhs != nullptr
                ? load_f(dhs + ((t + 1) / period - 1) * row_stride + out_off)
                : 0.0f;
        float* st = replay + k * step_n;
        st[lane] = h;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          if (c < n_chunks) st[kSlots + 32 * c + lane] = xv[c];
        const hpmn::Proj p =
            hpmn::project(xv, n_chunks, h, sm.wx, sm.wh, lane);
        if constexpr (kBf16) {
          const hpmn::GatesB g = hpmn::gates_bf16(p, b_r, b_z, b_c);
          st[kDm + lane] = hpmn::to_f(g.r);
          st[2 * kDm + lane] = hpmn::to_f(g.z);
          st[3 * kDm + lane] = hpmn::to_f(g.c);
          st[4 * kDm + lane] = hpmn::to_f(g.gc);
          hb = hpmn::stride_update(g, hb);
          h = hpmn::to_f(hb);
        } else {
          const hpmn::Gates g = hpmn::gates_f32(p, b_r, b_z, b_c);
          st[kDm + lane] = g.r;
          st[2 * kDm + lane] = g.z;
          st[3 * kDm + lane] = g.c;
          st[4 * kDm + lane] = g.gc;
          h = hpmn::stride_update(g, h);
        }
        st[5 * kDm + lane] = cot;
      }

      // 2. Sweep the chunk in reverse from what the replay kept.
      for (int k = n - 1; k >= 0; --k) {
        const int t = t0 + k;
        const float* st = replay + k * step_n;
        const float hp = st[lane];
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          xv[c] = c < n_chunks ? st[kSlots + 32 * c + lane] : 0.0f;
        float gin = dh + st[5 * kDm + lane];
        if (t == T - 1) gin = gin + dh_T;
        hpmn::StepGrad sg;
        if constexpr (kBf16) {
          hpmn::GatesB g;
          g.r = hpmn::to_b(st[kDm + lane]);
          g.z = hpmn::to_b(st[2 * kDm + lane]);
          g.c = hpmn::to_b(st[3 * kDm + lane]);
          g.gc = hpmn::to_b(st[4 * kDm + lane]);
          sg = hpmn::step_grad_bf16(g, hpmn::to_b(hp), hpmn::to_b(gin),
                                    hpmn::one_b(), false);
        } else {
          hpmn::Gates g;
          g.r = st[kDm + lane];
          g.z = st[2 * kDm + lane];
          g.c = st[3 * kDm + lane];
          g.gc = st[4 * kDm + lane];
          sg = hpmn::step_grad_f32(g, hp, gin, 1.0f);
        }
        dh = hpmn::backprop_step(sg, sm, n_chunks, d_in, d_in_pad, lane,
                                 dx + ((long long)t * B + row) * d_in);
        hpmn::accumulate_wgrad(xv, hp, sg, sm, n_chunks, d_in_pad, lane);
        db_r += sg.dr;
        db_z += sg.dz;
        db_c += sg.dc;
      }
    }
    dh0[out_off] = dh;
    float* acc_b = sm.acc + (d_in_pad + kDm) * kG;
    acc_b[lane] = db_r;
    acc_b[kDm + lane] = db_z;
    acc_b[2 * kDm + lane] = db_c;
  }
  __syncthreads();
  hpmn::write_wgrad_partials(sm, warps, d_in, d_in_pad, dwx_part, dwh_part,
                             db_part);
}

// The recurrence of K4 (S = float) and K4-bf16 (S = __nv_bfloat16) over the
// workspace chunk [t0, t0 + n) (t0 a multiple of kStrideChunk; t0 + n is T
// or one too): gru_scan_stride_bwd_kernel's replay and sweep with dx, the
// weight-gradient sums and db taken out, and the replay's x @ wx read from
// the input projection's workspace xp [n, B, 96] (f32, gru_input_proj.cu:
// x @ wx + b in f32; in bf16 x @ wx for r and z and bf16(x @ wx_c + b_c)
// for c, which gates_f32_xp and gates_bf16_xp take, the bits of project()
// and gates_f32/gates_bf16). Per step it writes the gate gradients into dg
// [n, B, 32, 4] and h_prev into hprev [n, B, 32] (S) at (t - t0, row). dh
// [B, 32] (f32) carries dh in (`carry_in`; else it starts at zero) and
// out.
//
// One warp, one batch row, per block, as K2's recurrence. Both of the
// step's products with wh read it from registers: the replay's h @ wh
// (lane j: wh[k][32g + j]) and dh's [dr|dz|dc*r] @ wh^T (lane j: wh[j][32g
// + k]), 192 floats a lane. A chunk's xp lands in shared memory by
// cp.async (each lane copies its own three words per step; two buffers),
// fetched during the sweep of the chunk after it, with that chunk's
// boundary state. The replay broadcasts h_prev (the step's kept slot)
// through shared memory as float4s and the sweep the gate gradients (two
// buffers): one __syncwarp per step. The fmaf orders are project()'s and
// backprop_step()'s, and the sweep's expressions the one-kernel form's,
// so the bits are its. (Reading x and wx in the replay instead, x a step
// ahead, took 1.8715 ms against 1.6705 at T = 1000, B = 512, d_in = 32;
// PERF.md.)
template <typename S>
__global__ void __launch_bounds__(32)
gru_scan_stride_bwd_rec_kernel(
    const float* __restrict__ xp, const S* __restrict__ wh,
    const S* __restrict__ bias, const S* __restrict__ hbound,
    const S* __restrict__ dhs, const S* __restrict__ dhT,
    S* __restrict__ dg, S* __restrict__ hprev, float* __restrict__ dh,
    int t0, int n, bool carry_in, int T, int B, int period) {
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  float* s_xp = smem;                          // [2][kStrideChunk][96]
  float* s_st = s_xp + 2 * kStrideChunk * kG;  // [kStrideChunk][kSlots]
  float4* s_g = reinterpret_cast<float4*>(s_st + kStrideChunk * kSlots);
  float wh_k[3][kDm];
  float wh_t[3][kDm];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < kDm; ++k) {
      wh_k[g][k] = load_f(wh + k * kG + g * kDm + lane);
      wh_t[g][k] = load_f(wh + lane * kG + g * kDm + k);
    }
  const float b_r = load_f(bias + lane);
  const float b_z = load_f(bias + kDm + lane);
  const long long out_off = (long long)row * kDm + lane;
  const long long row_stride = (long long)B * kDm;
  const float dh_T = dhT != nullptr ? load_f(dhT + out_off) : 0.0f;
  float dhc = carry_in ? dh[out_off] : 0.0f;
  const int c_hi = (t0 + n - 1) / kStrideChunk;
  const int c_lo = t0 / kStrideChunk;
  // A chunk's xp, this lane's words of each step, into buffer c & 1.
  auto fetch = [&](int c) {
    const int c0 = c * kStrideChunk;
    const int cn = t0 + n - c0 < kStrideChunk ? t0 + n - c0 : kStrideChunk;
    float* buf = s_xp + (c & 1) * kStrideChunk * kG;
    for (int k = 0; k < cn; ++k) {
      const float* p = xp + ((long long)(c0 + k - t0) * B + row) * kG + lane;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        hpmn::copy_async(buf + k * kG + g * kDm + lane, p + g * kDm);
    }
    hpmn::copy_async_commit();
  };
  fetch(c_hi);
  float h_next = load_f(hbound + c_hi * row_stride + out_off);
  for (int ci = c_hi; ci >= c_lo; --ci) {
    const int c0 = ci * kStrideChunk;
    const int cn = t0 + n - c0 < kStrideChunk ? t0 + n - c0 : kStrideChunk;
    const float* buf = s_xp + (ci & 1) * kStrideChunk * kG;
    hpmn::copy_async_wait<0>();
    float h = h_next;
    hpmn::B hb = hpmn::to_b(h);
    for (int k = 0; k < cn; ++k) {
      const int t = c0 + k;
      const float cot =
          (t + 1) % period == 0 && dhs != nullptr
              ? load_f(dhs + ((t + 1) / period - 1) * row_stride + out_off)
              : 0.0f;
      float* st = s_st + k * kSlots;
      st[lane] = h;
      __syncwarp();
      float gr = 0.0f, gz = 0.0f, gc = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < 8; ++k4) {
        const float4 q = *reinterpret_cast<const float4*>(st + 4 * k4);
        const float hq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * k4 + e;
          gr = fmaf(hq[e], wh_k[0][j], gr);
          gz = fmaf(hq[e], wh_k[1][j], gz);
          gc = fmaf(hq[e], wh_k[2][j], gc);
        }
      }
      const float* xk = buf + k * kG;
      if constexpr (kBf16) {
        const hpmn::GatesB g = hpmn::gates_bf16_xp(
            xk[lane], xk[kDm + lane], xk[2 * kDm + lane], gr, gz, gc, b_r,
            b_z);
        st[kDm + lane] = hpmn::to_f(g.r);
        st[2 * kDm + lane] = hpmn::to_f(g.z);
        st[3 * kDm + lane] = hpmn::to_f(g.c);
        st[4 * kDm + lane] = hpmn::to_f(g.gc);
        hb = hpmn::stride_update(g, hb);
        h = hpmn::to_f(hb);
      } else {
        const hpmn::Gates g = hpmn::gates_f32_xp(
            xk[lane], xk[kDm + lane], xk[2 * kDm + lane], gr, gz, gc);
        st[kDm + lane] = g.r;
        st[2 * kDm + lane] = g.z;
        st[3 * kDm + lane] = g.c;
        st[4 * kDm + lane] = g.gc;
        h = hpmn::stride_update(g, h);
      }
      st[5 * kDm + lane] = cot;
    }
    if (ci > c_lo) {
      fetch(ci - 1);
      h_next = load_f(hbound + (ci - 1) * row_stride + out_off);
    }
    for (int k = cn - 1; k >= 0; --k) {
      const int t = c0 + k;
      const float* st = s_st + k * kSlots;
      const float hp = st[lane];
      float gin = dhc + st[5 * kDm + lane];
      if (t == T - 1) gin = gin + dh_T;
      hpmn::StepGrad sg;
      if constexpr (kBf16) {
        hpmn::GatesB g;
        g.r = hpmn::to_b(st[kDm + lane]);
        g.z = hpmn::to_b(st[2 * kDm + lane]);
        g.c = hpmn::to_b(st[3 * kDm + lane]);
        g.gc = hpmn::to_b(st[4 * kDm + lane]);
        sg = hpmn::step_grad_bf16(g, hpmn::to_b(hp), hpmn::to_b(gin),
                                  hpmn::one_b(), false);
      } else {
        hpmn::Gates g;
        g.r = st[kDm + lane];
        g.z = st[2 * kDm + lane];
        g.c = st[3 * kDm + lane];
        g.gc = st[4 * kDm + lane];
        sg = hpmn::step_grad_f32(g, hp, gin, 1.0f);
      }
      const long long o = (long long)(t - t0) * B + row;
      hpmn::store4(dg + (o * kDm + lane) * 4, sg.dr, sg.dz, sg.dc, sg.dcr);
      hpmn::store_f(hprev + o * kDm + lane, hp);
      float4* g4 = s_g + (k & 1) * kDm;
      g4[lane] = make_float4(sg.dr, sg.dz, sg.dc, sg.dcr);
      __syncwarp();
      float dh_new = kBf16 ? 0.0f : sg.carry;
#pragma unroll
      for (int j = 0; j < kDm; ++j) {
        const float4 d = g4[j];
        dh_new = fmaf(d.x, wh_t[0][j], dh_new);
        dh_new = fmaf(d.y, wh_t[1][j], dh_new);
        dh_new = fmaf(d.w, wh_t[2][j], dh_new);
      }
      dhc = kBf16 ? sg.carry + dh_new : dh_new;
    }
  }
  dh[out_off] = dhc;
}

// x [T,B,d_in] (time stride x_tstride, rows contiguous), wx [d_in,96], wh
// [32,96], b [96], hbound [ceil(T/chunk),B,32] (K3's), dhs [T/period,B,32]
// or null, dhT [B,32] or null, all of one type S: float for K4, bf16 for
// K4-bf16. Writes dx [T,B,d_in] (S) and dh0 [B,32] (f32, the carry), both
// contiguous, and per block the f32 partials dwx_part [d_in,96], dwh_part
// [32,96] and db_part [96]. period >= 2. Launches on `stream`; returns
// cudaGetLastError().
template <typename S>
int launch(const S* x, long long x_tstride, const S* wx, const S* wh,
           const S* b, const S* hbound, const S* dhs, const S* dhT, S* dx,
           float* dh0, float* dwx_part, float* dwh_part, float* db_part,
           int T, int B, int d_in, int period, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1 || period < 2)
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const int warps = rows_per_block(d_in);
  const size_t smem = (hpmn::weights_floats(d_in_pad) +
                       warps * (hpmn::acc_floats(d_in_pad) +
                                replay_floats(d_in_pad))) *
                      4;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_stride_bwd_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + warps - 1) / warps;
  gru_scan_stride_bwd_kernel<S>
      <<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
          x, x_tstride, wx, wh, b, hbound, dhs, dhT, dx, dh0, dwx_part,
          dwh_part, db_part, T, B, d_in, period);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch rows per weight-gradient partial for this d_in: the wrapper
// allocates ceil(B / rows) partials.
extern "C" int hpmn_gru_scan_stride_bwd_rows_per_block(int d_in) {
  if (d_in < 1 || d_in > 32 * kMaxChunks) return 0;
  return rows_per_block(d_in);
}

// The one-kernel form of K4 and K4-bf16 (launch's arguments above).
extern "C" int hpmn_gru_scan_stride_bwd(
    const float* x, long long x_tstride, const float* wx, const float* wh,
    const float* b, const float* hbound, const float* dhs, const float* dhT,
    float* dx, float* dh0, float* dwx_part, float* dwh_part, float* db_part,
    int T, int B, int d_in, int period, void* stream) {
  return launch(x, x_tstride, wx, wh, b, hbound, dhs, dhT, dx, dh0, dwx_part,
                dwh_part, db_part, T, B, d_in, period, stream);
}

extern "C" int hpmn_gru_scan_stride_bwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* hbound, const __nv_bfloat16* dhs,
    const __nv_bfloat16* dhT, __nv_bfloat16* dx, float* dh0, float* dwx_part,
    float* dwh_part, float* db_part, int T, int B, int d_in, int period,
    void* stream) {
  return launch(x, x_tstride, wx, wh, b, hbound, dhs, dhT, dx, dh0, dwx_part,
                dwh_part, db_part, T, B, d_in, period, stream);
}

namespace {

// The recurrence's shared memory: two chunks of xp, the kept steps of one
// chunk, two float4 buffers of gate gradients.
size_t rec_smem_bytes() {
  return ((size_t)2 * kStrideChunk * kG + kStrideChunk * kSlots +
          2 * 4 * kDm) *
         4;
}

// K4 and K4-bf16: every workspace chunk of t_chunk steps from the last (the
// last in time the shorter): the input projection, the recurrence, the
// pass; then the partials.
template <typename S>
int launch_ws(const S* x, long long x_tstride, const S* wx, const S* wh,
              const S* b, const S* hbound, const S* dhs, const S* dhT, S* dx,
              float* dh0, float* dwx_part, float* dwh_part, float* db_part,
              S* dg, S* hprev, float* xp, float* acc, int t_chunk, int T,
              int B, int d_in, int period, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1 || period < 2 ||
      t_chunk < 1 || t_chunk % kStrideChunk != 0 || dg == nullptr ||
      hprev == nullptr || xp == nullptr || acc == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = rec_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_stride_bwd_rec_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ws = (T + t_chunk - 1) / t_chunk;
  for (int wi = n_ws - 1; wi >= 0; --wi) {
    const int t0 = wi * t_chunk;
    const int n = T - t0 < t_chunk ? T - t0 : t_chunk;
    int code = hpmn::launch_input_proj<S>(x + t0 * x_tstride, x_tstride, wx,
                                          b, xp, n, B, d_in, st);
    if (code != 0) return code;
    gru_scan_stride_bwd_rec_kernel<S><<<B, 32, smem, st>>>(
        xp, wh, b, hbound, dhs, dhT, dg, hprev, dh0, t0, n, wi < n_ws - 1, T,
        B, period);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
    code = hpmn::launch_bwd_pass<S>(x, x_tstride, wx, nullptr, hprev, t0, dg,
                                    dx, acc, t0, n, wi == n_ws - 1, B, d_in,
                                    st);
    if (code != 0) return code;
  }
  return hpmn::launch_wgrad_partials(acc, rows_per_block(d_in), B, d_in,
                                     dwx_part, dwh_part, db_part, st);
}

}  // namespace

// K4: the one-kernel form's arguments, then the workspaces dg
// [t_chunk,B,128] and hprev [t_chunk,B,32] (float32), xp [t_chunk,B,96]
// (f32) (t_chunk a multiple of hpmn_gru_scan_stride_chunk(); rows past T
// unused) and acc [B, (d_in_pad + 33) * 96] (f32, d_in_pad = d_in rounded
// up to 32). Writes dx [T,B,d_in],
// dh0 [B,32] and one f32 partial per group of
// hpmn_gru_scan_stride_bwd_rows_per_block(d_in) rows. After the call, dg
// and hprev hold the gate gradients and h_prev of the steps [t0, T) of the
// last workspace chunk run, the first: t0 = 0. Runs on `stream`; returns
// the first nonzero cudaGetLastError() after a launch, or 0.
extern "C" int hpmn_gru_scan_stride_bwd_ws(
    const float* x, long long x_tstride, const float* wx, const float* wh,
    const float* b, const float* hbound, const float* dhs, const float* dhT,
    float* dx, float* dh0, float* dwx_part, float* dwh_part, float* db_part,
    float* dg, float* hprev, float* xp, float* acc, int t_chunk, int T,
    int B, int d_in, int period, void* stream) {
  return launch_ws<float>(x, x_tstride, wx, wh, b, hbound, dhs, dhT, dx, dh0,
                          dwx_part, dwh_part, db_part, dg, hprev, xp, acc,
                          t_chunk, T, B, d_in, period, stream);
}

// K4-bf16: as K4, with x, the weights, hbound, dhs, dhT, dx, dg and hprev
// in bf16 (dh0, the partials, xp and acc f32).
extern "C" int hpmn_gru_scan_stride_bwd_bf16_ws(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* wh, const __nv_bfloat16* b,
    const __nv_bfloat16* hbound, const __nv_bfloat16* dhs,
    const __nv_bfloat16* dhT, __nv_bfloat16* dx, float* dh0, float* dwx_part,
    float* dwh_part, float* db_part, __nv_bfloat16* dg,
    __nv_bfloat16* hprev, float* xp, float* acc, int t_chunk, int T, int B,
    int d_in, int period, void* stream) {
  return launch_ws<__nv_bfloat16>(x, x_tstride, wx, wh, b, hbound, dhs, dhT,
                                  dx, dh0, dwx_part, dwh_part, db_part, dg,
                                  hprev, xp, acc, t_chunk, T, B, d_in, period,
                                  stream);
}

// Strided-output GRU scan backward for Hopper (sm_90a): one launch sweeps
// one whole layer in reverse, replaying the forward chunk by chunk.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_bwd_stride_kernel in both of its
// chains: f32 (K4, hpmn_gru_scan_stride_bwd) and dtype=bfloat16 (K4-bf16,
// hpmn_gru_scan_stride_bwd_bf16). Its inputs are x, the chunk boundary
// states that K3 wrote, the cotangents of the strided rows dhs [T/period,
// B,32] and of h_T dhT [B,32] (either may be absent: zero). For each chunk
// of kStrideChunk steps, last first, for batch row b:
//
// 1. Replay the chunk forward from its boundary state with K3's step
//    (gru_chain.cuh: project, gates, stride_update; the same device
//    functions, so the states are K3's bit for bit), keeping in this
//    warp's shared memory, per step, h_prev, the gates r, z, c, g_c, x_t
//    and the step's output cotangent (dhs at a firing step, else 0).
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
// the weight gradients are f32 partials, one per block, summed by the
// wrapper, as K2's.
//
// What bounds it: the recurrence, twice per step: the replay is K1's chain
// and the sweep is K2's without its recompute. Per row and step it reads x
// once and writes dx once; dhs is a third of a row per step at period 3.
// The dense path's h_seq (K1's output, 65.5 MB at layer 0 in f32 at B =
// 512, T = 1000) and its dense dh_seq are neither written nor read: the
// strided path's residual is the boundaries, 1/16 of that.
//
// What the design does about it: K2's layout (one warp per batch row, the
// whole reverse loop in one launch, weights row-major and transposed in
// shared memory, per-warp weight-gradient slices; all in gru_chain.cuh),
// plus a per-warp slice of kStrideChunk steps for the replayed chunk, where
// lane j reads and writes only its own words (no barrier, no bank
// conflict). Keeping the gates of the replay spares the sweep the
// projections K2 recomputes. With the slice, a block of 4 warps takes
// 206,336 B of shared memory at d_in = 32 (K2: 148,992).

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kG;
using hpmn::kMaxChunks;  // d_in <= 96
using hpmn::kStrideChunk;
using hpmn::load_f;
constexpr int kMaxWarps = 4;  // batch rows per block, at most
// Per replayed step, floats: h_prev, r, z, c, g_c, the output cotangent,
// then x_t (d_in_pad).
constexpr int kSlots = 6 * kDm;

__host__ __device__ size_t replay_floats(int d_in_pad) {
  return (size_t)kStrideChunk * (kSlots + d_in_pad);
}

int rows_per_block(int d_in) {
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t free_bytes =
      hpmn::kMaxSmem - hpmn::weights_floats(d_in_pad) * 4;
  int w = (int)(free_bytes /
                ((hpmn::acc_floats(d_in_pad) + replay_floats(d_in_pad)) * 4));
  return w < kMaxWarps ? w : kMaxWarps;
}

// S: the stream type, float (K4) or __nv_bfloat16 (K4-bf16).
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

// Batch rows per block for this d_in: the wrapper allocates one weight-
// gradient partial per block, ceil(B / rows) of them.
extern "C" int hpmn_gru_scan_stride_bwd_rows_per_block(int d_in) {
  if (d_in < 1 || d_in > 32 * kMaxChunks) return 0;
  return rows_per_block(d_in);
}

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

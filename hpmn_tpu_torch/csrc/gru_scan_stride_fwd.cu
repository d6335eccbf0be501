// Strided-output GRU scan forward for Hopper (sm_90a): what the next HPMN
// layer and the backward read, and nothing else.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_fwd_stride_kernel in both of its
// chains: f32 (K3) and dtype=bfloat16 (K3-bf16). No mask (the
// full-sequence path). K3 and K3-bf16 run as K1 does, two kernels per
// workspace chunk (K1's input projection, then K1's recurrence with a
// strided output policy), from hpmn_gru_scan_stride_fwd_ws and
// hpmn_gru_scan_stride_fwd_bf16_ws in gru_scan_fwd.cu. This file keeps
// their first, one-kernel form (hpmn_gru_scan_stride_fwd[_bf16]), which a
// comparison of the two forms calls (the two agree bit for bit), and the
// boundary chunk's length. Per step t, for batch row b, with K1's gates
// (gru_chain.cuh):
//
//   h_t = h_{t-1} + z * (c - h_{t-1})     (gru_chain.cuh::stride_update)
//
// and it writes three things, none of them the dense h_seq:
//
//   h_stride[(t+1)/period - 1] = h_t   where (t+1) % period == 0, that is
//                                      h_seq[period-1::period], T//period rows
//   hbound[t/kStrideChunk]     = h_{t-1} where t % kStrideChunk == 0: the
//                                      state at the start of each chunk of
//                                      kStrideChunk steps, the backward's
//                                      only residual
//   h_T                        = h_{T-1}
//
// The TPU kernel pads T to a multiple of its chunk (the least multiple of
// period >= 8) and makes the pad steps identity steps; here the chunk
// length is a constant of its own (it need not divide by period) and the
// last chunk is simply shorter, so nothing is padded.
//
// In f32 the update is the TPU stride kernel's h + z*(c - h), not K1's
// no-mask h + 1*(h_cell - h), so h_stride may differ from K1's strided rows
// by an ulp. In bf16 it is K1-bf16's no-mask h_cell, op by op, so K3-bf16's
// rows are K1-bf16's h_seq[period-1::period] bit for bit.
//
// What bounds it: the recurrence, as K1 (gru_scan_fwd.cu): each step waits
// for the last, and the work per step is small. It writes a third of K1's
// rows at period 3, which are not on that chain. The one-kernel form is
// K1's first design: the whole time loop in one launch, one warp per batch
// row, lane j owning hidden unit j, the carry in a register, weights in
// shared memory, x @ wx inside the loop, x prefetched a step ahead, kept
// in the stream type until its step.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kMaxChunks;  // d_in <= 96: weights fit 48 KB of smem
using hpmn::kStrideChunk;
constexpr int kWarps = 4;  // batch rows per block

// S: the stream type, float (K3) or __nv_bfloat16 (K3-bf16).
template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
gru_scan_stride_fwd_kernel(const S* __restrict__ x, long long x_tstride,
                           const S* __restrict__ wx, const S* __restrict__ wh,
                           const S* __restrict__ bias,
                           const S* __restrict__ h0, S* __restrict__ hs,
                           S* __restrict__ hbound, S* __restrict__ hT, int T,
                           int B, int d_in, int period) {
  using hpmn::load_f;
  using hpmn::store_f;
  extern __shared__ float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  float* s_wx = smem;                       // [d_in_pad][96], zero rows
  float* s_wh = smem + d_in_pad * hpmn::kG;  // [32][96]
  for (int i = threadIdx.x; i < d_in_pad * hpmn::kG; i += blockDim.x)
    s_wx[i] = i < d_in * hpmn::kG ? load_f(wx + i) : 0.0f;
  for (int i = threadIdx.x; i < kDm * hpmn::kG; i += blockDim.x)
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
  const long long out_off = (long long)row * kDm + lane;
  const long long row_stride = (long long)B * kDm;  // one time row

  // x_t of this row, raw, a step ahead (gru_chain.cuh::load_x_raw).
  S xr[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) xr[c] = S();
  const S* x_row = x + (long long)row * d_in;
  hpmn::load_x_raw(xr, x_row, true, n_chunks, d_in, lane);

  int to_fire = period;  // steps to the next strided row
  S* hs_out = hs + out_off;
  for (int t = 0; t < T; ++t) {
    if (t % kStrideChunk == 0)
      store_f(hbound + (t / kStrideChunk) * row_stride + out_off, h);
    float xv[kMaxChunks];
    hpmn::convert_x(xr, xv);
    // The next step's loads, before this step's math.
    hpmn::load_x_raw(xr, x_row + (long long)(t + 1) * x_tstride, t + 1 < T,
                     n_chunks, d_in, lane);
    const hpmn::Proj p = hpmn::project(xv, n_chunks, h, s_wx, s_wh, lane);
    if constexpr (hpmn::kIsBf16<S>) {
      hb = hpmn::stride_update(hpmn::gates_bf16(p, b_r, b_z, b_c), hb);
      h = hpmn::to_f(hb);
    } else {
      h = hpmn::stride_update(hpmn::gates_f32(p, b_r, b_z, b_c), h);
    }
    if (--to_fire == 0) {
      store_f(hs_out, h);
      hs_out += row_stride;
      to_fire = period;
    }
  }
  store_f(hT + out_off, h);
}

template <typename S>
int launch(const S* x, long long x_tstride, const S* wx, const S* wh,
           const S* b, const S* h0, S* hs, S* hbound, S* hT, int T, int B,
           int d_in, int period, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1 || period < 2)
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t smem = (size_t)(d_in_pad + kDm) * hpmn::kG * sizeof(float);
  const int grid = (B + kWarps - 1) / kWarps;
  gru_scan_stride_fwd_kernel<S>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          x, x_tstride, wx, wh, b, h0, hs, hbound, hT, T, B, d_in, period);
  return (int)cudaGetLastError();
}

}  // namespace

// The chunk length of the boundary states: the wrapper allocates
// ceil(T / chunk) of them.
extern "C" int hpmn_gru_scan_stride_chunk() { return kStrideChunk; }

// The one-kernel form of K3 and K3-bf16: x [T,B,d_in] (time stride
// x_tstride, rows contiguous), wx [d_in,96], wh [32,96], b [96], h0 [B,32]
// or null, all of one type: float for K3, bf16 for K3-bf16. Writes hs
// [T/period,B,32], hbound [ceil(T/chunk),B,32] and hT [B,32], contiguous,
// of the same type. period >= 2. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int hpmn_gru_scan_stride_fwd(const float* x, long long x_tstride,
                                        const float* wx, const float* wh,
                                        const float* b, const float* h0,
                                        float* hs, float* hbound, float* hT,
                                        int T, int B, int d_in, int period,
                                        void* stream) {
  return launch(x, x_tstride, wx, wh, b, h0, hs, hbound, hT, T, B, d_in,
                period, stream);
}

extern "C" int hpmn_gru_scan_stride_fwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* wh, const __nv_bfloat16* b, const __nv_bfloat16* h0,
    __nv_bfloat16* hs, __nv_bfloat16* hbound, __nv_bfloat16* hT, int T,
    int B, int d_in, int period, void* stream) {
  return launch(x, x_tstride, wx, wh, b, h0, hs, hbound, hT, T, B, d_in,
                period, stream);
}

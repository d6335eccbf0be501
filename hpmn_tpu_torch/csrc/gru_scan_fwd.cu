// GRU scan forward for Hopper (sm_90a): one launch scans one whole layer.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_fwd_kernel (its mask and no-mask
// forms, f32 chain, no AUGRU scale). Per step, for batch row b:
//
//   xp = x_t @ wx + b          (input projection, computed here as in the
//                               TPU kernel, not hoisted out to a library)
//   g  = h @ wh
//   r = sigmoid(xp_r + g_r);  z = sigmoid(xp_z + g_z)
//   c = tanh(xp_c + r * g_c)  (linear before reset)
//   h_cell = h + z * (c - h); h' = h + m_t * (h_cell - h)   (m_t = 1: no mask)
//
// What bounds it: the recurrence. Step t needs h_{t-1}, so one row's T steps
// run one after another and the work per step is small (d_m = 32: 192 FMAs
// per hidden unit for both projections). The kernel is latency-bound, not
// bound by bytes (x and h_seq stream once, 256 B per row and step) or FLOPs.
//
// What the design does about it: the whole time loop runs inside the
// kernel, with the carry in registers, so no launch or device-memory round
// trip sits between steps. One warp owns one batch row and lane j owns hidden
// unit j, so a step needs no block barrier: x_t and h_{t-1} reach every lane
// through __shfl_sync, and wx and wh sit in shared memory, where lane j reads
// column j of each block (consecutive words, no bank conflicts). The next
// step's x row is loaded one step ahead to hide its latency. h_seq is
// written at [t, b, :], 128 contiguous bytes per warp and step.
//
// The TPU kernel's packed [wx_r|wx_z|wx_c|0] / [wh_r|wh_z|0|wh_c] weights
// (a 128-lane trick), its padding of T to a multiple of 8 and its boundary
// states (inputs of the backward kernel only) are not carried over.
//
// Time strides: x and mask are read at x + t*x_tstride and mask +
// t*m_tstride, so the next HPMN layer's input h_seq[period-1::period] is
// passed as a strided view with no copy.

#include <cuda_runtime.h>

namespace {

constexpr int kDm = 32;          // hidden width: one lane per hidden unit
constexpr int kWarps = 4;        // batch rows per block
constexpr int kMaxChunks = 3;    // d_in <= 96: weights fit 48 KB of smem
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void __launch_bounds__(kWarps * 32)
gru_scan_fwd_kernel(const float* __restrict__ x, long long x_tstride,
                    const float* __restrict__ mask, long long m_tstride,
                    const float* __restrict__ wx, const float* __restrict__ wh,
                    const float* __restrict__ bias,
                    const float* __restrict__ h0, float* __restrict__ hseq,
                    int T, int B, int d_in) {
  extern __shared__ float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  float* s_wx = smem;                        // [d_in_pad][3*kDm], zero rows
  float* s_wh = smem + d_in_pad * 3 * kDm;   // [kDm][3*kDm]
  for (int i = threadIdx.x; i < d_in_pad * 3 * kDm; i += blockDim.x)
    s_wx[i] = i < d_in * 3 * kDm ? wx[i] : 0.0f;
  for (int i = threadIdx.x; i < kDm * 3 * kDm; i += blockDim.x)
    s_wh[i] = wh[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave; no barrier follows

  const float b_r = bias[lane];
  const float b_z = bias[kDm + lane];
  const float b_c = bias[2 * kDm + lane];
  float h = h0 != nullptr ? h0[(long long)row * kDm + lane] : 0.0f;

  // x_t of this row, lane k of chunk c holding element 32*c + k.
  float xv[kMaxChunks];
  const float* x_row = x + (long long)row * d_in;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = 32 * c + lane;
    xv[c] = (c < n_chunks && k < d_in && T > 0) ? x_row[k] : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    // Issue the next step's loads before this step's math.
    float xn[kMaxChunks];
    const bool more = t + 1 < T;
    const float* x_next = x_row + (long long)(t + 1) * x_tstride;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int k = 32 * c + lane;
      xn[c] = (more && c < n_chunks && k < d_in) ? x_next[k] : 0.0f;
    }
    const float m = mask != nullptr ? mask[(long long)t * m_tstride + row]
                                    : 1.0f;

    float ar = 0.0f, az = 0.0f, ac = 0.0f;  // x_t @ wx
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < n_chunks) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float xk = __shfl_sync(kFull, xv[c], k);
          const float* w = s_wx + (32 * c + k) * 3 * kDm;
          ar = fmaf(xk, w[lane], ar);
          az = fmaf(xk, w[kDm + lane], az);
          ac = fmaf(xk, w[2 * kDm + lane], ac);
        }
      }
    }
    float gr = 0.0f, gz = 0.0f, gc = 0.0f;  // h @ wh
#pragma unroll
    for (int k = 0; k < kDm; ++k) {
      const float hk = __shfl_sync(kFull, h, k);
      const float* w = s_wh + k * 3 * kDm;
      gr = fmaf(hk, w[lane], gr);
      gz = fmaf(hk, w[kDm + lane], gz);
      gc = fmaf(hk, w[2 * kDm + lane], gc);
    }
    const float r = sigmoid_f((ar + b_r) + gr);
    const float z = sigmoid_f((az + b_z) + gz);
    const float cand = tanhf((ac + b_c) + r * gc);
    const float h_cell = h + z * (cand - h);
    h = h + m * (h_cell - h);
    hseq[((long long)t * B + row) * kDm + lane] = h;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) xv[c] = xn[c];
  }
}

}  // namespace

// x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B] (time
// stride m_tstride) or null, wx [d_in,96], wh [32,96], b [96], h0 [B,32] or
// null, hseq [T,B,32] contiguous. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int hpmn_gru_scan_fwd(const float* x, long long x_tstride,
                                 const float* mask, long long m_tstride,
                                 const float* wx, const float* wh,
                                 const float* b, const float* h0, float* hseq,
                                 int T, int B, int d_in, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t smem = (size_t)(d_in_pad + kDm) * 3 * kDm * sizeof(float);
  const int grid = (B + kWarps - 1) / kWarps;
  gru_scan_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, x_tstride, mask, m_tstride, wx, wh, b, h0, hseq, T, B, d_in);
  return (int)cudaGetLastError();
}

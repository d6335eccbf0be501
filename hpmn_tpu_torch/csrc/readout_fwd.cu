// Additive-attention memory readout forward for Hopper (sm_90a).
//
// Replaces hpmn_tpu/ops/pallas_readout.py::_kernel (f32, no slot mask).
// For batch row b, with memory slots m_l [d_m] and query q [d_q]:
//
//   qp = q @ wq + bias                     [A]
//   s_l = v . tanh(m_l @ wm + qp)          l = 0..L-1
//   alpha = softmax_l(s)  (max-subtracted)
//   read = sum_l alpha_l * m_l             [d_m]
//
// What bounds it: bytes. Per row it reads L*d_m + d_q floats (6*32 + 32 at
// the xlong shape, 896 B) and writes d_m, against about 2*A*(L*d_m + d_q)
// FLOPs (about 14.3k): some 16 FLOP/B, far below the card's ratio, so the
// memory traffic and the launch are the cost.
//
// What the design does about it: one pass, with nothing between the steps
// leaving registers (the [B, L, A] tanh activations a composed version
// writes and re-reads never reach device memory). One warp owns one row:
// lane a owns attention unit a and lane d owns memory feature d (A = d_m =
// 32). Each m_l row is one coalesced 128-byte load; its elements reach every
// lane through __shfl_sync, and wm and wq are read from shared memory at
// column a (conflict-free). s_l is a butterfly warp sum of e_a * v_a, so
// every lane holds all L scores; the softmax runs in registers, and lane d
// writes read[d].

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kA = 32;        // attention width == d_m == warp size
constexpr int kMaxL = 16;     // memory slots held in registers
constexpr int kWarps = 4;     // rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
readout_fwd_kernel(const float* __restrict__ memory,
                   const float* __restrict__ query,
                   const float* __restrict__ wm, const float* __restrict__ wq,
                   const float* __restrict__ bias, const float* __restrict__ v,
                   float* __restrict__ out, int B, int L, int d_q) {
  extern __shared__ float smem[];
  const int d_q_pad = (d_q + 31) / 32 * 32;
  float* s_wm = smem;              // [kA (=d_m)][kA]
  float* s_wq = smem + kA * kA;    // [d_q_pad][kA], zero rows past d_q
  for (int i = threadIdx.x; i < kA * kA; i += blockDim.x) s_wm[i] = wm[i];
  for (int i = threadIdx.x; i < d_q_pad * kA; i += blockDim.x)
    s_wq[i] = i < d_q * kA ? wq[i] : 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;

  // qp[a] = q @ wq[:, a] + bias[a], q broadcast 32 elements at a time.
  float qp = 0.0f;
  const float* q_row = query + (long long)row * d_q;
  for (int k0 = 0; k0 < d_q_pad; k0 += 32) {
    const float qv = k0 + lane < d_q ? q_row[k0 + lane] : 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      qp = fmaf(__shfl_sync(kFull, qv, k), s_wq[(k0 + k) * kA + lane], qp);
  }
  qp += bias[lane];
  const float va = v[lane];

  const float* m_row = memory + (long long)row * L * kA;
  float mv[kMaxL];   // lane d: m_l[d]
  float s[kMaxL];    // every lane: s_l
  float s_max = -CUDART_INF_F;
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) {
    if (l < L) {
      mv[l] = m_row[l * kA + lane];
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < kA; ++d)
        acc = fmaf(__shfl_sync(kFull, mv[l], d), s_wm[d * kA + lane], acc);
      s[l] = warp_sum(tanhf(acc + qp) * va);
      s_max = fmaxf(s_max, s[l]);
    }
  }
  float denom = 0.0f;
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) {
    if (l < L) {
      s[l] = expf(s[l] - s_max);
      denom += s[l];
    }
  }
  float read = 0.0f;
#pragma unroll
  for (int l = 0; l < kMaxL; ++l)
    if (l < L) read = fmaf(s[l] / denom, mv[l], read);
  out[(long long)row * kA + lane] = read;
}

}  // namespace

// memory [B,L,32], query [B,d_q], wm [32,32], wq [d_q,32], b [32], v [32],
// out [B,32], all contiguous f32. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int hpmn_readout_fwd(const float* memory, const float* query,
                                const float* wm, const float* wq,
                                const float* b, const float* v, float* out,
                                int B, int L, int d_q, void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || d_q < 1 || d_q > 256)
    return (int)cudaErrorInvalidValue;
  const int d_q_pad = (d_q + 31) / 32 * 32;
  const size_t smem = (size_t)(kA + d_q_pad) * kA * sizeof(float);
  const int grid = (B + kWarps - 1) / kWarps;
  readout_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      memory, query, wm, wq, b, v, out, B, L, d_q);
  return (int)cudaGetLastError();
}

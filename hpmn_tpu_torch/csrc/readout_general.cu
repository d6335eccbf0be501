// The additive-attention readout forward at any width for Hopper (sm_90a):
// the width-general form of K5 (readout_fwd.cu keeps every A = d_m = 32,
// L <= 16, d_q <= 256 call; ops/cuda_readout.py dispatches every other
// shape here).
//
// Replaces hpmn_tpu/ops/pallas_readout.py::_kernel (f32, no slot mask) at
// the widths that kernel takes from its operands: 1 <= d_m <= 256,
// 1 <= A <= 256, 1 <= L <= 64, 1 <= d_q <= 512. For batch row b, with
// memory slots m_l [d_m] and query q [d_q]:
//
//   qp = q @ wq + bias                     [A]
//   s_l = v . tanh(m_l @ wm + qp)          l = 0..L-1
//   alpha = softmax_l(s)  (max-subtracted)
//   read = sum_l alpha_l * m_l             [d_m]
//
// What bounds it: bytes in the limit (per row L*d_m + d_q floats in, d_m
// out, against 2*A*(L*d_m + d_q) FLOPs), the instructions per row at the
// paths' sizes. The design is the fixed-width kernel's with the widths
// made loops: one warp owns one row; lane i owns attention units a = i,
// i + 32, ... (at most 8) and output features d = i, i + 32, ... (at most
// 8), so the unit loops are unrolled over registers and the widths are
// runtime bounds; L is a runtime loop. The row's memory and query are
// read from device memory as broadcast loads (every lane the same word),
// wm and wq by column (lanes on consecutive words), through L1. Each
// lane's per-unit dot products are fmaf chains over d (over k for qp) from
// 0.0f, the fixed-width kernel's order; a slot's score is the warp's
// shuffle tree of the lanes' sums of tanhf(acc + qp) * v over their units;
// lane 0 keeps the scores in shared memory; the max is taken from -inf
// over l in order, expf of the differences summed over l in order, each
// alpha_l = e_l / denom, and read an fmaf chain over l from 0.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gru_chain.cuh"

namespace {

constexpr int kMaxA = 256, kMaxDm = 256, kMaxL = 64, kMaxDq = 512;
constexpr int kUnits = kMaxA / 32;  // attention units a lane, at most
constexpr int kOuts = kMaxDm / 32;  // output features a lane, at most
constexpr int kWarps = 4;           // rows a block

// memory [B, L, d_m], query [B, d_q], wm [d_m, A], wq [d_q, A], bias [A],
// v [A], out [B, d_m], contiguous f32.
__global__ void __launch_bounds__(kWarps * 32)
readout_gen_kernel(const float* __restrict__ memory,
                   const float* __restrict__ query,
                   const float* __restrict__ wm, const float* __restrict__ wq,
                   const float* __restrict__ bias,
                   const float* __restrict__ v, float* __restrict__ out,
                   int B, int L, int d_m, int A, int d_q) {
  __shared__ float s_s[kWarps][kMaxL];  // the row's scores, then alphas
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= B) return;  // whole warps leave; no block barrier follows
  const float* m_row = memory + row * L * d_m;
  const float* q_row = query + row * d_q;

  float qp[kUnits], va[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int a = lane + 32 * u;
    qp[u] = 0.0f;
    va[u] = 0.0f;
    if (a < A) {
      float acc = 0.0f;
      for (int k = 0; k < d_q; ++k) acc = fmaf(q_row[k], wq[k * A + a], acc);
      qp[u] = acc + bias[a];
      va[u] = v[a];
    }
  }
  float s_max = -CUDART_INF_F;
  for (int l = 0; l < L; ++l) {
    const float* m_l = m_row + l * d_m;
    float part = 0.0f;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int a = lane + 32 * u;
      if (a < A) {
        float acc = 0.0f;
        for (int d = 0; d < d_m; ++d) acc = fmaf(m_l[d], wm[d * A + a], acc);
        part += tanhf(acc + qp[u]) * va[u];
      }
    }
    const float s = hpmn::warp_sum(part);
    if (lane == 0) s_s[warp][l] = s;
    s_max = fmaxf(s_max, s);
  }
  __syncwarp();
  float denom = 0.0f;
  for (int l = 0; l < L; ++l) denom += expf(s_s[warp][l] - s_max);
  __syncwarp();  // every lane has read the scores
  for (int l = lane; l < L; l += 32)
    s_s[warp][l] = expf(s_s[warp][l] - s_max) / denom;
  __syncwarp();
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int d = lane + 32 * o;
    if (d < d_m) {
      float read = 0.0f;
      for (int l = 0; l < L; ++l)
        read = fmaf(s_s[warp][l], m_row[l * d_m + d], read);
      out[row * d_m + d] = read;
    }
  }
}

}  // namespace

// K5-general: memory [B,L,d_m], query [B,d_q], wm [d_m,A], wq [d_q,A], b
// [A], v [A], out [B,d_m], all contiguous f32; 1 <= d_m <= 256, 1 <= A <=
// 256, 1 <= L <= 64, 1 <= d_q <= 512. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int hpmn_readout_gen_fwd(const float* memory, const float* query,
                                    const float* wm, const float* wq,
                                    const float* b, const float* v,
                                    float* out, int B, int L, int d_m, int A,
                                    int d_q, void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || d_m < 1 || d_m > kMaxDm || A < 1
      || A > kMaxA || d_q < 1 || d_q > kMaxDq)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kWarps - 1) / kWarps;
  readout_gen_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      memory, query, wm, wq, b, v, out, B, L, d_m, A, d_q);
  return (int)cudaGetLastError();
}

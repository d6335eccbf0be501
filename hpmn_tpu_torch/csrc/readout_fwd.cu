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
// What bounds it: bytes in the limit. Per row it reads L*d_m + d_q floats
// (6*32 + 32 at the xlong shape, 896 B) and writes d_m, against about
// 2*A*(L*d_m + d_q) FLOPs (about 14.3k): some 16 FLOP/B, far below the
// card's ratio. At the paths' sizes (B = 512 per training step and predict,
// 6400 per rank chunk) the launch and the instructions each row issues set
// the time, so the design cuts those.
//
// One warp owns one row at a time: lane a owns attention unit a and lane d
// memory feature d (A = d_m = 32). What the design does:
//
// - L is a template argument (1..16; hpmn_readout_fwd switches on it), so
//   the slot loops have no branch and the L dot products' fmaf chains
//   interleave.
// - One FFMA per weight: lane a holds wm[:, a] in registers, and wq[:, a]
//   where d_q <= 64 (kQ = 32 or 64 registers; wider d_q reads wq from
//   shared memory, kQ = 0). The row's memory slots and query sit in shared
//   memory, and every lane reads them as broadcast float4s: one LDS.128
//   feeds four FFMAs.
// - Persistent blocks: each block stages wm and wq into shared memory once
//   (cp.async), its warps copy their columns into registers, then take rows
//   in a stride loop. The next row's memory and query are copied by
//   cp.async into a second buffer of the warp while the current row
//   computes.
// - The softmax's expf and each alpha_l = s_l / denom are the same on
//   every lane, so lane l alone computes slot l's, and the others take
//   them by shuffles: one expf and one division a lane, not L.
// - A block has floor(B / SMs) warps, 1 to 4, so that every SM gets rows
//   at small B; at 4 warps the grid is one wave of resident blocks.
//
// Bits: each lane keeps the first form's arithmetic in its order: qp one
// fmaf chain over k (zero terms past d_q, as that form padded to 32),
// then + bias; each score an fmaf chain over d from 0, tanhf(acc + qp) * v
// summed by the same butterfly; the max from -inf over l in order, expf of
// the difference, the denominator summed over l in order, s_l / denom, and
// read an fmaf chain over l from 0. Only where the operands come from
// (registers, shared memory, another lane) and which lane computes a value
// that all lanes share changed.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gru_chain.cuh"

namespace {

constexpr int kA = 32;         // attention width == d_m == warp size
constexpr int kMaxL = 16;      // memory slots, a template argument
constexpr int kMaxDq = 256;
constexpr int kMaxWarps = 4;   // rows in flight per block
constexpr int kSmemFloats = 48 * 1024 / 4;  // no opt-in attribute needed
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Floats of the query in a row buffer, and rows of wq in shared memory:
// kQ, or d_q rounded up to 4 (kQ = 0), zeros past d_q.
__host__ __device__ __forceinline__ int q_floats(int kQ, int d_q) {
  return kQ > 0 ? kQ : (d_q + 3) / 4 * 4;
}

// Shared memory: wm [32][32], wq [q][32], then per warp two row buffers of
// L*32 memory floats and q query floats.
__host__ __device__ __forceinline__ int row_floats(int L, int q) {
  return L * kA + q;
}
__host__ __forceinline__ int smem_floats(int L, int q, int warps) {
  return (kA + q) * kA + warps * 2 * row_floats(L, q);
}

// This lane's share of a row's copies into buf: slot l's word lane, and
// the query's words lane, lane + 32, ...
template <int L>
__device__ __forceinline__ void fetch_row(float* buf, const float* memory,
                                          const float* query, int row,
                                          int d_q, int lane) {
  const float* m_row = memory + (long long)row * L * kA;
#pragma unroll
  for (int l = 0; l < L; ++l)
    hpmn::copy_async(buf + l * kA + lane, m_row + l * kA + lane);
  const float* q_row = query + (long long)row * d_q;
  for (int k = lane; k < d_q; k += 32)
    hpmn::copy_async(buf + L * kA + k, q_row + k);
}

// The minimum of 2 blocks per SM lets ptxas take the registers a row needs
// (133 at L = 6, d_q = 32); without it, it held that kernel to 96 and
// spilled, and the kernel took 3-5% longer.
template <int L, int kQ>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
readout_fwd_kernel(const float* __restrict__ memory,
                   const float* __restrict__ query,
                   const float* __restrict__ wm, const float* __restrict__ wq,
                   const float* __restrict__ bias, const float* __restrict__ v,
                   float* __restrict__ out, int B, int d_q) {
  extern __shared__ __align__(16) float smem[];
  const int q = q_floats(kQ, d_q);
  const int row_len = row_floats(L, q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* s_wm = smem;
  float* s_wq = smem + kA * kA;
  float* bufs = s_wq + q * kA + warp * 2 * row_len;

  // Zeros where no copy writes: wq's rows past d_q, the query past d_q.
  for (int i = d_q * kA + threadIdx.x; i < q * kA; i += blockDim.x)
    s_wq[i] = 0.0f;
  for (int k = d_q + lane; k < q; k += 32)
    bufs[L * kA + k] = bufs[row_len + L * kA + k] = 0.0f;
  for (int i = threadIdx.x; i < kA * kA; i += blockDim.x)
    hpmn::copy_async(s_wm + i, wm + i);
  for (int i = threadIdx.x; i < d_q * kA; i += blockDim.x)
    hpmn::copy_async(s_wq + i, wq + i);
  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  if (row < B) fetch_row<L>(bufs, memory, query, row, d_q, lane);
  hpmn::copy_async_commit();
  if (row + stride < B)
    fetch_row<L>(bufs + row_len, memory, query, row + stride, d_q, lane);
  hpmn::copy_async_commit();
  hpmn::copy_async_wait<1>();  // the weights and this warp's first row
  __syncthreads();

  float wm_r[kA];  // wm[:, lane]
#pragma unroll
  for (int d = 0; d < kA; ++d) wm_r[d] = s_wm[d * kA + lane];
  float wq_r[kQ > 0 ? kQ : 1];  // wq[:, lane], zeros past d_q
#pragma unroll
  for (int k = 0; k < kQ; ++k) wq_r[k] = s_wq[k * kA + lane];
  const float b_a = bias[lane];
  const float va = v[lane];

  for (int it = 0; row < B; ++it, row += stride) {
    float* buf = bufs + (it & 1) * row_len;
    const float4* q4 = reinterpret_cast<const float4*>(buf + L * kA);
    float qp = 0.0f;
    if constexpr (kQ > 0) {
#pragma unroll
      for (int k4 = 0; k4 < kQ / 4; ++k4) {
        const float4 qv = q4[k4];
        qp = fmaf(qv.x, wq_r[4 * k4], qp);
        qp = fmaf(qv.y, wq_r[4 * k4 + 1], qp);
        qp = fmaf(qv.z, wq_r[4 * k4 + 2], qp);
        qp = fmaf(qv.w, wq_r[4 * k4 + 3], qp);
      }
    } else {
      for (int k4 = 0; k4 < q / 4; ++k4) {
        const float4 qv = q4[k4];
        const float* w = s_wq + 4 * k4 * kA + lane;
        qp = fmaf(qv.x, w[0], qp);
        qp = fmaf(qv.y, w[kA], qp);
        qp = fmaf(qv.z, w[2 * kA], qp);
        qp = fmaf(qv.w, w[3 * kA], qp);
      }
    }
    qp += b_a;

    const float4* m4 = reinterpret_cast<const float4*>(buf);
    float s[L];  // lane a's dot product with m_l, then s_l (every lane)
#pragma unroll
    for (int l = 0; l < L; ++l) s[l] = 0.0f;
#pragma unroll
    for (int d4 = 0; d4 < kA / 4; ++d4) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float4 mv = m4[l * (kA / 4) + d4];
        s[l] = fmaf(mv.x, wm_r[4 * d4], s[l]);
        s[l] = fmaf(mv.y, wm_r[4 * d4 + 1], s[l]);
        s[l] = fmaf(mv.z, wm_r[4 * d4 + 2], s[l]);
        s[l] = fmaf(mv.w, wm_r[4 * d4 + 3], s[l]);
      }
    }
    float s_max = -CUDART_INF_F;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      s[l] = warp_sum(tanhf(s[l] + qp) * va);
      s_max = fmaxf(s_max, s[l]);
    }
    // Lane l < L: slot l's exp and alpha, the values every lane would
    // compute alike; the others take them by shuffles, in order over l.
    float e_mine = s[0];
#pragma unroll
    for (int l = 1; l < L; ++l) e_mine = lane == l ? s[l] : e_mine;
    e_mine = expf(e_mine - s_max);
    float denom = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) denom += __shfl_sync(kFull, e_mine, l);
    const float a_mine = e_mine / denom;
    float read = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l)
      read = fmaf(__shfl_sync(kFull, a_mine, l), buf[l * kA + lane], read);
    out[(long long)row * kA + lane] = read;

    __syncwarp();  // every lane is done with buf: refill it two rows on
    if (row + 2 * stride < B)
      fetch_row<L>(buf, memory, query, row + 2 * stride, d_q, lane);
    hpmn::copy_async_commit();
    hpmn::copy_async_wait<1>();  // the next row's group
    __syncwarp();
  }
}

template <int L, int kQ>
int launch(const float* memory, const float* query, const float* wm,
           const float* wq, const float* b, const float* v, float* out,
           int B, int d_q, cudaStream_t stream) {
  const int n_sm = hpmn::sm_count();
  const int q = q_floats(kQ, d_q);
  int warps = B / (n_sm > 0 ? n_sm : 1);
  warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
  const int fit = (kSmemFloats - (kA + q) * kA) / (2 * row_floats(L, q));
  if (warps > fit) warps = fit;
  const size_t smem = (size_t)smem_floats(L, q, warps) * sizeof(float);
  long long grid = ((long long)B + warps - 1) / warps;
  if (warps == kMaxWarps) {  // one wave of resident blocks
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, readout_fwd_kernel<L, kQ>, warps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    const long long wave = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
    if (grid > wave) grid = wave;
  }
  readout_fwd_kernel<L, kQ><<<(int)grid, warps * 32, smem, stream>>>(
      memory, query, wm, wq, b, v, out, B, d_q);
  return (int)cudaGetLastError();
}

template <int kQ>
int launch_l(const float* memory, const float* query, const float* wm,
             const float* wq, const float* b, const float* v, float* out,
             int B, int L, int d_q, cudaStream_t s) {
#define HPMN_READOUT_CASE(n) \
  case n:                    \
    return launch<n, kQ>(memory, query, wm, wq, b, v, out, B, d_q, s);
  switch (L) {
    HPMN_READOUT_CASE(1) HPMN_READOUT_CASE(2) HPMN_READOUT_CASE(3)
    HPMN_READOUT_CASE(4) HPMN_READOUT_CASE(5) HPMN_READOUT_CASE(6)
    HPMN_READOUT_CASE(7) HPMN_READOUT_CASE(8) HPMN_READOUT_CASE(9)
    HPMN_READOUT_CASE(10) HPMN_READOUT_CASE(11) HPMN_READOUT_CASE(12)
    HPMN_READOUT_CASE(13) HPMN_READOUT_CASE(14) HPMN_READOUT_CASE(15)
    HPMN_READOUT_CASE(16)
  }
#undef HPMN_READOUT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// memory [B,L,32], query [B,d_q], wm [32,32], wq [d_q,32], b [32], v [32],
// out [B,32], all contiguous f32; 1 <= L <= 16, 1 <= d_q <= 256. Launches
// on `stream`; returns cudaGetLastError() after the launch.
extern "C" int hpmn_readout_fwd(const float* memory, const float* query,
                                const float* wm, const float* wq,
                                const float* b, const float* v, float* out,
                                int B, int L, int d_q, void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || d_q < 1 || d_q > kMaxDq)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d_q <= 32)
    return launch_l<32>(memory, query, wm, wq, b, v, out, B, L, d_q, s);
  if (d_q <= 64)
    return launch_l<64>(memory, query, wm, wq, b, v, out, B, L, d_q, s);
  return launch_l<0>(memory, query, wm, wq, b, v, out, B, L, d_q, s);
}

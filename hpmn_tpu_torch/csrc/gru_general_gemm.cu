// The tiled products of the width-general GRU scan forms (K1-general's
// and K2-general's; gru_general.cuh has the design).

#include "gru_general.cuh"

namespace hpmn_gen {
namespace {

// ---- The tiled product C (+)= A @ B.
constexpr int kTM = 64, kTN = 64, kTK = 16, kGemmThreads = 256;

// Op supplies ld_a(m, k), ld_b(k, n), init(m, n, z) and store(m, n, z, v),
// and kAKFast (A's element (m, k+1) follows (m, k) in memory: the tile's
// loads walk k fastest) and kBNFast (B's (k, n+1) follows (k, n)). Block
// (x, y, z) computes rows [64x, 64x + 64), columns [64y, 64y + 64) over
// k in [K*z/splits, K*(z+1)/splits).
template <class Op>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const Op op, long long M, int N, long long K, int splits) {
  __shared__ __align__(16) float s_a[kTK][kTM + 4];
  __shared__ __align__(16) float s_b[kTK][kTN + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long m0 = (long long)blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int z = blockIdx.z;
  const long long k_lo = K * z / splits, k_hi = K * (z + 1) / splits;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long m = m0 + ty * 4 + i;
      const int n = n0 + tx * 4 + j;
      acc[i][j] = (m < M && n < N) ? op.init(m, n, z) : 0.0f;
    }
  for (long long k0 = k_lo; k0 < k_hi; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < kTM * kTK / kGemmThreads; ++i) {
      const int e = tid + i * kGemmThreads;
      int mm, kk;
      if (Op::kAKFast) {
        mm = e / kTK;
        kk = e % kTK;
      } else {
        kk = e / kTM;
        mm = e % kTM;
      }
      const long long m = m0 + mm, k = k0 + kk;
      s_a[kk][mm] = (m < M && k < k_hi) ? op.ld_a(m, k) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTN * kTK / kGemmThreads; ++i) {
      const int e = tid + i * kGemmThreads;
      int nn, kk;
      if (Op::kBNFast) {
        kk = e / kTN;
        nn = e % kTN;
      } else {
        nn = e / kTK;
        kk = e % kTK;
      }
      const int n = n0 + nn;
      const long long k = k0 + kk;
      s_b[kk][nn] = (n < N && k < k_hi) ? op.ld_b(k, n) : 0.0f;
    }
    __syncthreads();
    const int kn = k_hi - k0 < kTK ? (int)(k_hi - k0) : kTK;
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s_a[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s_b[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long m = m0 + ty * 4 + i;
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) op.store(m, n, z, acc[i][j]);
    }
}

template <class Op>
int launch_gemm(const Op& op, long long M, int N, long long K, int splits,
                cudaStream_t st) {
  const dim3 grid((unsigned)((M + kTM - 1) / kTM),
                  (unsigned)((N + kTN - 1) / kTN), (unsigned)splits);
  gemm_kernel<Op><<<grid, kGemmThreads, 0, st>>>(op, M, N, K, splits);
  return (int)cudaGetLastError();
}

// The input projection of steps [0, n) of x (x points at the chunk's
// first step): xp [n*B, 3*d_m] f32, row m = t*B + b. f32: x @ wx + b; bf16:
// the r and z blocks x @ wx, the c block bf16(x @ wx_c + b_c) as f32.
template <typename S>
struct ProjOp {
  static constexpr bool kAKFast = true, kBNFast = true;
  const S* x;
  long long x_tstride;
  const S* wx;
  const S* bias;
  float* xp;
  int B, d_in, d_m;
  __device__ float ld_a(long long m, long long k) const {
    const long long t = m / B, b = m - t * B;
    return load_f(x + t * x_tstride + b * d_in + k);
  }
  __device__ float ld_b(long long k, int n) const {
    return load_f(wx + k * 3 * d_m + n);
  }
  __device__ float init(long long, int, int) const { return 0.0f; }
  __device__ void store(long long m, int n, int, float v) const {
    const float bn = load_f(bias + n);
    if constexpr (hpmn::kIsBf16<S>) {
      if (n >= 2 * d_m) v = hpmn::to_f(hpmn::to_b(v + bn));
    } else {
      v = v + bn;
    }
    xp[m * 3 * d_m + n] = v;
  }
};

// The backward's recompute of h @ wh for steps [t0, t0 + n): gh [n*B,
// 3*d_m] f32, from h_prev, the fmaf chain of the forward's recurrence.
template <typename S>
struct HprevOp {
  static constexpr bool kAKFast = true, kBNFast = true;
  const S* h0;
  const S* hseq;
  const S* wh;
  float* gh;
  int t0, B, d_m;
  __device__ float ld_a(long long m, long long k) const {
    const long long t = m / B, b = m - t * B;
    return h_prev(h0, hseq, t0 + t, b, k, B, d_m);
  }
  __device__ float ld_b(long long k, int n) const {
    return load_f(wh + k * 3 * d_m + n);
  }
  __device__ float init(long long, int, int) const { return 0.0f; }
  __device__ void store(long long m, int n, int, float v) const {
    gh[m * 3 * d_m + n] = v;
  }
};

// dx of the chunk's rows m (dx points at the chunk's first step): [dr|dz|dc]
// @ wx^T, rounded once to the stream type. Gate block g, unit k of row m
// is dg[m][k][g].
template <typename S>
struct DxOp {
  static constexpr bool kAKFast = true, kBNFast = false;
  const S* dg;
  const S* wx;
  S* dx;
  int d_in, d_m;
  __device__ float ld_a(long long m, long long k) const {
    const int g = (int)(k / d_m), u = (int)(k - (long long)g * d_m);
    return load_f(dg + (m * d_m + u) * 4 + g);
  }
  __device__ float ld_b(long long k, int n) const {
    return load_f(wx + (long long)n * 3 * d_m + k);
  }
  __device__ float init(long long, int, int) const { return 0.0f; }
  __device__ void store(long long m, int n, int, float v) const {
    store_f(dx + m * d_in + n, v);
  }
};

// The chunk's step t and batch row b of the weight-gradient products' k
// index r over its `steps` steps. Dense (bz = 0, K2-general): r = t*B + b,
// and partial z sums the z-th slice of that order. By batch slice (bz > 0,
// K4-general; bz*splits = B): partial z sums batch rows [z*bz, (z+1)*bz),
// walking the chunk's steps from the last to the first, r = (z*steps +
// steps-1-t)*bz + b - z*bz; the chunks run from the last to the first, so
// each output of a partial is one fmaf chain over its rows' steps in
// reverse, whatever the chunk length. Its divisions are 32-bit (a chunk's
// steps*B rows stay below 2^32, which gen_stride_bwd checks): the loads
// of a tile run two per element, and a 64-bit division costs several
// times a 32-bit one.
__device__ __forceinline__ void chunk_step(long long r, int B, int steps,
                                           int bz, long long& t,
                                           long long& b) {
  if (bz == 0) {
    t = r / B;
    b = r - t * B;
    return;
  }
  const unsigned ur = (unsigned)r, ubz = (unsigned)bz;
  const unsigned span = (unsigned)steps * ubz;
  const unsigned z = ur / span, rem = ur - z * span, q = rem / ubz;
  t = steps - 1 - (long long)q;
  b = (long long)(z * ubz + (rem - q * ubz));
}

// The x half of the weight gradients and db, summed over the chunk's rows r
// (GEMM k): row u < d_in of dwx_part[z] += x_r[u] [dr|dz|dc]_r, and u =
// d_in (a row of ones) db_part[z] += [dr|dz|dc]_r. `first`: start from 0.
template <typename S>
struct WxGradOp {
  static constexpr bool kAKFast = false, kBNFast = true;
  const S* x;
  long long x_tstride;
  const S* dg;
  float* dwx_part;
  float* db_part;
  bool first;
  int t0, B, d_in, d_m, steps, bz;
  __device__ float ld_a(long long u, long long r) const {
    if (u == d_in) return 1.0f;
    long long t, b;
    chunk_step(r, B, steps, bz, t, b);
    return load_f(x + (t0 + t) * x_tstride + b * d_in + u);
  }
  __device__ float ld_b(long long r, int n) const {
    const int g = n / d_m, k = n - g * d_m;
    long long t, b;
    chunk_step(r, B, steps, bz, t, b);
    return load_f(dg + ((t * B + b) * d_m + k) * 4 + g);
  }
  __device__ float* at(long long u, int n, int z) const {
    const long long G = 3 * d_m;
    return u < d_in ? dwx_part + ((long long)z * d_in + u) * G + n
                    : db_part + (long long)z * G + n;
  }
  __device__ float init(long long u, int n, int z) const {
    return first ? 0.0f : *at(u, n, z);
  }
  __device__ void store(long long u, int n, int z, float v) const {
    *at(u, n, z) = v;
  }
};

// The h half: dwh_part[z][u] += h_prev_r[u] [dr|dz|dc*r]_r.
template <typename S>
struct WhGradOp {
  static constexpr bool kAKFast = false, kBNFast = true;
  const S* h0;
  const S* hseq;
  const S* dg;
  float* dwh_part;
  bool first;
  int t0, B, d_m, steps, bz;
  __device__ float ld_a(long long u, long long r) const {
    long long t, b;
    chunk_step(r, B, steps, bz, t, b);
    return h_prev(h0, hseq, t0 + t, b, u, B, d_m);
  }
  __device__ float ld_b(long long r, int n) const {
    const int g = n / d_m, k = n - g * d_m;
    long long t, b;
    chunk_step(r, B, steps, bz, t, b);
    return load_f(dg + ((t * B + b) * d_m + k) * 4 + (g < 2 ? g : 3));
  }
  __device__ float* at(long long u, int n, int z) const {
    return dwh_part + ((long long)z * d_m + u) * 3 * d_m + n;
  }
  __device__ float init(long long u, int n, int z) const {
    return first ? 0.0f : *at(u, n, z);
  }
  __device__ void store(long long u, int n, int z, float v) const {
    *at(u, n, z) = v;
  }
};

}  // namespace

template <typename S>
int launch_proj(const S* x, long long x_tstride, const S* wx, const S* b,
                float* xp, long long rows, int B, int d_in, int d_m,
                cudaStream_t st) {
  return launch_gemm(ProjOp<S>{x, x_tstride, wx, b, xp, B, d_in, d_m}, rows,
                     3 * d_m, d_in, 1, st);
}

template <typename S>
int launch_hprev(const S* h0, const S* hseq, const S* wh, float* gh, int t0,
                 long long rows, int B, int d_m, cudaStream_t st) {
  return launch_gemm(HprevOp<S>{h0, hseq, wh, gh, t0, B, d_m}, rows,
                     3 * d_m, d_m, 1, st);
}

template <typename S>
int launch_dx(const S* dg, const S* wx, S* dx, long long rows, int d_in,
              int d_m, cudaStream_t st) {
  return launch_gemm(DxOp<S>{dg, wx, dx, d_in, d_m}, rows, d_in, 3 * d_m, 1,
                     st);
}

template <typename S>
int launch_wgrad(const S* x, long long x_tstride, const S* h0, const S* hseq,
                 const S* dg, float* dwx_part, float* dwh_part,
                 float* db_part, bool first, int t0, long long rows,
                 int splits, int B, int d_in, int d_m, bool by_batch,
                 cudaStream_t st) {
  const int steps = (int)(rows / B);
  const int bz = by_batch ? B / splits : 0;
  const int code = launch_gemm(
      WxGradOp<S>{x, x_tstride, dg, dwx_part, db_part, first, t0, B, d_in,
                  d_m, steps, bz},
      d_in + 1, 3 * d_m, rows, splits, st);
  if (code != 0) return code;
  return launch_gemm(WhGradOp<S>{h0, hseq, dg, dwh_part, first, t0, B, d_m,
                                 steps, bz},
                     d_m, 3 * d_m, rows, splits, st);
}

#define HPMN_GEN_PRODUCTS(S)                                              \
  template int launch_proj<S>(const S*, long long, const S*, const S*,    \
                              float*, long long, int, int, int,           \
                              cudaStream_t);                              \
  template int launch_hprev<S>(const S*, const S*, const S*, float*, int, \
                               long long, int, int, cudaStream_t);        \
  template int launch_dx<S>(const S*, const S*, S*, long long, int, int,  \
                            cudaStream_t);                                \
  template int launch_wgrad<S>(const S*, long long, const S*, const S*,   \
                               const S*, float*, float*, float*, bool,    \
                               int, long long, int, int, int, int, bool,  \
                               cudaStream_t);
HPMN_GEN_PRODUCTS(float)
HPMN_GEN_PRODUCTS(__nv_bfloat16)
#undef HPMN_GEN_PRODUCTS

}  // namespace hpmn_gen

// The tiled products of the width-general GRU scan forms (K1-general's to
// K4-general's; gru_general.cuh has the design).
//
// Two kernels, both f32 CUDA-core products whose every output is one fmaf
// chain from its start value over k in ascending order, so the bits do not
// depend on the tile shapes:
//
// - tall_kernel: C = A @ B for a chunk's rows (M = rows, up to millions;
//   N = 3*d_m or d_in; K = d_in, d_m or 3*d_m): the input projection, the
//   backward's h_prev @ wh and dx. 128 x 64 outputs a block, 256 threads
//   of 8 x 4, so each k's three float4 loads from shared memory feed 32
//   FMAs.
// - wgrad_kernel: the weight-gradient partials, long-K (a slice of the
//   chunk's rows) and small M x N (d_in and d_m rows by 3*d_m columns). The
//   partial counts fix the grid's z, and each output's chain runs in one
//   block, so the outputs alone give the parallelism: 32 rows by 32 units
//   (all three gate columns of each) a block, 128 threads of 8 rows x one
//   unit's three gates, a warp 32 rows by 8 units so that its shared-memory
//   reads stay one wavefront each. One grid holds the x half's tiles (and
//   db, on the first x tile) and the h half's, so each tile reads a unit's
//   gate gradients as one 16-byte (bf16: 8-byte) load and uses three of
//   its four values.
//
// Both stage k-tiles (16 deep, the weight gradients' 32) through shared
// memory in two buffers: the next tile's global loads are in flight in
// registers (converted to f32 there) while the current tile's FMAs run,
// then stored into the other buffer, one barrier a tile. A row's pointers
// are computed once per block (tall) or once per tile row by one lane
// (wgrad, a 32-bit division by a launch-constant divisor as a
// multiply-high, FastDiv), never per element.

#include <cstdint>

#include "gru_general.cuh"

namespace hpmn_gen {
namespace {

constexpr int kBK = 16;  // the k-tile's depth

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s, the magic number m and
// shift s of a divisor d fixed for a launch (d >= 1).
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ULL << s) < d) ++s;
  const unsigned long long m = ((1ULL << 32) * ((1ULL << s) - d)) / d + 1;
  return FastDiv{d, (unsigned)m, s};
}

// Four consecutive outputs of a row, where they lie 16-byte (bf16:
// 8-byte) aligned.
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---- The tall products: rows [m0, m0 + 128) by columns [n0, n0 + 64).
constexpr int kTM = 128, kTN = 64, kTallThreads = 256;

// Op supplies a_row(m) (the pointer of A's row m, or null for a row of
// zeros), a_col(k) (the offset of A's element k in a row), ld_b(k, n),
// out_row(m) (C's row m), col(n) (a value per column, read once: the
// projection's bias) and out(n, v, col(n)) (the value stored for the sum
// v), kBKFast (B's (k+1, n) follows (k, n) in memory: the tile's B
// loads walk k fastest, else n) and kMinBlocks (the blocks an SM holds at
// once: 3 caps the registers at 85, which only the projection takes
// without spilling). Block i runs column tile i % n_nt of row
// tile i / n_nt, so the blocks that read the same rows of A run side by
// side. `vec`: N % 4 == 0 and C 16-byte (bf16: 8-byte) aligned.
template <class Op>
__global__ void __launch_bounds__(kTallThreads, Op::kMinBlocks)
tall_kernel(const Op op, int M, int N, int K, int n_nt, bool vec) {
  using S = typename Op::S;
  __shared__ __align__(16) float s_a[2][kBK][kTM + 4];
  __shared__ __align__(16) float s_b[2][kBK][kTN + 4];
  __shared__ const S* s_rows[kTM];
  // Thread (ty, tx) of a 16 x 16 grid sums rows 8ty.. and columns 4tx..;
  // a warp is 4 x 8 of it, so a k-step's shared-memory reads are 4 and 8
  // distinct float4s, one wavefront each.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int m0 = (int)(blockIdx.x / n_nt) * kTM;
  const int n0 = (int)(blockIdx.x % n_nt) * kTN;
  // The loads: A's row a_mm + 16i at k-offset a_kk (k fastest); B's
  // (b_kk + 4i, b_nn) or, k fastest, (b_kk, b_nn + 16i).
  const int a_kk = tid % 16, a_mm = tid / 16;
  const int b_kk = Op::kBKFast ? tid % 16 : tid / 64;
  const int b_nn = Op::kBKFast ? tid / 16 : tid % 64;
  if (tid < kTM) s_rows[tid] = m0 + tid < M ? op.a_row(m0 + tid) : nullptr;
  __syncthreads();
  float ra[kTM / 16], rb[kTN * kBK / kTallThreads];
  auto fetch = [&](int k0) {
    const int k = k0 + a_kk;
    const int col = k < K ? op.a_col(k) : 0;
#pragma unroll
    for (int i = 0; i < kTM / 16; ++i) {
      const S* row = s_rows[a_mm + 16 * i];
      ra[i] = (k < K && row != nullptr) ? load_f(row + col) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTN * kBK / kTallThreads; ++i) {
      const int kb = k0 + b_kk + (Op::kBKFast ? 0 : 4 * i);
      const int n = n0 + b_nn + (Op::kBKFast ? 16 * i : 0);
      rb[i] = (kb < K && n < N) ? op.ld_b(kb, n) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kTM / 16; ++i) s_a[buf][a_kk][a_mm + 16 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < kTN * kBK / kTallThreads; ++i) {
      if (Op::kBKFast)
        s_b[buf][b_kk][b_nn + 16 * i] = rb[i];
      else
        s_b[buf][b_kk + 4 * i][b_nn] = rb[i];
    }
  };
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  auto step = [&](int buf, int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s_a[buf][kk][ty * 8]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&s_a[buf][kk][ty * 8 + 4]);
    const float4 b4 = *reinterpret_cast<const float4*>(&s_b[buf][kk][tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  };
  const int n_tiles = (K + kBK - 1) / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) fetch((t + 1) * kBK);
    const int kn = K - t * kBK;
    if (kn >= kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) step(buf, kk);
    } else {
      for (int kk = 0; kk < kn; ++kk) step(buf, kk);
    }
    if (t + 1 < n_tiles) stash(buf ^ 1);
    __syncthreads();
  }
  const int nt = n0 + tx * 4;
  float cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cv[j] = nt + j < N ? op.col(nt + j) : 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M || nt >= N) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = op.out(nt + j, acc[i][j], cv[j]);
    auto* row = op.out_row(m) + nt;
    if (vec && nt + 4 <= N) {
      store4(row, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nt + j < N) store_f(row + j, v[j]);
    }
  }
}

template <class Op>
int launch_tall(const Op& op, long long M, int N, int K, cudaStream_t st) {
  if (M >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long n_mt = (M + kTM - 1) / kTM;
  const int n_nt = (N + kTN - 1) / kTN;
  const auto* c = op.out_row(0);
  const bool vec = N % 4 == 0
                   && reinterpret_cast<uintptr_t>(c) % (4 * sizeof(*c)) == 0;
  tall_kernel<Op><<<(unsigned)(n_mt * n_nt), kTallThreads, 0, st>>>(
      op, (int)M, N, K, n_nt, vec);
  return (int)cudaGetLastError();
}

// The input projection of steps [0, n) of x (x points at the chunk's
// first step): xp [n*B, 3*d_m] f32, row m = t*B + b. f32: x @ wx + b; bf16:
// the r and z blocks x @ wx, the c block bf16(x @ wx_c + b_c) as f32.
template <typename S_>
struct ProjOp {
  using S = S_;
  static constexpr bool kBKFast = false;
  static constexpr int kMinBlocks = 3;
  const S* x;
  long long x_tstride;
  const S* wx;
  const S* bias;
  float* xp;
  FastDiv B;
  int d_in, d_m;
  __device__ const S* a_row(int m) const {
    const unsigned t = B.div((unsigned)m), b = (unsigned)m - t * B.d;
    return x + t * x_tstride + (long long)b * d_in;
  }
  __device__ int a_col(int k) const { return k; }
  __device__ float ld_b(int k, int n) const {
    return load_f(wx + (long long)k * 3 * d_m + n);
  }
  __host__ __device__ float* out_row(int m) const {
    return xp + (long long)m * 3 * d_m;
  }
  __device__ float col(int n) const { return load_f(bias + n); }
  __device__ float out(int n, float v, float bn) const {
    if constexpr (hpmn::kIsBf16<S>)
      return n >= 2 * d_m ? hpmn::to_f(hpmn::to_b(v + bn)) : v;
    else
      return v + bn;
  }
};

// The backward's recompute of h @ wh for steps [t0, t0 + n): gh [n*B,
// 3*d_m] f32, from h_prev, the fmaf chain of the forward's recurrence.
template <typename S_>
struct HprevOp {
  using S = S_;
  static constexpr bool kBKFast = false;
  static constexpr int kMinBlocks = 2;
  const S* h0;
  const S* hseq;
  const S* wh;
  float* gh;
  FastDiv B;
  int t0, d_m;
  __device__ const S* a_row(int m) const {
    const unsigned t = B.div((unsigned)m), b = (unsigned)m - t * B.d;
    return h_prev_row(h0, hseq, t0 + (int)t, (int)b, (int)B.d, d_m);
  }
  __device__ int a_col(int k) const { return k; }
  __device__ float ld_b(int k, int n) const {
    return load_f(wh + (long long)k * 3 * d_m + n);
  }
  __host__ __device__ float* out_row(int m) const {
    return gh + (long long)m * 3 * d_m;
  }
  __device__ float col(int) const { return 0.0f; }
  __device__ float out(int, float v, float) const { return v; }
};

// dx of the chunk's rows m (dx points at the chunk's first step): [dr|dz|dc]
// @ wx^T, rounded once to the stream type. k = g*d_m + u (gate block g,
// unit u) is dg[m][u][g]; the chain runs over the r block's units, then
// z's, then c's, so a k-tile reads one gate of each unit's quad.
template <typename S_>
struct DxOp {
  using S = S_;
  static constexpr bool kBKFast = true;
  static constexpr int kMinBlocks = 2;
  const S* dg;
  const S* wx;
  S* dx;
  int d_in, d_m;
  __device__ const S* a_row(int m) const {
    return dg + (long long)m * d_m * 4;
  }
  __device__ int a_col(int k) const {
    const int g = k / d_m;
    return (k - g * d_m) * 4 + g;
  }
  __device__ float ld_b(int k, int n) const {
    return load_f(wx + (long long)n * 3 * d_m + k);
  }
  __host__ __device__ S* out_row(int m) const {
    return dx + (long long)m * d_in;
  }
  __device__ float col(int) const { return 0.0f; }
  __device__ float out(int, float v, float) const { return v; }
};

// ---- The weight-gradient partials: a block holds 32 rows by 32 units
// (their three gate columns each), 4 warps of 32 rows by 8 units, a thread
// 8 rows of one unit. A warp's k-step reads 4 distinct float4s of A and 8
// of B from shared memory, one wavefront each, for 24 FMAs a lane.
constexpr int kWM = 32, kWU = 32, kWThreads = 128, kWK = 32;

// A unit's gate gradients dr, dz, dc, dc*r as f32 (one 16- or 8-byte load).
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// The chunk's rows r (the k of the products) over its `steps` steps, and
// the partials: row u < d_in of dwx_part[z] += x_r[u] [dr|dz|dc]_r, db_part[z]
// += [dr|dz|dc]_r (a row of ones, fmaf(1, ., .)), row u of dwh_part[z] +=
// h_prev_r[u] [dr|dz|dc*r]_r, over the z-th slice [K*z/splits,
// K*(z+1)/splits) of the rows, from 0 where `first`, else from the
// partial's value. Dense (by_batch false, K2-general): r = t*B + b. By batch
// slice (K4-general; bz*splits = B): partial z sums batch rows [z*bz,
// (z+1)*bz), walking the chunk's steps from the last to the first, r =
// (z*steps + steps-1-t)*bz + b - z*bz; the chunks run from the last to the
// first, so each output of a partial is one fmaf chain over its rows'
// steps in reverse, whatever the chunk length.
template <typename S>
struct WgradOp {
  const S* x;
  long long x_tstride;
  const S* h0;
  const S* hseq;
  const S* dg;
  float* dwx_part;
  float* dwh_part;
  float* db_part;
  FastDiv B, bz;  // bz: the batch slice (by batch), or unused
  bool first, by_batch;
  int t0, d_in, d_m, steps, splits, K;
  __device__ void row(int r, int z, int& t, int& b) const {
    if (!by_batch) {
      t = (int)B.div((unsigned)r);
      b = r - t * (int)B.d;
      return;
    }
    const unsigned rl = (unsigned)r - (unsigned)z * (unsigned)steps * bz.d;
    const unsigned q = bz.div(rl);
    t = steps - 1 - (int)q;
    b = (int)(z * bz.d + (rl - q * bz.d));
  }
};

// Block (x, y, z): tile x of the x half's rows (x < nx: dwx rows [32x,
// 32x + 32)) or of the h half's (dwh rows [32(x - nx), ...)), units [32y,
// 32y + 32) of all three gate blocks, partial z. Lane l of warp w holds
// rows [8(l / 8), + 8) of the tile for unit 32y + 8w + l % 8; in the first
// x tile the lanes of rows 0-7 also sum db. A k-tile is kWK of the
// partial's rows: warp w loads rows w + 4i (lane l: A's element u0 + l,
// unit 32y + l's quad), whose pointers lane i finds and the warp shares.
template <typename S>
__global__ void __launch_bounds__(kWThreads)
wgrad_kernel(const WgradOp<S> op, int nx) {
  __shared__ __align__(16) float s_a[2][kWK][kWM];
  __shared__ __align__(16) float4 s_b[2][kWK][kWU];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool h_half = (int)blockIdx.x >= nx;
  const int u0 = (h_half ? (int)blockIdx.x - nx : (int)blockIdx.x) * kWM;
  const int rows_a = h_half ? op.d_m : op.d_in;
  const int unit = blockIdx.y * kWU + lane;  // the loads'
  const int ry = lane / 8, uc = warp * 8 + lane % 8;  // the sums'
  const int my_unit = blockIdx.y * kWU + uc;
  const int z = blockIdx.z;
  const int G = 3 * op.d_m;
  const int k_lo = (int)((long long)op.K * z / op.splits);
  const int k_hi = (int)((long long)op.K * (z + 1) / op.splits);
  const bool db = !h_half && blockIdx.x == 0 && ry == 0;
  float* out = h_half ? op.dwh_part + (long long)z * op.d_m * G
                      : op.dwx_part + (long long)z * op.d_in * G;
  float acc[8][3], acc_db[3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = u0 + ry * 8 + i;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      acc[i][g] = (op.first || u >= rows_a || my_unit >= op.d_m)
                      ? 0.0f
                      : out[(long long)u * G + g * op.d_m + my_unit];
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
    acc_db[g] = (op.first || !db || my_unit >= op.d_m)
                    ? 0.0f
                    : op.db_part[(long long)z * G + g * op.d_m + my_unit];
  constexpr int kRows = kWK / 4;  // a warp's rows of a k-tile
  float ra[kRows];
  float4 rb[kRows];
  auto fetch = [&](int k0) {
    // Lane i < kRows: row k0 + warp + 4i's A row (x, or h_prev, or null
    // for zeros) and gate-gradient row (null past the slice).
    unsigned long long pa = 0, pg = 0;
    const int r_own = k0 + warp + 4 * (lane % kRows);
    if (lane < kRows && r_own < k_hi) {
      int t, b;
      op.row(r_own, z, t, b);
      pa = reinterpret_cast<unsigned long long>(
          h_half ? h_prev_row(op.h0, op.hseq, op.t0 + t, b, (int)op.B.d,
                              op.d_m)
                 : op.x + (long long)(op.t0 + t) * op.x_tstride
                       + (long long)b * op.d_in);
      pg = reinterpret_cast<unsigned long long>(
          op.dg + ((long long)t * op.B.d + b) * op.d_m * 4);
    }
    const int u = u0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const S* a_row = reinterpret_cast<const S*>(__shfl_sync(
          hpmn::kFull, pa, i));
      const S* g_row = reinterpret_cast<const S*>(__shfl_sync(
          hpmn::kFull, pg, i));
      ra[i] = (a_row != nullptr && u < rows_a) ? load_f(a_row + u) : 0.0f;
      rb[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g_row != nullptr && unit < op.d_m) {
        rb[i] = load_quad(g_row + unit * 4);
        if (h_half) rb[i].z = rb[i].w;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s_a[buf][warp + 4 * i][lane] = ra[i];
      s_b[buf][warp + 4 * i][lane] = rb[i];
    }
  };
  auto step = [&](int buf, int kk) {
    const float4 a0 =
        *reinterpret_cast<const float4*>(&s_a[buf][kk][ry * 8]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&s_a[buf][kk][ry * 8 + 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float4 q = s_b[buf][kk][uc];
    const float b[3] = {q.x, q.y, q.z};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[i][g] = fmaf(a[i], b[g], acc[i][g]);
    if (db) {
#pragma unroll
      for (int g = 0; g < 3; ++g) acc_db[g] = fmaf(1.0f, b[g], acc_db[g]);
    }
  };
  const int n_tiles = (k_hi - k_lo + kWK - 1) / kWK;
  if (n_tiles > 0) {
    fetch(k_lo);
    stash(0);
  }
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int k0 = k_lo + t * kWK;
    if (t + 1 < n_tiles) fetch(k0 + kWK);
    const int kn = k_hi - k0;
    if (kn >= kWK) {
#pragma unroll
      for (int kk = 0; kk < kWK; ++kk) step(buf, kk);
    } else {
      for (int kk = 0; kk < kn; ++kk) step(buf, kk);
    }
    if (t + 1 < n_tiles) stash(buf ^ 1);
    __syncthreads();
  }
  if (my_unit >= op.d_m) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = u0 + ry * 8 + i;
    if (u >= rows_a) continue;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      out[(long long)u * G + g * op.d_m + my_unit] = acc[i][g];
  }
  if (db) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
      op.db_part[(long long)z * G + g * op.d_m + my_unit] = acc_db[g];
  }
}

}  // namespace

template <typename S>
int launch_proj(const S* x, long long x_tstride, const S* wx, const S* b,
                float* xp, long long rows, int B, int d_in, int d_m,
                cudaStream_t st) {
  return launch_tall(
      ProjOp<S>{x, x_tstride, wx, b, xp, fast_div((unsigned)B), d_in, d_m},
      rows, 3 * d_m, d_in, st);
}

template <typename S>
int launch_hprev(const S* h0, const S* hseq, const S* wh, float* gh, int t0,
                 long long rows, int B, int d_m, cudaStream_t st) {
  return launch_tall(
      HprevOp<S>{h0, hseq, wh, gh, fast_div((unsigned)B), t0, d_m}, rows,
      3 * d_m, d_m, st);
}

template <typename S>
int launch_dx(const S* dg, const S* wx, S* dx, long long rows, int d_in,
              int d_m, cudaStream_t st) {
  return launch_tall(DxOp<S>{dg, wx, dx, d_in, d_m}, rows, d_in, 3 * d_m,
                     st);
}

template <typename S>
int launch_wgrad(const S* x, long long x_tstride, const S* h0, const S* hseq,
                 const S* dg, float* dwx_part, float* dwh_part,
                 float* db_part, bool first, int t0, long long rows,
                 int splits, int B, int d_in, int d_m, bool by_batch,
                 cudaStream_t st) {
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int steps = (int)(rows / B);
  const unsigned bz = by_batch ? (unsigned)(B / splits) : 1u;
  const WgradOp<S> op{x, x_tstride, h0, hseq, dg, dwx_part, dwh_part,
                      db_part, fast_div((unsigned)B), fast_div(bz), first,
                      by_batch, t0, d_in, d_m, steps, splits, (int)rows};
  const int nx = (d_in + kWM - 1) / kWM, nh = (d_m + kWM - 1) / kWM;
  const dim3 grid((unsigned)(nx + nh), (unsigned)((d_m + kWU - 1) / kWU),
                  (unsigned)splits);
  wgrad_kernel<S><<<grid, kWThreads, 0, st>>>(op, nx);
  return (int)cudaGetLastError();
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

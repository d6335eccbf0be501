// The dx and weight-gradient pass of K2, K2-scale and K4 (and of their
// bf16 forms) for Hopper (sm_90a): the products of the scan backward that
// read only a step's gate gradients, taken out of its reverse loop (the
// recurrences of gru_scan_bwd.cu and gru_scan_stride_bwd.cu write those
// gradients, chunk by chunk, into the workspace this pass reads).
//
// Replaces, with those recurrences, hpmn_tpu/ops/pallas_gru.py::_bwd_kernel
// (with and without the gate scale: the scale forms' dz carries a_t
// already) and ::_bwd_stride_kernel, in f32 and with dtype=bfloat16: the
// TPU kernels compute dx and the weight gradients inside their time loops.
// Its plain version is ops/gru.py::gru_bwd_pass.
//
// Per chunk [t0, t0 + n) and batch row b, from the gate gradients dg[t, b]
// (lane k's dr, dz, dc and dc*r side by side), x_t, and h_prev (K2:
// h_seq[t-1], h0 or zeros at t = 0; K4: the h_prev its recurrence wrote
// beside dg):
//
//   dx_t = [dr|dz|dc] @ wx^T                     (stream type, rounded once)
//   dWx_b += x_t^T [dr|dz|dc];  dWh_b += h_prev^T [dr|dz|dc*r];
//   db_b += [dr|dz|dc]                           (f32, t descending)
//
// then, after the last chunk (launch_wgrad_partials), one f32 partial per
// group of rows.
//
// Bits: every output is the one-kernel loop's (the loop that K2 and
// K2-scale once ran; for K4, gru_scan_stride_bwd_kernel, whose products
// and sums are the same, grouped by its own rows per block).
// dx[t, b, i] is its fmaf chain from 0.0f over k =
// 0..31 of dr_k*wx[i][k], dz_k*wx[i][32+k], dc_k*wx[i][64+k]. A row's sums
// are its warp's accumulators there: acc = fmaf(u, d, acc) from 0.0f over
// t descending, no step skipped (a masked step adds its zero gradients); db
// a plain add. They cross chunks in f32, in `acc`. The partials sum the
// rows of one of that kernel's blocks in its warp order, 0.0f + row 0 + row
// 1 + ...; a row past B adds nothing (its slice there was zeros, and a sum
// from +0.0f is never -0.0f, so adding +0.0f changes no bit). No tensor
// cores: TF32, or bf16 products rounded otherwise, would change the bits.
//
// What bounds it: per row-step at d_in = 32 it does 9216 FMAs (dx, dWx and
// dWh, 3072 each) and moves 896 bytes in f32 (x, h_prev and dg read, dx
// written), 448 in bf16: about the card's 20 FLOPs per byte of HBM in f32,
// operations in bf16. What the design does about it: one block of 8 warps
// per batch row and chunk, walking the chunk's steps down in tiles of
// kTile. A tile is staged in shared memory (u = [x_t | h_prev] in f32, dg
// as one float4 per step and k), one of two buffers, behind one barrier:
// the next tile's global loads are issued into registers before this tile
// is computed and stored after it, so their latency hides behind the FMAs
// (loaded and stored one by one they took 1.47 ms alone at T = 1000,
// PERF.md). The operands of the FMAs come from registers and from 16-byte
// shared-memory loads.
//
// - Weight gradients: thread (warp w, lane j) owns rows rho = 8*ii + w of u
//   (d_in_pad + 32 rows) and columns j, 32+j, 64+j, 3*RW accumulators in
//   registers. Per step: one float4 of dg (lane j's, conflict-free), RW/4
//   broadcast float4 loads of u, 3*RW FMAs. The rows are dealt round-robin
//   so that whether a row is x's (column c takes dc) or h_prev's (dc*r) is
//   known at compile time: rho < d_in_pad exactly when ii < 4*n_chunks.
//   In shared memory row rho of a step sits at (rho % 8)*RW + rho/8, so a
//   warp's rows are contiguous.
// - dx: thread (w, j) owns outputs i = 32c + j and steps w, w+8, w+16, w+24
//   of the tile; per k, 3 conflict-free loads of wx^T per 32-chunk of d_in
//   and four broadcast float4 loads of dg feed 12 FMAs per chunk.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kG;
using hpmn::load_f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                      // steps staged at a time
constexpr int kStepsPerWarp = kTile / kWarps;  // dx: steps per thread

// Shared memory in floats: wx^T [96][d_in_pad], then two buffers of a
// tile's u [kTile][R] (R = d_in_pad + 32) and dg [kTile][32][4].
template <int NC>
__host__ __device__ constexpr size_t tile_floats() {
  return (size_t)kTile * (32 * NC + kDm) + (size_t)kTile * 4 * kDm;
}
template <int NC>
__host__ __device__ constexpr size_t smem_floats() {
  return (size_t)kG * 32 * NC + 2 * tile_floats<NC>();
}

// NC: d_in's 32-chunks, 1 to 3. dg [n, B, 32, 4] holds the chunk's steps;
// h_prev of step t >= hp_t0 is hprev[t - hp_t0] ([., B, 32]), of an
// earlier step h0 (or zeros); acc [B, (d_in_pad + 33) * 96]: per row,
// [rho][96] for rho < d_in_pad + 32 (x's rows, zero past d_in, then
// h_prev's), then db [96].
template <typename S, int NC>
__global__ void __launch_bounds__(kThreads)
gru_bwd_pass_kernel(const S* __restrict__ x, long long x_tstride,
                    const S* __restrict__ wx, const S* __restrict__ h0,
                    const S* __restrict__ hprev, int hp_t0,
                    const S* __restrict__ dg, S* __restrict__ dx,
                    float* __restrict__ acc, int t0, int n, bool first,
                    int B, int d_in) {
  constexpr int kPad = 32 * NC;   // d_in_pad
  constexpr int R = kPad + kDm;   // rows of u
  constexpr int RW = R / kWarps;  // rows per warp: 8, 12 or 16
  constexpr int kXRows = 4 * NC;  // ii < kXRows: x's rows
  extern __shared__ __align__(16) float smem[];
  constexpr int kUPer = kTile * R / kThreads;    // u values per thread
  constexpr int kGPer = kTile * kDm / kThreads;  // dg float4 per thread
  float* s_wxT = smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  float* acc_row = acc + row * (R + 1) * kG;

  // A tile's staging: fetch() issues every global load of steps [lo, lo +
  // ts) into registers, commit() stores them into one of the two buffers.
  // The next tile's loads are in flight while this tile is computed.
  float pu[kUPer];
  float4 pg[kGPer];
  auto fetch = [&](int lo, int ts) {
#pragma unroll
    for (int i = 0; i < kUPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int s = e / R, rho = e - s * R, t = lo + s;
      float v = 0.0f;
      if (s < ts) {
        if (rho < kPad) {
          if (rho < d_in) v = load_f(x + t * x_tstride + row * d_in + rho);
        } else if (t >= hp_t0) {
          v = load_f(hprev + ((long long)(t - hp_t0) * B + row) * kDm + rho
                     - kPad);
        } else if (h0 != nullptr) {
          v = load_f(h0 + row * kDm + rho - kPad);
        }
      }
      pu[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kGPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int s = e / kDm, k = e - s * kDm;
      pg[i] = s < ts ? hpmn::load4(dg + (((long long)(lo + s - t0) * B + row)
                                         * kDm + k) * 4)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto commit = [&](float* s_u, float4* s_dg) {
#pragma unroll
    for (int i = 0; i < kUPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int s = e / R, rho = e - s * R;
      s_u[s * R + (rho & 7) * RW + (rho >> 3)] = pu[i];
    }
#pragma unroll
    for (int i = 0; i < kGPer; ++i) s_dg[threadIdx.x + i * kThreads] = pg[i];
  };

  int hi = t0 + n, lo = hi - kTile > t0 ? hi - kTile : t0;
  fetch(lo, hi - lo);
  for (int i = threadIdx.x; i < kPad * kG; i += kThreads) {
    const int r = i / kG, col = i - r * kG;
    s_wxT[col * kPad + r] = r < d_in ? load_f(wx + i) : 0.0f;
  }
  float a[RW][3], db[3];
#pragma unroll
  for (int ii = 0; ii < RW; ++ii)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      a[ii][g] = first ? 0.0f
                       : acc_row[(8 * ii + warp) * kG + g * kDm + lane];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    db[g] = first ? 0.0f : acc_row[R * kG + g * kDm + lane];

  for (int buf = 0; hi > t0; buf ^= 1) {
    const int ts = hi - lo;
    float* s_u = s_wxT + kG * kPad + buf * tile_floats<NC>();
    float4* s_dg = reinterpret_cast<float4*>(s_u + kTile * R);
    commit(s_u, s_dg);
    // This buffer is whole, and every thread is done with the tile that
    // used it last (two tiles ago).
    __syncthreads();
    const int tile_lo = lo;
    hi = lo;
    lo = hi - kTile > t0 ? hi - kTile : t0;
    if (hi > t0) fetch(lo, hi - lo);

    // dx: the tile's steps warp + 8*s (past ts: computed, not stored).
    float o[kStepsPerWarp][NC];
#pragma unroll
    for (int s = 0; s < kStepsPerWarp; ++s)
#pragma unroll
      for (int c = 0; c < NC; ++c) o[s][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kDm; ++k) {
      float wr[NC], wz[NC], wc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wr[c] = s_wxT[k * kPad + 32 * c + lane];
        wz[c] = s_wxT[(kDm + k) * kPad + 32 * c + lane];
        wc[c] = s_wxT[(2 * kDm + k) * kPad + 32 * c + lane];
      }
#pragma unroll
      for (int s = 0; s < kStepsPerWarp; ++s) {
        const float4 d = s_dg[(warp + kWarps * s) * kDm + k];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          o[s][c] = fmaf(d.x, wr[c], o[s][c]);
          o[s][c] = fmaf(d.y, wz[c], o[s][c]);
          o[s][c] = fmaf(d.z, wc[c], o[s][c]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kStepsPerWarp; ++s) {
      const int sl = warp + kWarps * s;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = 32 * c + lane;
        if (sl < ts && i < d_in)
          hpmn::store_f(
              dx + ((long long)(tile_lo + sl) * B + row) * d_in + i, o[s][c]);
      }
    }

    // The weight gradients, t descending.
    for (int s = ts - 1; s >= 0; --s) {
      const float4 d = s_dg[s * kDm + lane];
      const float* u = s_u + s * R + warp * RW;
#pragma unroll
      for (int q = 0; q < RW / 4; ++q) {
        const float4 uq = *reinterpret_cast<const float4*>(u + 4 * q);
        const float uv[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = 4 * q + e;
          a[ii][0] = fmaf(uv[e], d.x, a[ii][0]);
          a[ii][1] = fmaf(uv[e], d.y, a[ii][1]);
          a[ii][2] = fmaf(uv[e], ii < kXRows ? d.z : d.w, a[ii][2]);
        }
      }
      if (warp == 0) {
        db[0] += d.x;
        db[1] += d.y;
        db[2] += d.z;
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < RW; ++ii)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      acc_row[(8 * ii + warp) * kG + g * kDm + lane] = a[ii][g];
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < 3; ++g) acc_row[R * kG + g * kDm + lane] = db[g];
  }
}

// Group g's partial: 0.0f + acc[rows*g] + acc[rows*g + 1] + ... over its
// rows below B, for each output of dwx_part [d_in][96], dwh_part [32][96]
// and db_part [96].
__global__ void __launch_bounds__(kThreads)
wgrad_partials_kernel(const float* __restrict__ acc, int rows, int B,
                      int d_in, float* __restrict__ dwx_part,
                      float* __restrict__ dwh_part,
                      float* __restrict__ db_part) {
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const long long stride = (long long)hpmn::acc_floats(d_in_pad);
  const int g = blockIdx.x;
  const int nr = rows < B - g * rows ? rows : B - g * rows;
  const float* base = acc + (long long)g * rows * stride;
  for (int i = threadIdx.x; i < (d_in + kDm + 1) * kG; i += kThreads) {
    int off;
    float* out;
    if (i < d_in * kG) {
      off = i;
      out = dwx_part + (long long)g * d_in * kG + i;
    } else if (i < (d_in + kDm) * kG) {
      const int j = i - d_in * kG;
      off = d_in_pad * kG + j;
      out = dwh_part + (long long)g * kDm * kG + j;
    } else {
      const int j = i - (d_in + kDm) * kG;
      off = (d_in_pad + kDm) * kG + j;
      out = db_part + (long long)g * kG + j;
    }
    float sum = 0.0f;
    for (int w = 0; w < nr; ++w) sum += base[w * stride + off];
    *out = sum;
  }
}

template <typename S, int NC>
int launch_nc(const S* x, long long x_tstride, const S* wx, const S* h0,
              const S* hprev, int hp_t0, const S* dg, S* dx, float* acc,
              int t0, int n, bool first, int B, int d_in,
              cudaStream_t stream) {
  const size_t smem = smem_floats<NC>() * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_pass_kernel<S, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  gru_bwd_pass_kernel<S, NC><<<B, kThreads, smem, stream>>>(
      x, x_tstride, wx, h0, hprev, hp_t0, dg, dx, acc, t0, n, first, B,
      d_in);
  return (int)cudaGetLastError();
}

}  // namespace

namespace hpmn {

template <typename S>
int launch_bwd_pass(const S* x, long long x_tstride, const S* wx,
                    const S* h0, const S* hprev, int hp_t0, const S* dg,
                    S* dx, float* acc, int t0, int n, bool first, int B,
                    int d_in, cudaStream_t stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || n < 1 || t0 < 0)
    return (int)cudaErrorInvalidValue;
  switch ((d_in + 31) / 32) {
    case 1:
      return launch_nc<S, 1>(x, x_tstride, wx, h0, hprev, hp_t0, dg, dx, acc,
                             t0, n, first, B, d_in, stream);
    case 2:
      return launch_nc<S, 2>(x, x_tstride, wx, h0, hprev, hp_t0, dg, dx, acc,
                             t0, n, first, B, d_in, stream);
    default:
      return launch_nc<S, 3>(x, x_tstride, wx, h0, hprev, hp_t0, dg, dx, acc,
                             t0, n, first, B, d_in, stream);
  }
}

template int launch_bwd_pass<float>(const float*, long long, const float*,
                                    const float*, const float*, int,
                                    const float*, float*, float*, int, int,
                                    bool, int, int, cudaStream_t);
template int launch_bwd_pass<__nv_bfloat16>(
    const __nv_bfloat16*, long long, const __nv_bfloat16*,
    const __nv_bfloat16*, const __nv_bfloat16*, int, const __nv_bfloat16*,
    __nv_bfloat16*, float*, int, int, bool, int, int, cudaStream_t);

int launch_wgrad_partials(const float* acc, int rows, int B, int d_in,
                          float* dwx_part, float* dwh_part, float* db_part,
                          cudaStream_t stream) {
  if (rows < 1 || B < 1 || d_in < 1 || d_in > 32 * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  wgrad_partials_kernel<<<(B + rows - 1) / rows, kThreads, 0, stream>>>(
      acc, rows, B, d_in, dwx_part, dwh_part, db_part);
  return (int)cudaGetLastError();
}

}  // namespace hpmn

namespace {

template <typename S>
int pass_alone(const S* x, long long x_tstride, const S* wx, const S* h0,
               const S* hseq, const S* dg, S* dx, float* acc,
               float* dwx_part, float* dwh_part, float* db_part, int rows,
               int T, int B, int d_in, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int code = hpmn::launch_bwd_pass<S>(x, x_tstride, wx, h0, hseq, 1,
                                            dg, dx, acc, 0, T, true, B, d_in,
                                            st);
  if (code != 0) return code;
  return hpmn::launch_wgrad_partials(acc, rows, B, d_in, dwx_part, dwh_part,
                                     db_part, st);
}

}  // namespace

// The pass alone over all T steps (the tests and chip_smoke.py hold it to
// its plain version): x [T,B,d_in] (time stride x_tstride, rows
// contiguous), wx [d_in,96], h0 [B,32] or null, hseq [T,B,32] contiguous
// (h_prev of step t is hseq[t-1]), dg [T,B,32,4] contiguous; writes dx
// [T,B,d_in] and, per group of `rows` rows, the f32 partials dwx_part
// [d_in,96], dwh_part [32,96], db_part [96]; acc [B, (d_in_pad + 33) * 96]
// f32 is its workspace. All float32.
extern "C" int hpmn_gru_bwd_pass(const float* x, long long x_tstride,
                                 const float* wx, const float* h0,
                                 const float* hseq, const float* dg,
                                 float* dx, float* acc, float* dwx_part,
                                 float* dwh_part, float* db_part, int rows,
                                 int T, int B, int d_in, void* stream) {
  return pass_alone<float>(x, x_tstride, wx, h0, hseq, dg, dx, acc, dwx_part,
                           dwh_part, db_part, rows, T, B, d_in, stream);
}

// The same with x, wx, h0, hseq, dg and dx in bf16.
extern "C" int hpmn_gru_bwd_pass_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* h0, const __nv_bfloat16* hseq,
    const __nv_bfloat16* dg, __nv_bfloat16* dx, float* acc, float* dwx_part,
    float* dwh_part, float* db_part, int rows, int T, int B, int d_in,
    void* stream) {
  return pass_alone<__nv_bfloat16>(x, x_tstride, wx, h0, hseq, dg, dx, acc,
                                   dwx_part, dwh_part, db_part, rows, T, B,
                                   d_in, stream);
}

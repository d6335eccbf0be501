// The input projection of K1, K1-scale and their bf16 forms for Hopper
// (sm_90a): xp[t, b, :] = x[t, b, :] @ wx (+ b) into an f32 workspace
// [T, B, 96], the half of the per-step work that does not depend on h,
// taken out of the recurrence (gru_scan_fwd.cu).
//
// Replaces, with the recurrence it feeds, hpmn_tpu/ops/pallas_gru.py::
// _fwd_kernel, with and without has_scale, in f32 (K1, K1-scale) and with
// dtype=bfloat16 (K1-bf16, K1-scale-bf16), whose x @ wx4 the TPU kernel
// computes inside its time loop.
// Its plain versions are ops/gru.py::gru_input_proj and
// gru_input_proj_bf16.
//
// Bits: each output is the fmaf chain of K1's project(), from 0.0f over k =
// 0 ... d_in-1 in order (in bf16 over the bf16 values as f32: each product
// is exact). The k loop runs over d_in rounded up to 4 with zero x and zero
// weights past d_in; fmaf(0, 0, acc) is acc (a chain from +0 never holds
// -0), as in K1's zero-padded 32-chunks. Then, in f32, one add of the bias
// to every block: the value K1's gates read as p.a* + b_*. In bf16 the
// chain sums (x@wx + h@wh) + b for r and z, so those two blocks are written
// without the bias, and the c block is ac + b_c rounded to bf16 (the
// chain's pre_c), written as f32: gates_bf16_xp rounds it again, which
// changes nothing. Tensor cores are not used: TF32 would change the bits.
//
// What bounds it: bytes. Per row it reads d_in elements of x and writes 96
// floats of xp; at d_in = 32 that is 128 B in (64 in bf16) and 384 B out
// for 3072 FMAs, 6 FMAs per byte, under the card's 20 FMAs per byte of
// HBM. What the design does about it: each thread keeps kRowsPerThread x 4
// (row, column) sums in registers, so one 16-byte shared-memory load of x
// (4 k of one row) and one of wx (4 columns of one k) feed 16 FMAs each. A
// warp covers 4 rows by 8 column groups at a time: its loads of wx are 128
// contiguous bytes, and its loads of x read 4 addresses one row pitch (4
// banks) apart, each shared by 8 lanes, so neither has a bank conflict.
// The weights stay in shared memory, as f32, for the block's life: the
// grid is one wave of blocks, each walking over tiles of kRows rows, and
// the next tile's x is on its way while this one is computed, so the
// loads' latency hides behind the FMAs. In f32 it is copied into shared
// memory by cp.async, double-buffered. A bf16 row of odd d_in is not 4-byte
// aligned, and cp.async copies 4, 8 or 16 bytes, so in bf16 the next tile
// is loaded into registers before this tile's FMAs and converted to f32 and
// stored into the other buffer after them: a bf16 value converted right
// after its load stalls the warp on that load (K3-bf16, PERF.md). Output
// rows are written as 16-byte stores, 384 contiguous bytes per row.
//
// Time stride: row (t, b) of x is read at x + t*x_tstride + b*d_in, so the
// next HPMN layer's input h_seq[period-1::period] is read with no copy.

#include "gru_chain.cuh"

namespace {

using hpmn::kG;
using hpmn::load_f;
// A thread sums kRowsPerThread rows by 4 columns; a tile is 16 of those
// row groups by the 96 columns.
constexpr int kRowsPerThread = 4;  // 8 took 7% longer (PERF.md)
constexpr int kRows = 16 * kRowsPerThread;  // rows (t, b) per tile
constexpr int kWarps = 12;  // 4 row-warps by 3 column-warps
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDin = 32 * hpmn::kMaxChunks;
// bf16: the rows of a tile that one warp loads (rows w, w + 12, ...).
constexpr int kRowsPerWarp = (kRows + kWarps - 1) / kWarps;

__host__ __device__ __forceinline__ int din4(int d_in) {
  return (d_in + 3) & ~3;
}
// The x tile's row pitch in floats: 16-byte aligned, and 4 banks apart.
__host__ __device__ __forceinline__ int x_pitch(int d_in) {
  return din4(d_in) + 4;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int d_in) {
  return (size_t)(din4(d_in) * kG + 2 * kRows * x_pitch(d_in))
         * sizeof(float);
}

// Start the copies of tile `tile`'s x rows into s_xb: warp w takes rows w,
// w + 12, ..., lanes along k < d_in (the columns past d_in stay zero).
__device__ __forceinline__ void stage_tile(float* s_xb, const float* x,
                                           long long x_tstride, int tile,
                                           int n_rows, int B, int d_in,
                                           int pitch, int warp, int lane) {
  for (int r = warp; r < kRows; r += kWarps) {
    const int R = tile * kRows + r;
    if (R >= n_rows) break;
    const int t = R / B;
    const float* x_row = x + t * x_tstride + (long long)(R - t * B) * d_in;
    for (int k = lane; k < d_in; k += 32)
      hpmn::copy_async(s_xb + r * pitch + k, x_row + k);
  }
}

// S: the stream type of x, wx and b (float or __nv_bfloat16).
template <typename S>
__global__ void __launch_bounds__(kThreads)
input_proj_kernel(const S* __restrict__ x, long long x_tstride,
                  const S* __restrict__ wx, const S* __restrict__ bias,
                  float* __restrict__ xp, int T, int B, int d_in) {
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  extern __shared__ __align__(16) float smem[];
  const int d4 = din4(d_in), pitch = x_pitch(d_in);
  float* s_w = smem;            // [d4][96], zero rows past d_in
  float* s_x = smem + d4 * kG;  // two x tiles [kRows][pitch], zero past d_in
  for (int i = threadIdx.x; i < d4 * kG; i += kThreads)
    s_w[i] = i < d_in * kG ? load_f(wx + i) : 0.0f;
  for (int i = threadIdx.x; i < 2 * kRows * (d4 - d_in); i += kThreads)
    s_x[(i / (d4 - d_in)) * pitch + d_in + i % (d4 - d_in)] = 0.0f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = (warp / 3) * 4 + (lane >> 3);  // rows rg + 16*i
  const int cg = (warp % 3) * 8 + (lane & 7);   // columns 4*cg ... 4*cg+3
  // bf16: only the c block (columns 64 ... 95) takes its bias, and is
  // rounded.
  const bool biased = !kBf16 || 4 * cg >= 2 * hpmn::kDm;
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bv[j] = biased ? load_f(bias + 4 * cg + j) : 0.0f;
  const int n_rows = T * B;
  const int n_tiles = (n_rows + kRows - 1) / kRows;

  // bf16: a tile's x in registers, lane k of row w + 12*i holding elements
  // k, k + 32, k + 64 in the stream type; fetch() issues the loads,
  // commit() converts and stores them into a buffer.
  S raw[kRowsPerWarp][hpmn::kMaxChunks];
  auto fetch = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i, R = tile * kRows + r;
      if (r < kRows && R < n_rows) {
        const int t = R / B;
        const S* x_row = x + t * x_tstride + (long long)(R - t * B) * d_in;
#pragma unroll
        for (int c = 0; c < hpmn::kMaxChunks; ++c)
          if (32 * c + lane < d_in) raw[i][c] = x_row[32 * c + lane];
      }
    }
  };
  auto commit = [&](float* s_xb, int tile) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i, R = tile * kRows + r;
      if (r < kRows && R < n_rows) {
#pragma unroll
        for (int c = 0; c < hpmn::kMaxChunks; ++c)
          if (32 * c + lane < d_in)
            s_xb[r * pitch + 32 * c + lane] = load_f(&raw[i][c]);
      }
    }
  };

  // Tile i's x arrives in buffer i % 2 while tile i - 1 is computed from
  // the other: one barrier a tile orders both the arrival and the last
  // reads of a buffer before it is refilled.
  int buf = 0;
  if constexpr (kBf16) {
    fetch(blockIdx.x);
    commit(s_x, blockIdx.x);
  } else {
    stage_tile(s_x, x, x_tstride, blockIdx.x, n_rows, B, d_in, pitch, warp,
               lane);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const bool more = tile + (int)gridDim.x < n_tiles;
    if constexpr (!kBf16) {
      hpmn::copy_async_commit();
      hpmn::copy_async_wait<0>();
    }
    __syncthreads();  // s_w and this tile's x in place; last tile's reads done
    const float* s_xb = s_x + buf * kRows * pitch;
    if (more) {
      if constexpr (kBf16)
        fetch(tile + gridDim.x);
      else
        stage_tile(s_x + (buf ^ 1) * kRows * pitch, x, x_tstride,
                   tile + gridDim.x, n_rows, B, d_in, pitch, warp, lane);
    }

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < d4; k += 4) {
      float xv[kRowsPerThread][4], wv[4][4];  // [row][kk], [kk][column]
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            s_xb + (rg + 16 * i) * pitch + k);
        xv[i][0] = v.x, xv[i][1] = v.y, xv[i][2] = v.z, xv[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v =
            *reinterpret_cast<const float4*>(s_w + (k + kk) * kG + 4 * cg);
        wv[kk][0] = v.x, wv[kk][1] = v.y, wv[kk][2] = v.z, wv[kk][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k, k+1, k+2, k+3: K1's order
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[i][kk], wv[kk][j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int R = tile * kRows + rg + 16 * i;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = biased ? acc[i][j] + bv[j] : acc[i][j];
        if (kBf16 && biased) o[j] = hpmn::to_f(hpmn::to_b(o[j]));
      }
      if (R < n_rows)
        *reinterpret_cast<float4*>(xp + (long long)R * kG + 4 * cg) =
            make_float4(o[0], o[1], o[2], o[3]);
    }
    if constexpr (kBf16) {
      if (more) commit(s_x + (buf ^ 1) * kRows * pitch, tile + gridDim.x);
    }
  }
}

}  // namespace

namespace hpmn {

template <typename S>
int launch_input_proj(const S* x, long long x_tstride, const S* wx,
                      const S* b, float* xp, int T, int B, int d_in,
                      cudaStream_t stream) {
  // Row indices are 32-bit; the outputs' offsets 64-bit.
  if (d_in < 1 || d_in > kMaxDin || B < 1 || T < 1
      || (long long)T * B > 0x7fffffffLL - kRows)
    return (int)cudaErrorInvalidValue;
  const int n_sm = hpmn::sm_count();
  const size_t smem = smem_bytes(d_in);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        input_proj_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, input_proj_kernel<S>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = ((long long)T * B + kRows - 1) / kRows;
  const long long wave = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(n_tiles < wave ? n_tiles : wave);
  input_proj_kernel<S><<<grid, kThreads, smem, stream>>>(x, x_tstride, wx, b,
                                                         xp, T, B, d_in);
  return (int)cudaGetLastError();
}

template int launch_input_proj<float>(const float*, long long, const float*,
                                      const float*, float*, int, int, int,
                                      cudaStream_t);
template int launch_input_proj<__nv_bfloat16>(
    const __nv_bfloat16*, long long, const __nv_bfloat16*,
    const __nv_bfloat16*, float*, int, int, int, cudaStream_t);

}  // namespace hpmn

// The projection alone (the tests and chip_smoke.py hold it to its plain
// version): x [T,B,d_in] (time stride x_tstride, rows contiguous), wx
// [d_in,96], b [96], all float32 (K1's: x @ wx + b) or all bf16 (K1-bf16's
// layout, above), and xp [T,B,96] contiguous float32.
extern "C" int hpmn_gru_input_proj(const float* x, long long x_tstride,
                                   const float* wx, const float* b, float* xp,
                                   int T, int B, int d_in, void* stream) {
  return hpmn::launch_input_proj(x, x_tstride, wx, b, xp, T, B, d_in,
                                 (cudaStream_t)stream);
}

extern "C" int hpmn_gru_input_proj_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* wx,
    const __nv_bfloat16* b, float* xp, int T, int B, int d_in,
    void* stream) {
  return hpmn::launch_input_proj(x, x_tstride, wx, b, xp, T, B, d_in,
                                 (cudaStream_t)stream);
}

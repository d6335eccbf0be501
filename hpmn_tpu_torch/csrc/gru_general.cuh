// The GRU scan at any width for Hopper (sm_90a), the design shared by
// gru_general_gemm.cu, gru_general_fwd.cu and gru_general_bwd.cu: the
// width-general forms of K1 and K2 (gru_scan_fwd.cu and gru_scan_bwd.cu
// keep every hidden width d_m = 32, d_in <= 96 call; ops/cuda_gru.py
// dispatches every other width here), in both chains and with and
// without the mask and the AUGRU gate scale.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_fwd_kernel (K1-general:
// hpmn_gru_gen_fwd, hpmn_gru_gen_fwd_bf16) and ::_bwd_kernel (K2-general:
// hpmn_gru_gen_bwd, hpmn_gru_gen_bwd_bf16) at the widths the Pallas
// kernels take from their operands: 1 <= d_m <= 256, 1 <= d_in <= 512.
// The step's formulas, and where the bf16 chain rounds, are gru_chain.cuh's
// (gates_f32_xp, update_f32, step_grad_f32, gates_bf16_xp, the bf16 ops,
// step_grad_bf16): only the dot products and where h and the weights live
// depend on the width.
//
// What bounds it: as at d_m = 32, the recurrence. Step t needs h_{t-1}
// (the forward) or dh_t (the backward), so one row's T steps run one after
// another; per step and row the chain holds one product with wh (3*d_m*d_m
// FMAs) and the gates. Everything that does not depend on the carry runs
// outside it as tiled products over all rows and steps of a chunk: the
// input projection x @ wx (+ b) of both kernels, the backward's recompute
// h_prev @ wh (h_prev is the forward's h_seq, known before the sweep), and
// the backward's dx = [dr|dz|dc] @ wx^T and weight gradients.
//
// The sources: gru_general_gemm.cu (the tiled products and the
// projection's entry points), gru_general_fwd.cu (K1-general's recurrence
// and entry points), gru_general_bwd.cu (K2-general's), each compiled by
// an nvcc process of its own; this header declares what they share.
//
// The kernels, per chunk of steps (the wrapper sizes the f32 workspaces to
// ops/cuda_gru.py's WORKSPACE_BYTES; the result does not depend on the
// chunk):
//
// - The tiled products (gru_general_gemm.cu), f32 on the CUDA cores. Each
//   output is one fmaf chain over k in order, from 0.0f (or, for the
//   weight-gradient partials of a later chunk, from the chunk before's
//   sum), so the projection's outputs are the fmaf chain from 0 over k =
//   0 ... d_in-1 of the fixed-width projection (gru_input_proj.cu, bits
//   documented there), and in bf16 each is the f32 sum of exact products
//   of bf16 values, rounded where the chain rounds: the r and z blocks
//   without the bias, the c block bf16(x @ wx_c + b_c). No tensor cores:
//   TF32, or bf16 products summed otherwise, would change the roundings.
//   tall_kernel runs the products over a chunk's rows (the projection, h_prev
//   @ wh, dx): 128 x 64 outputs a block, 256 threads of 8 x 4. Its operand
//   functors (ProjOp, HprevOp, DxOp) give each row's pointer once per
//   block (x at its time stride, h_prev from h_seq or h0, the gate
//   gradients from dg) and each k's offset once per k-tile. wgrad_kernel
//   runs the weight gradients: 32 rows of dwx or dwh by 32 units' three
//   gate columns a block (128 threads of 8 rows x one unit), x's tiles and
//   h's in one grid, db summed beside the first x tile's rows 0-7, each
//   unit's gate gradients one 16-byte (bf16: 8-byte) load. Both stage
//   k-tiles (16 rows deep; the weight gradients' 32) in two shared
//   buffers, the next tile's loads in flight in registers during the
//   current tile's FMAs, one barrier a tile. The weight gradients split
//   the chunk's rows into `splits` slices (grid z), one f32 partial each,
//   carried across chunks in f32; the wrapper sums the partials, as the
//   TPU kernel emits one per batch tile. A chunk's rows stay below 2^31
//   (the products' row indices are 32-bit).
// - gen_fwd_rec_kernel (K1's recurrence): `rows` batch rows per block, U =
//   d_m rounded up to 32 threads each (thread j owns hidden unit j; lanes
//   past d_m idle, so a row is whole warps). wh is staged in shared memory
//   as f32 when 3*d_m*d_m floats fit beside the state buffers (d_m <= 136;
//   kSmemW), and read through L1/L2 from device memory otherwise. h_{t-1}
//   of each row sits in shared memory (two buffers), so a step is one
//   block barrier: g = h @ wh is the fmaf chain from 0.0f over k = 0 ...
//   d_m-1 (project()'s order), then the gates and the update. xp, the mask
//   and the scale ride a ring of registers kAhead steps ahead.
// - gen_bwd_rec_kernel (K2's recurrence): the same layout, in reverse. The
//   step reads xp and g = h_prev @ wh from the chunk's workspaces (the
//   same bits as the forward's), takes the gate gradients, writes them
//   into dg [n, B, d_m, 4] (lane k: dr, dz, dc, dc*r, the fixed-width
//   layout) and into shared memory, and after one barrier takes dh =
//   carry + [dr|dz|dc*r] @ wh^T over k in order, wh^T staged in shared
//   memory when it fits (kSmemW) and read from device memory otherwise.
//   With the scale, dscale[t, row] is each warp's shuffle tree of its
//   units' dzs*z, then the row's warps summed in order by thread 0.
//
// The strided forms (K3-general: hpmn_gru_gen_stride_fwd[_bf16], in
// gru_general_fwd.cu; K4-general: hpmn_gru_gen_stride_bwd[_bf16], in
// gru_general_bwd.cu) replace _fwd_stride_kernel and _bwd_stride_kernel at
// the same widths; ops/cuda_gru_stride.py dispatches to them. They write
// and read no dense [T, B, d_m] state or cotangent:
//
// - K3-general is K1-general's projection and recurrence with another
//   output policy (GenStride): the rows h_seq[period-1::period], the state
//   before every kStrideChunk-th step (the boundaries) and h_T, and the
//   update stride_update (the TPU stride kernel's h + z*(c - h)).
// - K4-general runs, per workspace chunk (a multiple of kStrideChunk steps,
//   from the last), the projection, a replay of the chunk from its first
//   boundary with K3-general's recurrence (GenReplay: each step's h_prev
//   and h @ wh into workspaces, so the states are K3-general's bit for
//   bit), gen_bwd_rec_kernel with the strided cotangents (StrideCot), then
//   dx and the weight gradients as tiled products over the workspaces. Its
//   partials are batch slices walked from the last step to the first
//   (launch_wgrad's by_batch), so every output is the same over any chunk.
//
// The block's rows: enough that the grid is about one wave over the SMs
// (ceil(B / SMs)), at most 512 threads a block.
//
// Time strides: x, the mask and the scale are read at x + t*x_tstride,
// mask + t*m_tstride and scale + t*s_tstride (the next HPMN layer's input
// is the view h_seq[period-1::period]); h0, h_seq, dh_seq, dx, dscale and
// dg are contiguous.

#pragma once

#include "gru_chain.cuh"

namespace hpmn_gen {

using hpmn::load_f;
using hpmn::store_f;

constexpr int kMaxDm = 256;
constexpr int kMaxDin = 512;
constexpr int kRecThreads = 512;  // the recurrences' threads a block, at most

inline bool dims_ok(int d_in, int d_m) {
  return d_in >= 1 && d_in <= kMaxDin && d_m >= 1 && d_m <= kMaxDm;
}

// The row of h_prev of step t, batch row b: h_seq[t-1], or h0 at t = 0
// (null, a row of zeros, when h0 is).
template <typename S>
__device__ __forceinline__ const S* h_prev_row(const S* h0, const S* hseq,
                                               long long t, long long b,
                                               int B, int d_m) {
  if (t > 0) return hseq + ((t - 1) * B + b) * d_m;
  return h0 != nullptr ? h0 + b * d_m : nullptr;
}

// h_prev of step t, row b, unit k.
template <typename S>
__device__ __forceinline__ float h_prev(const S* h0, const S* hseq,
                                        long long t, long long b, long long k,
                                        int B, int d_m) {
  const S* row = h_prev_row(h0, hseq, t, b, B, d_m);
  return row != nullptr ? load_f(row + k) : 0.0f;
}

// ---- The recurrences' block: rows, threads, shared memory.
struct RecShape {
  int rows, threads;
  size_t smem;
  bool smem_w;  // wh (forward) or wh^T (backward) in shared memory
};

inline RecShape rec_shape(int B, int d_m, bool bwd) {
  const int U = (d_m + 31) / 32 * 32;
  const int n_sm = hpmn::sm_count();
  int rows = (B + (n_sm > 0 ? n_sm : 1) - 1) / (n_sm > 0 ? n_sm : 1);
  const int most = kRecThreads / U;
  rows = rows < 1 ? 1 : rows > most ? most : rows;
  // fwd: h [2][rows][d_m]; bwd: the gate gradients [2][rows][d_m] float4,
  // then each row's warp sums of dscale [2][rows][U/32].
  const size_t buf = bwd ? (size_t)(8 * rows * d_m + 2 * rows * (U / 32))
                         : (size_t)(2 * rows * d_m);
  const size_t w = (size_t)3 * d_m * d_m;
  RecShape s;
  s.rows = rows;
  s.threads = rows * U;
  s.smem_w = (w + buf) * sizeof(float) <= hpmn::kMaxSmem;
  s.smem = ((s.smem_w ? w : 0) + buf) * sizeof(float);
  return s;
}

template <typename K>
inline int prepare(K kernel, const RecShape& rs) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs.smem);
}

// The tiled products (gru_general_gemm.cu), each over `rows` = n*B rows of
// a chunk of n steps, on `st`; each returns cudaGetLastError().
//
// xp [rows, 3*d_m] f32 = the input projection of x (x at the chunk's first
// step, time stride x_tstride, rows contiguous).
template <typename S>
int launch_proj(const S* x, long long x_tstride, const S* wx, const S* b,
                float* xp, long long rows, int B, int d_in, int d_m,
                cudaStream_t st);
// gh [rows, 3*d_m] f32 = h_prev @ wh for the steps [t0, t0 + n).
template <typename S>
int launch_hprev(const S* h0, const S* hseq, const S* wh, float* gh, int t0,
                 long long rows, int B, int d_m, cudaStream_t st);
// dx [rows, d_in] (dx at the chunk's first step) = [dr|dz|dc] @ wx^T from
// the chunk's gate gradients dg [rows, d_m, 4].
template <typename S>
int launch_dx(const S* dg, const S* wx, S* dx, long long rows, int d_in,
              int d_m, cudaStream_t st);
// The weight-gradient partials [splits] of dwx, db and dwh += the chunk's
// (steps [t0, t0 + n)) rows' products, from 0 where `first`. Partial z
// sums the z-th slice of the chunk's rows in time-major order, or, with
// `by_batch` (B a multiple of splits), the z-th slice of the batch rows
// over the chunk's steps from the last to the first, so that chunks run
// from the last to the first give every partial's sums in one order,
// whatever the chunk (gru_general_gemm.cu's WgradOp).
template <typename S>
int launch_wgrad(const S* x, long long x_tstride, const S* h0, const S* hseq,
                 const S* dg, float* dwx_part, float* dwh_part,
                 float* db_part, bool first, int t0, long long rows,
                 int splits, int B, int d_in, int d_m, bool by_batch,
                 cudaStream_t st);

// K4-general's replay (gru_general_fwd.cu): K3-general's recurrence over n
// steps from h_start [B, d_m] (a boundary state) on the projection xp [n,
// B, 3*d_m], writing each step's h_prev into hprev [n, B, d_m] and h @ wh
// into gh [n, B, 3*d_m] f32; returns cudaGetLastError().
template <typename S>
int launch_replay(const float* xp, const S* wh, const S* b, const S* h_start,
                  S* hprev, float* gh, int n, int B, int d_m,
                  cudaStream_t st);

}  // namespace hpmn_gen

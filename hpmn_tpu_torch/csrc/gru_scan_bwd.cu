// GRU scan backward for Hopper (sm_90a): one launch sweeps one whole layer
// in reverse.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_bwd_kernel (its mask and no-mask
// forms, no AUGRU scale), in both of its chains: f32 (K2, hpmn_gru_scan_bwd)
// and dtype=bfloat16 (K2-bf16, hpmn_gru_scan_bwd_bf16). Per step t = T-1 ..
// 0, for batch row b, with m_t = 1 when there is no mask:
//
//   h_prev = h_seq[t-1]            (h0, or zeros, at t = 0)
//   r, z, c, g_c recomputed from x_t and h_prev with gru_scan_fwd.cu's
//   formulas, bit for bit (gru_chain.cuh's gates(), the same fmaf order)
//   gtot = dh_seq[t] + dh;   gcell = gtot * m_t
//   dzs = gcell*(c - h_prev); dc = gcell*z*(1-c^2)
//   dz = dzs*z*(1-z);         dr = dc*g_c*r*(1-r)
//   dh = gcell*(1-z) + (gtot - gcell) + [dr|dz|dc*r] @ wh^T
//   dx_t = [dr|dz|dc] @ wx^T
//   dWx += x_t^T [dr|dz|dc];  dWh += h_prev^T [dr|dz|dc*r];  db += [dr|dz|dc]
//
// (gtot - gcell) is the pass-through of a masked step: a padded step carries
// h unchanged, so its gradient flows to h_prev untouched.
//
// The bf16 chain rounds where the TPU kernel's does: x, h_seq, dh_seq and
// the mask are bf16 and dx is written as bf16; the dh carry stays f32, and
// gtot = bf16(dh_seq[t] + dh). dzs, dc, dz, dr, dc*r and the carry's own
// term gcell - gcell*z (+ gtot - gcell with a mask) are bf16, op by op;
// dh = f32(that term) + [dr|dz|dc*r] @ wh^T, summed in f32, and dx =
// bf16([dr|dz|dc] @ wx^T). The weight gradients are f32 sums of products
// of bf16 values, written as f32 partials; rounding them to the weights'
// bf16 is the wrapper's (as pallas_gru.py's _bwd does after its tile sum).
// The bf16 ops are native bf16 instructions (gru_chain.cuh); the weights
// stay f32 in shared memory, so the layout and the rows per block are the
// f32 form's.
//
// What bounds it: the recurrence, as in the forward. Each step needs the dh
// of the step after it, and per step and row the work is small: about 36k
// FLOPs in five 32-wide products (recompute x@wx and h@wh, dh, dx, the two
// weight-gradient outer products). Per row and step it streams 128 B of x,
// h_seq and dh_seq each in and 128 B of dx out (half that in bf16).
// Latency and issue bound it.
//
// What the design does about it. The layout is the forward's: the whole
// reverse loop in one launch, one warp per batch row, lane j owning hidden
// unit j, the dh carry in a register, operands broadcast with __shfl_sync,
// the next step's loads issued one step ahead.
//
// - The transposed products (dh and dx read wh and wx along rows: lane j
//   needs w[j][g*32+k] for a k shared by the warp, a 32-way bank conflict)
//   read transposed copies of wh and wx kept in shared memory beside the
//   row-major ones the recompute reads, so every read is conflict-free.
// - The weight gradients are accumulated in shared memory, one slice per
//   warp, where lane j owns column j of each gate block: no atomics, no
//   bank conflicts, and no 195 register accumulators per lane. At the end
//   the block sums its warps' slices and writes one partial per block; the
//   wrapper sums the partials (as the TPU kernel emits one per batch tile).
//
// The port's forward keeps the whole h_seq, so the backward reads h_{t-1}
// from it: it needs no boundary states and no padding of T to 8.
//
// x and mask are read with a time stride (the next HPMN layer's input is the
// view h_seq[period-1::period]); h_seq, dh_seq and dx are contiguous.

#include "gru_chain.cuh"

namespace {

using hpmn::kDm;
using hpmn::kFull;
using hpmn::load_f;
constexpr int kG = 3 * kDm;      // the r, z and c blocks
constexpr int kMaxWarps = 4;     // batch rows per block, at most
constexpr int kMaxChunks = 3;    // d_in <= 96
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit

// Shared-memory floats: the weights (row-major and transposed) for the
// block, and the accumulators (dWx [d_in_pad][96], dWh [32][96], db [96])
// for each warp.
size_t weights_floats(int d_in_pad) {
  return (size_t)2 * (d_in_pad + kDm) * kG;
}
size_t acc_floats(int d_in_pad) { return (size_t)(d_in_pad + kDm + 1) * kG; }

int rows_per_block(int d_in) {
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const size_t free_bytes = kMaxSmem - weights_floats(d_in_pad) * 4;
  int w = (int)(free_bytes / (acc_floats(d_in_pad) * 4));
  return w < kMaxWarps ? w : kMaxWarps;
}

struct StepIn {
  float x[kMaxChunks];  // lane k of chunk c: x_t[32*c + k]
  float hp;             // h_prev[lane]
  float dhs;            // dh_seq[t][lane]
  float m;              // mask_t (the f32 chain)
  hpmn::B hpb, mb;      // h_prev[lane] and mask_t as the bf16 chain's values
};

template <typename S>
__device__ __forceinline__ void load_step(
    StepIn& s, int t, int row, int lane, int B, int d_in, int n_chunks,
    const S* __restrict__ x, long long x_tstride,
    const S* __restrict__ mask, long long m_tstride,
    const S* __restrict__ h0, const S* __restrict__ hseq,
    const S* __restrict__ dhseq) {
  const S* x_row = x + (long long)t * x_tstride + (long long)row * d_in;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = 32 * c + lane;
    s.x[c] = (c < n_chunks && k < d_in) ? load_f(x_row + k) : 0.0f;
  }
  if (t > 0)
    s.hp = load_f(hseq + ((long long)(t - 1) * B + row) * kDm + lane);
  else
    s.hp = h0 != nullptr ? load_f(h0 + (long long)row * kDm + lane) : 0.0f;
  s.dhs = load_f(dhseq + ((long long)t * B + row) * kDm + lane);
  s.m = mask != nullptr ? load_f(mask + (long long)t * m_tstride + row)
                        : 1.0f;
  if constexpr (hpmn::kIsBf16<S>) {  // exact: the values are bf16
    s.hpb = hpmn::to_b(s.hp);
    s.mb = hpmn::to_b(s.m);
  }
}

// One step's gate gradients (dpre blocks) and the carry's own term.
struct StepGrad {
  float dr, dz, dc, dcr;
  float carry;  // dh_prev before the products with wh^T
};

// f32: the port's first K2 formulas. The carry's term is the start of the
// fmaf chain of dh_prev.
__device__ __forceinline__ StepGrad step_grad_f32(const hpmn::Gates& g,
                                                  const StepIn& s, float dh) {
  StepGrad o;
  const float gtot = s.dhs + dh;
  const float gcell = gtot * s.m;
  const float dzs = gcell * (g.c - s.hp);
  o.dc = gcell * g.z * (1.0f - g.c * g.c);
  o.dz = dzs * g.z * (1.0f - g.z);
  o.dr = o.dc * g.gc * g.r * (1.0f - g.r);
  o.dcr = o.dc * g.r;
  o.carry = gcell * (1.0f - g.z) + (gtot - gcell);
  return o;
}

// bf16: pallas_gru.py::_bwd_kernel with dtype=bfloat16, op by op. The
// carry's term is added to the f32 sum of the products afterwards, as the
// TPU kernel adds it to its dot.
__device__ __forceinline__ StepGrad step_grad_bf16(const hpmn::GatesB& g,
                                                   const StepIn& s, float dh,
                                                   bool masked) {
  using hpmn::add_b;
  using hpmn::B;
  using hpmn::mul_b;
  using hpmn::sub_b;
  using hpmn::to_f;
  const B one = hpmn::one_b();
  const B gtot = hpmn::to_b(s.dhs + dh);
  const B gcell = mul_b(gtot, s.mb);
  const B dzs = mul_b(gcell, sub_b(g.c, s.hpb));
  const B dc = mul_b(mul_b(gcell, g.z), sub_b(one, mul_b(g.c, g.c)));
  const B dz = mul_b(mul_b(dzs, g.z), sub_b(one, g.z));
  const B dr = mul_b(mul_b(mul_b(dc, g.gc), g.r), sub_b(one, g.r));
  B carry = sub_b(gcell, mul_b(gcell, g.z));
  if (masked) carry = add_b(carry, sub_b(gtot, gcell));
  StepGrad o;
  o.dr = to_f(dr);
  o.dz = to_f(dz);
  o.dc = to_f(dc);
  o.dcr = to_f(mul_b(dc, g.r));
  o.carry = to_f(carry);
  return o;
}

// S: the stream type, float (K2) or __nv_bfloat16 (K2-bf16).
template <typename S>
__global__ void __launch_bounds__(kMaxWarps * 32)
gru_scan_bwd_kernel(const S* __restrict__ x, long long x_tstride,
                    const S* __restrict__ mask, long long m_tstride,
                    const S* __restrict__ wx, const S* __restrict__ wh,
                    const S* __restrict__ bias,
                    const S* __restrict__ h0,
                    const S* __restrict__ hseq,
                    const S* __restrict__ dhseq,
                    S* __restrict__ dx, float* __restrict__ dh0,
                    float* __restrict__ dwx_part, float* __restrict__ dwh_part,
                    float* __restrict__ db_part, int T, int B, int d_in) {
  constexpr bool kBf16 = hpmn::kIsBf16<S>;
  extern __shared__ float smem[];
  const int n_chunks = (d_in + 31) / 32;
  const int d_in_pad = n_chunks * 32;
  const int warps = blockDim.x >> 5;
  float* s_wx = smem;                       // [d_in_pad][96], zero rows
  float* s_wxT = s_wx + d_in_pad * kG;      // [96][d_in_pad]
  float* s_wh = s_wxT + kG * d_in_pad;      // [32][96]
  float* s_whT = s_wh + kDm * kG;           // [96][32]
  float* s_acc = s_whT + kG * kDm;          // per warp: acc_floats()
  const int acc_n = (d_in_pad + kDm + 1) * kG;
  for (int i = threadIdx.x; i < d_in_pad * kG; i += blockDim.x) {
    const int r = i / kG, col = i - r * kG;
    const float w = r < d_in ? load_f(wx + i) : 0.0f;
    s_wx[i] = w;
    s_wxT[col * d_in_pad + r] = w;
  }
  for (int i = threadIdx.x; i < kDm * kG; i += blockDim.x) {
    const int r = i / kG, col = i - r * kG;
    const float w = load_f(wh + i);
    s_wh[i] = w;
    s_whT[col * kDm + r] = w;
  }
  for (int i = threadIdx.x; i < warps * acc_n; i += blockDim.x)
    s_acc[i] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * warps + warp;
  float* acc_wx = s_acc + warp * acc_n;      // [d_in_pad][96]
  float* acc_wh = acc_wx + d_in_pad * kG;    // [32][96]
  float* acc_b = acc_wh + kDm * kG;          // [96]

  if (row < B) {  // a warp past the last row skips to the block sum
    const float b_r = load_f(bias + lane);
    const float b_z = load_f(bias + kDm + lane);
    const float b_c = load_f(bias + 2 * kDm + lane);
    float dh = 0.0f;
    float db_r = 0.0f, db_z = 0.0f, db_c = 0.0f;
    StepIn cur;
    load_step<S>(cur, T - 1, row, lane, B, d_in, n_chunks, x, x_tstride,
                 mask, m_tstride, h0, hseq, dhseq);
    for (int t = T - 1; t >= 0; --t) {
      StepIn nxt;  // step t-1, loaded before this step's math
      if (t > 0)
        load_step<S>(nxt, t - 1, row, lane, B, d_in, n_chunks, x,
                     x_tstride, mask, m_tstride, h0, hseq, dhseq);

      // Recompute the forward's gates (gru_scan_fwd.cu, the same order).
      float ar = 0.0f, az = 0.0f, ac = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c < n_chunks) {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const float xk = __shfl_sync(kFull, cur.x[c], k);
            const float* w = s_wx + (32 * c + k) * kG;
            ar = fmaf(xk, w[lane], ar);
            az = fmaf(xk, w[kDm + lane], az);
            ac = fmaf(xk, w[2 * kDm + lane], ac);
          }
        }
      }
      float gr = 0.0f, gz = 0.0f, gc = 0.0f;
#pragma unroll
      for (int k = 0; k < kDm; ++k) {
        const float hk = __shfl_sync(kFull, cur.hp, k);
        const float* w = s_wh + k * kG;
        gr = fmaf(hk, w[lane], gr);
        gz = fmaf(hk, w[kDm + lane], gz);
        gc = fmaf(hk, w[2 * kDm + lane], gc);
      }
      StepGrad sg;
      if constexpr (kBf16)
        sg = step_grad_bf16(
            hpmn::gates_bf16(ar, az, ac, gr, gz, gc, b_r, b_z, b_c), cur, dh,
            mask != nullptr);
      else
        sg = step_grad_f32(
            hpmn::gates_f32(ar, az, ac, gr, gz, gc, b_r, b_z, b_c), cur, dh);
      const float dr = sg.dr, dz = sg.dz, dc = sg.dc, dcr = sg.dcr;

      // dh_prev and dx_t from the transposed weights.
      float dh_new = kBf16 ? 0.0f : sg.carry;
      float dxa[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) dxa[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < kDm; ++k) {
        const float drk = __shfl_sync(kFull, dr, k);
        const float dzk = __shfl_sync(kFull, dz, k);
        const float dck = __shfl_sync(kFull, dc, k);
        const float dcrk = __shfl_sync(kFull, dcr, k);
        dh_new = fmaf(drk, s_whT[k * kDm + lane], dh_new);
        dh_new = fmaf(dzk, s_whT[(kDm + k) * kDm + lane], dh_new);
        dh_new = fmaf(dcrk, s_whT[(2 * kDm + k) * kDm + lane], dh_new);
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          if (c < n_chunks) {
            const int i = 32 * c + lane;
            dxa[c] = fmaf(drk, s_wxT[k * d_in_pad + i], dxa[c]);
            dxa[c] = fmaf(dzk, s_wxT[(kDm + k) * d_in_pad + i], dxa[c]);
            dxa[c] = fmaf(dck, s_wxT[(2 * kDm + k) * d_in_pad + i], dxa[c]);
          }
        }
      }
      if (kBf16) dh_new = sg.carry + dh_new;
      S* dx_row = dx + ((long long)t * B + row) * d_in;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int i = 32 * c + lane;
        if (c < n_chunks && i < d_in) hpmn::store_f(dx_row + i, dxa[c]);
      }

      // Weight gradients: lane j owns column j of each gate block.
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c < n_chunks) {
#pragma unroll 8
          for (int k = 0; k < 32; ++k) {
            const float xk = __shfl_sync(kFull, cur.x[c], k);
            float* a = acc_wx + (32 * c + k) * kG;
            a[lane] = fmaf(xk, dr, a[lane]);
            a[kDm + lane] = fmaf(xk, dz, a[kDm + lane]);
            a[2 * kDm + lane] = fmaf(xk, dc, a[2 * kDm + lane]);
          }
        }
      }
#pragma unroll 8
      for (int k = 0; k < kDm; ++k) {
        const float hk = __shfl_sync(kFull, cur.hp, k);
        float* a = acc_wh + k * kG;
        a[lane] = fmaf(hk, dr, a[lane]);
        a[kDm + lane] = fmaf(hk, dz, a[kDm + lane]);
        a[2 * kDm + lane] = fmaf(hk, dcr, a[2 * kDm + lane]);
      }
      db_r += dr;
      db_z += dz;
      db_c += dc;
      dh = dh_new;
      if (t > 0) cur = nxt;
    }
    dh0[(long long)row * kDm + lane] = dh;
    acc_b[lane] = db_r;
    acc_b[kDm + lane] = db_z;
    acc_b[2 * kDm + lane] = db_c;
  }
  __syncthreads();

  // This block's partial: the sum of its warps' slices.
  float* out_wx = dwx_part + (long long)blockIdx.x * d_in * kG;
  for (int i = threadIdx.x; i < d_in * kG; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += s_acc[w * acc_n + i];
    out_wx[i] = s;
  }
  float* out_wh = dwh_part + (long long)blockIdx.x * kDm * kG;
  for (int i = threadIdx.x; i < kDm * kG; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += s_acc[w * acc_n + d_in_pad * kG + i];
    out_wh[i] = s;
  }
  for (int i = threadIdx.x; i < kG; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w)
      s += s_acc[w * acc_n + (d_in_pad + kDm) * kG + i];
    db_part[(long long)blockIdx.x * kG + i] = s;
  }
}

// x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B] (time
// stride m_tstride) or null, wx [d_in,96], wh [32,96], b [96], h0 [B,32] or
// null, hseq and dhseq [T,B,32] contiguous, all of one type S: float for K2,
// bf16 for K2-bf16. Writes dx [T,B,d_in] (S) and dh0 [B,32] (f32, the
// carry), both contiguous, and per block the f32 partials dwx_part
// [d_in,96], dwh_part [32,96] and db_part [96]. Launches on `stream`;
// returns cudaGetLastError().
template <typename S>
int launch(const S* x, long long x_tstride, const S* mask, long long m_tstride,
           const S* wx, const S* wh, const S* b, const S* h0, const S* hseq,
           const S* dhseq, S* dx, float* dh0, float* dwx_part,
           float* dwh_part, float* db_part, int T, int B, int d_in,
           void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const int warps = rows_per_block(d_in);
  const size_t smem =
      (weights_floats(d_in_pad) + warps * acc_floats(d_in_pad)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + warps - 1) / warps;
  gru_scan_bwd_kernel<S><<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      x, x_tstride, mask, m_tstride, wx, wh, b, h0, hseq, dhseq, dx, dh0,
      dwx_part, dwh_part, db_part, T, B, d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// Batch rows per block for this d_in: the wrapper allocates one weight-
// gradient partial per block, ceil(B / rows) of them.
extern "C" int hpmn_gru_scan_bwd_rows_per_block(int d_in) {
  if (d_in < 1 || d_in > 32 * kMaxChunks) return 0;
  return rows_per_block(d_in);
}

extern "C" int hpmn_gru_scan_bwd(const float* x, long long x_tstride,
                                 const float* mask, long long m_tstride,
                                 const float* wx, const float* wh,
                                 const float* b, const float* h0,
                                 const float* hseq, const float* dhseq,
                                 float* dx, float* dh0, float* dwx_part,
                                 float* dwh_part, float* db_part, int T,
                                 int B, int d_in, void* stream) {
  return launch(x, x_tstride, mask, m_tstride, wx, wh, b, h0, hseq, dhseq, dx,
                dh0, dwx_part, dwh_part, db_part, T, B, d_in, stream);
}

extern "C" int hpmn_gru_scan_bwd_bf16(
    const __nv_bfloat16* x, long long x_tstride, const __nv_bfloat16* mask,
    long long m_tstride, const __nv_bfloat16* wx, const __nv_bfloat16* wh,
    const __nv_bfloat16* b, const __nv_bfloat16* h0,
    const __nv_bfloat16* hseq, const __nv_bfloat16* dhseq,
    __nv_bfloat16* dx, float* dh0, float* dwx_part, float* dwh_part,
    float* db_part, int T, int B, int d_in, void* stream) {
  return launch(x, x_tstride, mask, m_tstride, wx, wh, b, h0, hseq, dhseq, dx,
                dh0, dwx_part, dwh_part, db_part, T, B, d_in, stream);
}

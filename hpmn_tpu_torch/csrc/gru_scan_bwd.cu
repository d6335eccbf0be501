// GRU scan backward for Hopper (sm_90a): one launch sweeps one whole layer
// in reverse.
//
// Replaces hpmn_tpu/ops/pallas_gru.py::_bwd_kernel (its mask and no-mask
// forms, f32 chain, no AUGRU scale). Per step t = T-1 .. 0, for batch row b,
// with m_t = 1 when there is no mask:
//
//   h_prev = h_seq[t-1]            (h0, or zeros, at t = 0)
//   r, z, c, g_c recomputed from x_t and h_prev with gru_scan_fwd.cu's
//   formulas, bit for bit (1/(1+expf(-v)), tanhf, the same fmaf order)
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
// What bounds it: the recurrence, as in the forward. Each step needs the dh
// of the step after it, and per step and row the work is small: about 36k
// FLOPs in five 32-wide products (recompute x@wx and h@wh, dh, dx, the two
// weight-gradient outer products). Per row and step it streams 128 B of x,
// h_seq and dh_seq each in and 128 B of dx out. Latency and issue bound it.
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

#include <cuda_runtime.h>

namespace {

constexpr int kDm = 32;          // hidden width: one lane per hidden unit
constexpr int kG = 3 * kDm;      // the r, z and c blocks
constexpr int kMaxWarps = 4;     // batch rows per block, at most
constexpr int kMaxChunks = 3;    // d_in <= 96
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

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
  float m;              // mask_t
};

__device__ __forceinline__ void load_step(
    StepIn& s, int t, int row, int lane, int B, int d_in, int n_chunks,
    const float* __restrict__ x, long long x_tstride,
    const float* __restrict__ mask, long long m_tstride,
    const float* __restrict__ h0, const float* __restrict__ hseq,
    const float* __restrict__ dhseq) {
  const float* x_row = x + (long long)t * x_tstride + (long long)row * d_in;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = 32 * c + lane;
    s.x[c] = (c < n_chunks && k < d_in) ? x_row[k] : 0.0f;
  }
  if (t > 0)
    s.hp = hseq[((long long)(t - 1) * B + row) * kDm + lane];
  else
    s.hp = h0 != nullptr ? h0[(long long)row * kDm + lane] : 0.0f;
  s.dhs = dhseq[((long long)t * B + row) * kDm + lane];
  s.m = mask != nullptr ? mask[(long long)t * m_tstride + row] : 1.0f;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
gru_scan_bwd_kernel(const float* __restrict__ x, long long x_tstride,
                    const float* __restrict__ mask, long long m_tstride,
                    const float* __restrict__ wx, const float* __restrict__ wh,
                    const float* __restrict__ bias,
                    const float* __restrict__ h0,
                    const float* __restrict__ hseq,
                    const float* __restrict__ dhseq,
                    float* __restrict__ dx, float* __restrict__ dh0,
                    float* __restrict__ dwx_part, float* __restrict__ dwh_part,
                    float* __restrict__ db_part, int T, int B, int d_in) {
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
    const float w = r < d_in ? wx[i] : 0.0f;
    s_wx[i] = w;
    s_wxT[col * d_in_pad + r] = w;
  }
  for (int i = threadIdx.x; i < kDm * kG; i += blockDim.x) {
    const int r = i / kG, col = i - r * kG;
    s_wh[i] = wh[i];
    s_whT[col * kDm + r] = wh[i];
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
    const float b_r = bias[lane];
    const float b_z = bias[kDm + lane];
    const float b_c = bias[2 * kDm + lane];
    float dh = 0.0f;
    float db_r = 0.0f, db_z = 0.0f, db_c = 0.0f;
    StepIn cur;
    load_step(cur, T - 1, row, lane, B, d_in, n_chunks, x, x_tstride, mask,
              m_tstride, h0, hseq, dhseq);
    for (int t = T - 1; t >= 0; --t) {
      StepIn nxt;  // step t-1, loaded before this step's math
      if (t > 0)
        load_step(nxt, t - 1, row, lane, B, d_in, n_chunks, x, x_tstride,
                  mask, m_tstride, h0, hseq, dhseq);

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
      const float r = sigmoid_f((ar + b_r) + gr);
      const float z = sigmoid_f((az + b_z) + gz);
      const float cand = tanhf((ac + b_c) + r * gc);

      const float gtot = cur.dhs + dh;
      const float gcell = gtot * cur.m;
      const float dzs = gcell * (cand - cur.hp);
      const float dc = gcell * z * (1.0f - cand * cand);
      const float dz = dzs * z * (1.0f - z);
      const float dr = dc * gc * r * (1.0f - r);
      const float dcr = dc * r;

      // dh_prev and dx_t from the transposed weights.
      float dh_new = gcell * (1.0f - z) + (gtot - gcell);
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
      float* dx_row = dx + ((long long)t * B + row) * d_in;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int i = 32 * c + lane;
        if (c < n_chunks && i < d_in) dx_row[i] = dxa[c];
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

}  // namespace

// Batch rows per block for this d_in: the wrapper allocates one weight-
// gradient partial per block, ceil(B / rows) of them.
extern "C" int hpmn_gru_scan_bwd_rows_per_block(int d_in) {
  if (d_in < 1 || d_in > 32 * kMaxChunks) return 0;
  return rows_per_block(d_in);
}

// x [T,B,d_in] (time stride x_tstride, rows contiguous), mask [T,B] (time
// stride m_tstride) or null, wx [d_in,96], wh [32,96], b [96], h0 [B,32] or
// null, hseq and dhseq [T,B,32] contiguous. Writes dx [T,B,d_in] and dh0
// [B,32] (contiguous), and per block dwx_part [d_in,96], dwh_part [32,96]
// and db_part [96]. Launches on `stream`; returns cudaGetLastError().
extern "C" int hpmn_gru_scan_bwd(const float* x, long long x_tstride,
                                 const float* mask, long long m_tstride,
                                 const float* wx, const float* wh,
                                 const float* b, const float* h0,
                                 const float* hseq, const float* dhseq,
                                 float* dx, float* dh0, float* dwx_part,
                                 float* dwh_part, float* db_part, int T,
                                 int B, int d_in, void* stream) {
  if (d_in < 1 || d_in > 32 * kMaxChunks || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const int d_in_pad = (d_in + 31) / 32 * 32;
  const int warps = rows_per_block(d_in);
  const size_t smem =
      (weights_floats(d_in_pad) + warps * acc_floats(d_in_pad)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + warps - 1) / warps;
  gru_scan_bwd_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      x, x_tstride, mask, m_tstride, wx, wh, b, h0, hseq, dhseq, dx, dh0,
      dwx_part, dwh_part, db_part, T, B, d_in);
  return (int)cudaGetLastError();
}

// Device code shared by the GRU scan kernels (gru_scan_fwd.cu K1, K1-scale
// and K3, gru_scan_bwd.cu K2 and K2-scale, gru_scan_stride_fwd.cu K3's
// one-kernel form, gru_scan_stride_bwd.cu K4): the stream conversions, the
// projections and the gate chain, so that a backward recomputes (or
// replays) its forward's gates bit for bit; the launchers of the input
// projection of K1, K3 and K4 (gru_input_proj.cu) and of K2's and K4's dx
// and weight-gradient pass
// (gru_bwd_pass.cu); the strided scan's step; one step's gate gradients,
// with or without the AUGRU gate scale, and the warp sum of its dscale;
// four-value loads and stores of the stream type; cp.async copies (also
// readout_fwd.cu's, K5's); the per-device SM count (K1's projection's and
// K5's grids); and the shared-memory pieces of the backward kernels.
//
// Two chains, as hpmn_tpu/ops/pallas_gru.py has them:
//
// - f32 (dtype=float32): the formulas of the port's first K1, unchanged:
//   sigmoid 1/(1+expf(-v)), sums (x@wx + b) + h@wh.
// - bf16 (dtype=bfloat16): x, h, the weights, the mask and h_seq are bf16.
//   The products are f32 fmaf chains over bf16 values (exact products, as
//   the MXU's), summed in the TPU kernel's order (x@wx4 + h@wh4) + b4 and
//   rounded to bf16 once per pre-activation block: r, z, the candidate's x
//   part pre_c and its h part g_c (the packed zero blocks of wx4/wh4 keep
//   those two apart). From there every op rounds to bf16, and sigmoid is
//   0.5*tanh(0.5 v)+0.5, tanh being tanhf of the f32 value, rounded. The
//   ops are the _rn intrinsics, which nvcc does not contract into an FMA
//   that would skip a rounding the TPU kernel makes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace hpmn {

constexpr int kDm = 32;  // hidden width: one lane per hidden unit
constexpr int kG = 3 * kDm;  // the r, z and c blocks
constexpr int kMaxChunks = 3;  // d_in <= 96: x_t in up to three 32-chunks
constexpr unsigned kFull = 0xffffffffu;

// The SM count of the current device, looked up once per device (the
// launchers size their grids by it; the Python wrappers make the tensors'
// device current around every launch). Devices past kMaxDevices are looked
// up on every call.
constexpr int kMaxDevices = 64;
inline int sm_count() {
  static int n_sm[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && n_sm[dev] > 0) return n_sm[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < kMaxDevices) n_sm[dev] = n;
  return n;
}

// The input projection of K1, K1-scale, K3 and K4 (and of their bf16
// forms) into the f32 workspace xp [T, B, 96]
// (x at time stride x_tstride, rows contiguous; S is float or
// __nv_bfloat16), each output an fmaf chain from 0 over k = 0 ... d_in-1:
// the bits of project()'s x part. In f32 every block then gets + b (xp =
// x @ wx + b, what gates_f32_xp reads); in bf16 the r and z blocks stay
// without the bias (the chain sums (x@wx + h@wh) + b) and the c block is
// ac + b_c rounded to bf16, held as f32 (gates_bf16_xp's pre_c). Launches
// on `stream`; returns cudaGetLastError().
template <typename S>
int launch_input_proj(const S* x, long long x_tstride, const S* wx,
                      const S* b, float* xp, int T, int B, int d_in,
                      cudaStream_t stream);

// The second kernel of K2, K2-scale and K4 and their bf16 forms
// (gru_bwd_pass.cu),
// per chunk of steps [t0, t0 + n): from x (time stride x_tstride, rows
// contiguous), wx [d_in, 96], h_prev and the recurrence's gate gradients dg
// [n, B, 32, 4] (lane k: dr, dz, dc, dc*r), writes dx [T, B, d_in] and
// carries each row's weight-gradient sums in acc [B, acc_floats(d_in_pad)]
// (f32; `first`: start them at zero). h_prev of step t is hprev[t - hp_t0]
// ([., B, 32] contiguous) for t >= hp_t0, else h0 (or zeros): K2 passes
// h_seq and 1, K4 its h_prev workspace and t0. S is float or
// __nv_bfloat16. Launches on `stream`; returns cudaGetLastError().
template <typename S>
int launch_bwd_pass(const S* x, long long x_tstride, const S* wx,
                    const S* h0, const S* hprev, int hp_t0, const S* dg,
                    S* dx, float* acc, int t0, int n, bool first, int B,
                    int d_in, cudaStream_t stream);

// After the last chunk: one f32 partial per group of `rows` batch rows,
// 0.0f + row 0 + row 1 + ..., into dwx_part [d_in][96], dwh_part [32][96]
// and db_part [96] at the group's index (write_wgrad_partials' sums over
// the one-kernel loop's blocks of rows). Returns cudaGetLastError().
int launch_wgrad_partials(const float* acc, int rows, int B, int d_in,
                          float* dwx_part, float* dwh_part, float* db_part,
                          cudaStream_t stream);

template <typename S>
constexpr bool kIsBf16 = std::is_same<S, __nv_bfloat16>::value;

// cp.async: one 4-byte copy from device to shared memory, issued without
// waiting; a commit closes this thread's copies so far into a group, and
// copy_async_wait<N> returns when at most N of its groups are pending. The
// "memory" clobbers keep the compiler from moving other memory accesses
// across them.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Streams in device memory are S (float or bf16); registers hold float.
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The bf16 chain's values are __nv_bfloat16 (B), and each of its ops is one
// native bf16 instruction (mul/add/sub .rn.bf16: one rounding each, the
// correctly rounded result, so the same bits as the f32 op then a rounding
// to bf16, which the plain PyTorch version computes).
using B = __nv_bfloat16;
__device__ __forceinline__ B to_b(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float to_f(B v) { return __bfloat162float(v); }
__device__ __forceinline__ B mul_b(B a, B b) { return __hmul_rn(a, b); }
__device__ __forceinline__ B add_b(B a, B b) { return __hadd_rn(a, b); }
__device__ __forceinline__ B sub_b(B a, B b) { return __hsub_rn(a, b); }
__device__ __forceinline__ B half_b() { return __ushort_as_bfloat16(0x3F00); }
__device__ __forceinline__ B one_b() { return __ushort_as_bfloat16(0x3F80); }

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// pallas_gru.py::_sigmoid in bf16: half * tanh(half * v) + half; tanh is
// tanhf of the f32 value, rounded.
__device__ __forceinline__ B sigmoid_bf16(B v) {
  return add_b(mul_b(half_b(), to_b(tanhf(to_f(mul_b(half_b(), v))))),
               half_b());
}

// x_t's row of one batch row for project(), lane k of chunk c holding
// element 32*c + k, prefetched a step ahead in the stream type S and
// converted to f32 only at the top of the step that uses it (load_x_raw,
// then convert_x). Converted right after its load instead, as the
// compiler schedules a conversion of a freshly loaded bf16 value, the
// prefetch stalls the warp on the load every step: K3-bf16 took 3.07 ms
// at T = 1000, B = 512 that way and 1.43 ms this way (PERF.md). xr starts
// at zero; lanes past d_in keep it. `more` is false past the last step;
// keep it inside the one condition: with `if (more)` around the call,
// ptxas issued the loads ahead of the x projection and K3 (f32) took 1.94
// ms instead of 0.94, the same bits.
template <typename S>
__device__ __forceinline__ void load_x_raw(S (&xr)[kMaxChunks], const S* x_t,
                                           bool more, int n_chunks, int d_in,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = 32 * c + lane;
    if (more && c < n_chunks && k < d_in) xr[c] = x_t[k];
  }
}

template <typename S>
__device__ __forceinline__ void convert_x(const S (&xr)[kMaxChunks],
                                          float (&xv)[kMaxChunks]) {
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) xv[c] = load_f(&xr[c]);
}

// One step's projections for lane's column of each gate block: a* = x_t @
// wx, g* = h @ wh. xv[c] holds x_t[32*c + lane]; s_wx [d_in_pad][96] and
// s_wh [32][96] are row-major in shared memory. The fmaf order (x chunk by
// chunk, then h) is K1's, which every kernel that recomputes K1's gates
// keeps.
struct Proj {
  float ar, az, ac, gr, gz, gc;
};

__device__ __forceinline__ Proj project(const float (&xv)[kMaxChunks],
                                        int n_chunks, float h,
                                        const float* s_wx, const float* s_wh,
                                        int lane) {
  Proj p;
  p.ar = p.az = p.ac = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < n_chunks) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float xk = __shfl_sync(kFull, xv[c], k);
        const float* w = s_wx + (32 * c + k) * kG;
        p.ar = fmaf(xk, w[lane], p.ar);
        p.az = fmaf(xk, w[kDm + lane], p.az);
        p.ac = fmaf(xk, w[2 * kDm + lane], p.ac);
      }
    }
  }
  p.gr = p.gz = p.gc = 0.0f;
#pragma unroll
  for (int k = 0; k < kDm; ++k) {
    const float hk = __shfl_sync(kFull, h, k);
    const float* w = s_wh + k * kG;
    p.gr = fmaf(hk, w[lane], p.gr);
    p.gz = fmaf(hk, w[kDm + lane], p.gz);
    p.gc = fmaf(hk, w[2 * kDm + lane], p.gc);
  }
  return p;
}

struct Gates {
  float r, z, c;  // reset, update, candidate
  float gc;       // h @ wh_c: the candidate's h part, as the backward uses it
};

// f32 chain: one step's gates from the input projection with its bias,
// xp_* = x_t @ wx_* + b_* (K1 computes it ahead of the recurrence,
// gru_input_proj.cu; the others as p.a* + b_*, the same bits), and the h
// projection g_* = h @ wh_*. The expressions are written once, here, so
// that nvcc contracts r * g_c + xp_c into one fma wherever they run.
__device__ __forceinline__ Gates gates_f32_xp(float xp_r, float xp_z,
                                              float xp_c, float g_r,
                                              float g_z, float g_c) {
  Gates g;
  g.r = sigmoid_f32(xp_r + g_r);
  g.z = sigmoid_f32(xp_z + g_z);
  g.c = tanhf(xp_c + g.r * g_c);
  g.gc = g_c;
  return g;
}

// f32 chain: one step's gates from the projections and the bias b_*.
__device__ __forceinline__ Gates gates_f32(const Proj& p, float b_r,
                                           float b_z, float b_c) {
  return gates_f32_xp(p.ar + b_r, p.az + b_z, p.ac + b_c, p.gr, p.gz, p.gc);
}

// f32 chain: the dense forward's update, h_cell = h + zs*(c - h) (zs = z,
// or z*a_t in the AUGRU), then h + m*(h_cell - h) (m = 1 with no mask).
__device__ __forceinline__ float update_f32(float zs, float c, float h,
                                            float m) {
  const float h_cell = h + zs * (c - h);
  return h + m * (h_cell - h);
}

struct GatesB {
  B r, z, c, gc;
};

// bf16 chain: the same from f32 sums of bf16 products; each block rounded
// once, in the TPU kernel's order (x@wx4 + h@wh4) + b4. From the x parts
// a_r = x_t @ wx_r and a_z (without the bias), the candidate's x part with
// its bias xp_c = a_c + b_c (K1-bf16 reads it already rounded, from
// gru_input_proj.cu; rounding it again changes nothing), the h parts g_*
// and the r and z biases. Written once, here, for every bf16 kernel.
__device__ __forceinline__ GatesB gates_bf16_xp(float a_r, float a_z,
                                                float xp_c, float g_r,
                                                float g_z, float g_c,
                                                float b_r, float b_z) {
  GatesB g;
  const B pre_c = to_b(xp_c);
  g.gc = to_b(g_c);
  g.r = sigmoid_bf16(to_b((a_r + g_r) + b_r));
  g.z = sigmoid_bf16(to_b((a_z + g_z) + b_z));
  g.c = to_b(tanhf(to_f(add_b(pre_c, mul_b(g.r, g.gc)))));
  return g;
}

// bf16 chain: one step's gates from the projections and the bias b_*.
__device__ __forceinline__ GatesB gates_bf16(const Proj& p, float b_r,
                                             float b_z, float b_c) {
  return gates_bf16_xp(p.ar, p.az, p.ac + b_c, p.gr, p.gz, p.gc, b_r, b_z);
}

// The strided scan's chunk: K3 writes the state at the start of every
// chunk of kStrideChunk steps, and K4 replays one chunk at a time from it,
// keeping the chunk's states in shared memory.
constexpr int kStrideChunk = 16;

// The strided scan's step (K3, and K4's replay of it): the no-mask update
// h + z*(c - h) of pallas_gru.py::_fwd_stride_kernel. In f32 each op is
// one _rn intrinsic, so nvcc fuses none of them and the plain version's
// three roundings are the kernel's; in bf16 it is K1-bf16's no-mask h_cell.
__device__ __forceinline__ float stride_update(const Gates& g, float h) {
  return __fadd_rn(h, __fmul_rn(g.z, __fsub_rn(g.c, h)));
}
__device__ __forceinline__ B stride_update(const GatesB& g, B h) {
  return add_b(h, mul_b(g.z, sub_b(g.c, h)));
}

// One step's gate gradients (dpre blocks) and the carry's own term, from
// the step's gates, h_prev, the cotangent gtot that reaches h_t (the
// output's plus the carry dh), the mask m_t (1 with none) and, with kScale
// (the AUGRU, pallas_gru.py's has_scale), the gate scale a_t: zs = z*a_t
// takes z's place in the update, so dc and the carry read zs and dz gains
// the factor a_t.
struct StepGrad {
  float dr, dz, dc, dcr;
  float carry;  // dh_prev before the products with wh^T
  float da;     // with kScale: this lane's term dzs*z of dscale[t, row]
};

// f32: the port's first K2 formulas. The carry's term is the start of the
// fmaf chain of dh_prev. Without kScale the expressions are K2's, so its
// instantiations keep their bits.
template <bool kScale = false>
__device__ __forceinline__ StepGrad step_grad_f32(const Gates& g, float hp,
                                                  float gtot, float m,
                                                  float a = 1.0f) {
  StepGrad o;
  const float gcell = gtot * m;
  const float dzs = gcell * (g.c - hp);
  if constexpr (kScale) {
    const float zs = g.z * a;
    o.dc = gcell * zs * (1.0f - g.c * g.c);
    o.dz = dzs * a * g.z * (1.0f - g.z);
    o.carry = gcell * (1.0f - zs) + (gtot - gcell);
    o.da = dzs * g.z;
  } else {
    o.dc = gcell * g.z * (1.0f - g.c * g.c);
    o.dz = dzs * g.z * (1.0f - g.z);
    o.carry = gcell * (1.0f - g.z) + (gtot - gcell);
    o.da = 0.0f;
  }
  o.dr = o.dc * g.gc * g.r * (1.0f - g.r);
  o.dcr = o.dc * g.r;
  return o;
}

// bf16: pallas_gru.py::_bwd_kernel (and _bwd_stride_kernel) with
// dtype=bfloat16, op by op; gtot is already rounded to bf16 from its f32
// sum. The carry's term is added to the f32 sum of the products
// afterwards, as the TPU kernel adds it to its dot. With kScale: zs =
// z*a, dc = (gcell*zs)*(1-c^2), dz = ((dzs*a)*z)*(1-z), carry = gcell -
// gcell*zs, and da = dzs*z as an f32 product of the two bf16 values (exact,
// not rounded: what XLA computes for the TPU kernel's jnp.sum(dzs * z) in
// interpret mode, the sum in f32, rounded once at the store).
template <bool kScale = false>
__device__ __forceinline__ StepGrad step_grad_bf16(const GatesB& g, B hp,
                                                   B gtot, B m, bool masked,
                                                   B a = one_b()) {
  const B one = one_b();
  const B gcell = mul_b(gtot, m);
  const B dzs = mul_b(gcell, sub_b(g.c, hp));
  const B zs = kScale ? mul_b(g.z, a) : g.z;
  const B dc = mul_b(mul_b(gcell, zs), sub_b(one, mul_b(g.c, g.c)));
  const B dz = mul_b(mul_b(kScale ? mul_b(dzs, a) : dzs, g.z),
                     sub_b(one, g.z));
  const B dr = mul_b(mul_b(mul_b(dc, g.gc), g.r), sub_b(one, g.r));
  B carry = sub_b(gcell, mul_b(gcell, zs));
  if (masked) carry = add_b(carry, sub_b(gtot, gcell));
  StepGrad o;
  o.dr = to_f(dr);
  o.dz = to_f(dz);
  o.dc = to_f(dc);
  o.dcr = to_f(mul_b(dc, g.r));
  o.carry = to_f(carry);
  o.da = kScale ? to_f(dzs) * to_f(g.z) : 0.0f;
  return o;
}

// dscale[t, row] = sum over the warp's lanes of StepGrad::da: an f32
// __shfl_xor_sync tree (every lane ends with the sum; lane 0 stores it).
// It reads only this step's gate gradients, so it sits beside the dh
// carry's chain, not on it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// ---- The one-kernel backward loop's shared memory (K4's one-kernel form,
// kept for comparisons), per block: the weights row-major (the recompute reads them) and transposed
// (dh and dx read them along rows: lane j needs w[j][g*32+k] for a k shared
// by the warp, a 32-way bank conflict in the row-major copy), then per
// warp the weight-gradient accumulators dWx [d_in_pad][96], dWh [32][96],
// db [96], where lane j owns column j of each gate block: no atomics, no
// bank conflicts. The block sums its warps' slices into one f32 partial; the
// wrapper sums the partials (as the TPU kernel emits one per batch tile).
constexpr size_t kMaxSmem = 232448;  // a block's shared-memory limit

__host__ __device__ __forceinline__ size_t weights_floats(int d_in_pad) {
  return (size_t)2 * (d_in_pad + kDm) * kG;
}
__host__ __device__ __forceinline__ size_t acc_floats(int d_in_pad) {
  return (size_t)(d_in_pad + kDm + 1) * kG;
}

struct BwdSmem {
  float* wx;   // [d_in_pad][96], zero rows past d_in
  float* wxT;  // [96][d_in_pad]
  float* wh;   // [32][96]
  float* whT;  // [96][32]
  float* acc;  // this warp's accumulators: acc_floats()
  float* end;  // past the last warp's accumulators
};

// Carve the block's shared memory, load the weights (as f32) and zero
// every warp's accumulators. Ends with a block barrier.
template <typename S>
__device__ __forceinline__ BwdSmem load_bwd_smem(float* smem, const S* wx,
                                                 const S* wh, int d_in,
                                                 int d_in_pad, int warps,
                                                 int warp) {
  BwdSmem s;
  s.wx = smem;
  s.wxT = s.wx + d_in_pad * kG;
  s.wh = s.wxT + kG * d_in_pad;
  s.whT = s.wh + kDm * kG;
  float* acc0 = s.whT + kG * kDm;
  const int acc_n = (int)acc_floats(d_in_pad);
  s.acc = acc0 + warp * acc_n;
  s.end = acc0 + warps * acc_n;
  for (int i = threadIdx.x; i < d_in_pad * kG; i += blockDim.x) {
    const int r = i / kG, col = i - r * kG;
    const float w = r < d_in ? load_f(wx + i) : 0.0f;
    s.wx[i] = w;
    s.wxT[col * d_in_pad + r] = w;
  }
  for (int i = threadIdx.x; i < kDm * kG; i += blockDim.x) {
    const int r = i / kG, col = i - r * kG;
    const float w = load_f(wh + i);
    s.wh[i] = w;
    s.whT[col * kDm + r] = w;
  }
  for (int i = threadIdx.x; i < warps * acc_n; i += blockDim.x)
    acc0[i] = 0.0f;
  __syncthreads();
  return s;
}

// Four stream values at p (16 bytes in f32, 8 in bf16; p aligned to that).
// The bf16 chain's gate gradients are bf16 values, so their rounding is
// exact.
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&lo);
  v.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// dh_prev = carry + [dr|dz|dc*r] @ wh^T and dx_t = [dr|dz|dc] @ wx^T, from
// the transposed weights; writes dx_t's row (S) and returns dh_prev. In
// bf16 the carry's term is added after the f32 sum of the products, as the
// TPU kernel adds it to its dot.
template <typename S>
__device__ __forceinline__ float backprop_step(const StepGrad& sg,
                                               const BwdSmem& s, int n_chunks,
                                               int d_in, int d_in_pad,
                                               int lane, S* dx_row) {
  constexpr bool kBf16 = kIsBf16<S>;
  float dh_new = kBf16 ? 0.0f : sg.carry;
  float dxa[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) dxa[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kDm; ++k) {
    const float drk = __shfl_sync(kFull, sg.dr, k);
    const float dzk = __shfl_sync(kFull, sg.dz, k);
    const float dck = __shfl_sync(kFull, sg.dc, k);
    const float dcrk = __shfl_sync(kFull, sg.dcr, k);
    dh_new = fmaf(drk, s.whT[k * kDm + lane], dh_new);
    dh_new = fmaf(dzk, s.whT[(kDm + k) * kDm + lane], dh_new);
    dh_new = fmaf(dcrk, s.whT[(2 * kDm + k) * kDm + lane], dh_new);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < n_chunks) {
        const int i = 32 * c + lane;
        dxa[c] = fmaf(drk, s.wxT[k * d_in_pad + i], dxa[c]);
        dxa[c] = fmaf(dzk, s.wxT[(kDm + k) * d_in_pad + i], dxa[c]);
        dxa[c] = fmaf(dck, s.wxT[(2 * kDm + k) * d_in_pad + i], dxa[c]);
      }
    }
  }
  if (kBf16) dh_new = sg.carry + dh_new;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = 32 * c + lane;
    if (c < n_chunks && i < d_in) store_f(dx_row + i, dxa[c]);
  }
  return dh_new;
}

// dWx += x_t^T [dr|dz|dc] and dWh += h_prev^T [dr|dz|dc*r] into this
// warp's accumulators (db is summed in registers by the caller).
__device__ __forceinline__ void accumulate_wgrad(
    const float (&xv)[kMaxChunks], float hp, const StepGrad& sg,
    const BwdSmem& s, int n_chunks, int d_in_pad, int lane) {
  float* acc_wx = s.acc;                     // [d_in_pad][96]
  float* acc_wh = s.acc + d_in_pad * kG;     // [32][96]
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < n_chunks) {
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float xk = __shfl_sync(kFull, xv[c], k);
        float* a = acc_wx + (32 * c + k) * kG;
        a[lane] = fmaf(xk, sg.dr, a[lane]);
        a[kDm + lane] = fmaf(xk, sg.dz, a[kDm + lane]);
        a[2 * kDm + lane] = fmaf(xk, sg.dc, a[2 * kDm + lane]);
      }
    }
  }
#pragma unroll 8
  for (int k = 0; k < kDm; ++k) {
    const float hk = __shfl_sync(kFull, hp, k);
    float* a = acc_wh + k * kG;
    a[lane] = fmaf(hk, sg.dr, a[lane]);
    a[kDm + lane] = fmaf(hk, sg.dz, a[kDm + lane]);
    a[2 * kDm + lane] = fmaf(hk, sg.dcr, a[2 * kDm + lane]);
  }
}

// After a block barrier: this block's partial, the sum of its warps'
// slices, into dwx_part [d_in][96], dwh_part [32][96] and db_part [96] at
// the block's index.
__device__ __forceinline__ void write_wgrad_partials(
    const BwdSmem& s, int warps, int d_in, int d_in_pad,
    float* __restrict__ dwx_part, float* __restrict__ dwh_part,
    float* __restrict__ db_part) {
  const float* acc0 = s.whT + kG * kDm;
  const int acc_n = (int)acc_floats(d_in_pad);
  float* out_wx = dwx_part + (long long)blockIdx.x * d_in * kG;
  for (int i = threadIdx.x; i < d_in * kG; i += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < warps; ++w) sum += acc0[w * acc_n + i];
    out_wx[i] = sum;
  }
  float* out_wh = dwh_part + (long long)blockIdx.x * kDm * kG;
  for (int i = threadIdx.x; i < kDm * kG; i += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < warps; ++w)
      sum += acc0[w * acc_n + d_in_pad * kG + i];
    out_wh[i] = sum;
  }
  for (int i = threadIdx.x; i < kG; i += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < warps; ++w)
      sum += acc0[w * acc_n + (d_in_pad + kDm) * kG + i];
    db_part[(long long)blockIdx.x * kG + i] = sum;
  }
}

}  // namespace hpmn

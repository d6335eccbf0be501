// Device code shared by the GRU scan kernels (gru_scan_fwd.cu and
// gru_scan_bwd.cu): the stream conversions and the gate chain, so that the
// backward recomputes the forward's gates bit for bit.
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
constexpr unsigned kFull = 0xffffffffu;

template <typename S>
constexpr bool kIsBf16 = std::is_same<S, __nv_bfloat16>::value;

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
// A mask element as B (from an f32 stream: rounded; the f32 kernels never
// use it).
__device__ __forceinline__ B load_b(const float* p) { return to_b(*p); }
__device__ __forceinline__ B load_b(const __nv_bfloat16* p) { return *p; }
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

struct Gates {
  float r, z, c;  // reset, update, candidate
  float gc;       // h @ wh_c: the candidate's h part, as the backward uses it
};

// f32 chain: one step's gates from the projections a* = x_t @ wx (per
// block), g* = h @ wh, and the bias b_*.
__device__ __forceinline__ Gates gates_f32(float ar, float az, float ac,
                                           float gr, float gz, float gc,
                                           float b_r, float b_z, float b_c) {
  Gates g;
  g.r = sigmoid_f32((ar + b_r) + gr);
  g.z = sigmoid_f32((az + b_z) + gz);
  g.c = tanhf((ac + b_c) + g.r * gc);
  g.gc = gc;
  return g;
}

struct GatesB {
  B r, z, c, gc;
};

// bf16 chain: the same from f32 sums of bf16 products; each block rounded
// once, in the TPU kernel's order (x@wx4 + h@wh4) + b4.
__device__ __forceinline__ GatesB gates_bf16(float ar, float az, float ac,
                                             float gr, float gz, float gc,
                                             float b_r, float b_z,
                                             float b_c) {
  GatesB g;
  const B pre_c = to_b(ac + b_c);
  g.gc = to_b(gc);
  g.r = sigmoid_bf16(to_b((ar + gr) + b_r));
  g.z = sigmoid_bf16(to_b((az + gz) + b_z));
  g.c = to_b(tanhf(to_f(add_b(pre_c, mul_b(g.r, g.gc)))));
  return g;
}

}  // namespace hpmn

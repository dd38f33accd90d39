// Shared helpers for the hand-written Hopper kernels of cosy_tpu_torch.
//
// Every kernel takes its element type as a template parameter: float (f32)
// or __nv_bfloat16 (bf16).  Arithmetic is always f32; values are widened on
// load and rounded (round-to-nearest-even) on store.  fp16 is not taken:
// the -1e10 attention bias overflows it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cosy {

// additive bias of a masked key (ops/masks.py NEG_BIAS); never -inf, so a
// fully masked row stays a finite uniform average
constexpr float kNegBias = -1.0e10f;

// dtype codes shared with the Python wrappers (ops/_cuda.py DTYPE_CODE)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to T's precision and widen it back
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// two neighbouring values at once (p 8-byte aligned for float, 4 for bf16)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace cosy

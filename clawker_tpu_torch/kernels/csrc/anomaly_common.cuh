// Shared device helpers of the anomaly kernels (score and fit step).
//
// The rounding points follow the JAX reference (clawker_tpu/analytics/
// anomaly.py): bf16 dot operands with fp32 accumulation, the tanh form of
// GELU in fp32.  Elementwise steps use the _rn intrinsics so that nvcc does
// not contract a multiply and an add into one FMA where the plain PyTorch
// version (kernels/reference.py) rounds twice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace anomaly {

constexpr int kHidden = 128;     // hidden width = threads per block
constexpr int kMaxFeatures = 64;
constexpr int kTileRows = 32;    // rows per block; kernels/anomaly.py TILE_ROWS

constexpr float kGeluC = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float kGeluK = 0.044715f;
constexpr float kGelu3K = 0.134145f;            // 3 * kGeluK

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float gelu_tanh_u(float a) {
  const float a3 = __fmul_rn(__fmul_rn(a, a), a);
  return __fmul_rn(kGeluC, __fadd_rn(a, __fmul_rn(kGeluK, a3)));
}

// a * (0.5 * (1 + tanh(c * (a + k a^3))))  -- jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float a) {
  const float t = tanhf(gelu_tanh_u(a));
  return __fmul_rn(a, __fmul_rn(0.5f, __fadd_rn(1.0f, t)));
}

// d/da of gelu_tanh, in the operation order of reference.gelu_tanh_grad
__device__ __forceinline__ float gelu_tanh_grad(float a) {
  const float t = tanhf(gelu_tanh_u(a));
  const float left = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
  float right = __fmul_rn(__fmul_rn(a, 0.5f), __fsub_rn(1.0f, __fmul_rn(t, t)));
  right = __fmul_rn(right, kGeluC);
  right = __fmul_rn(right, __fadd_rn(1.0f, __fmul_rn(__fmul_rn(kGelu3K, a), a)));
  return __fadd_rn(left, right);
}

}  // namespace anomaly

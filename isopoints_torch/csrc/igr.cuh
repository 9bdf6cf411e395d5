// The IGR field's scalar arithmetic, shared by the tensor-core tile
// (mlp_mma.cuh) on the CUDA cores: softplus with beta = 100 and the bf16
// rounding of an operand.
//
// Replaces the activation of `_igr_kernel` / `_make_igr_forward` in
// isopoints_tpu/ops/pallas_mlp.py (:153, :417). softplus is JAX's
// logaddexp(beta z, 0) = max(beta z, 0) + log1p(exp(-|beta z|)), divided by
// beta, with the accurate expf/log1pf (never -use_fast_math); its derivative
// is sigmoid(beta z). In the bf16 mode every matmul operand is rounded to
// bf16 (to nearest even) where it is stored; biases stay f32. The skip
// scales the row [h, x] by f32(1/sqrt(2)), as JAX rounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace igr {

constexpr float kBeta = 100.f;
constexpr float kInvSqrt2 = 0.70710678118654752f;  // f32(1 / sqrt(2)), as JAX rounds it

__device__ __forceinline__ float operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// softplus(beta z) / beta and its derivative sigmoid(beta z)
__device__ __forceinline__ void softplus(float z, float& a, float& d) {
  const float bz = __fmul_rn(kBeta, z);
  a = __fdiv_rn(__fadd_rn(fmaxf(bz, 0.f), log1pf(expf(-fabsf(bz)))), kBeta);
  d = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-bz)));
}

}  // namespace igr

// The softmax helpers both of K1's bodies share (fusemax_prefill.cu's
// mma.sync body and fusemax_prefill_wgmma.cuh's wgmma body): the finite
// NEG_INF of the reference, the output conversion and exp native or by 6
// multiply-adds.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp(x) for x <= 0 with 6 multiply-adds: 2^n by building the exponent
// field, 2^f on [0, 1) by a Horner chain (fusemax.py:_EXP2_COEFFS).
__device__ __forceinline__ float exp_maccs(float x) {
  float t = fmaxf(x * LOG2E, -126.0f);
  float n = floorf(t);
  float f = t - n;
  float p = 0.00015403530393381608f;
  p = p * f + 0.0013333558146428443f;
  p = p * f + 0.009618129107628477f;
  p = p * f + 0.05550410866482158f;
  p = p * f + 0.24022650695910072f;
  p = p * f + 0.6931471805599453f;
  p = p * f + 1.0f;
  return p * __int_as_float((static_cast<int>(n) + 127) << 23);
}

template <bool MACCS>
__device__ __forceinline__ float fexp(float x) {
  return MACCS ? exp_maccs(x) : expf(x);
}

}  // namespace

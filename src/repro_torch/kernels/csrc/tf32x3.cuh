// Error-compensated 3xTF32 on the tensor cores: the helpers K1
// (fusemax_prefill.cu) and the MLA latent decode body
// (mla_decode_partials.cuh) share.
//
// Each fp32 operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x -
// hi) (cvt.rna.tf32.f32's rounding, done on the integer pipe), and
// mma.sync m16n8k8 accumulates lo·hi + hi·lo + hi·hi (small terms first)
// in fp32, which keeps a product about as accurate as fp32 FMA.  bf16
// operands are exact in TF32: their lo parts are zero and those products
// are skipped.  Single-pass TF32 is never used.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// k-steps a score partial sum takes on the tensor cores before it is
// added to the row's score in IEEE fp32: the mma accumulator truncates,
// so a deep chain on a large sum drifts (at E = 576 with scores in the
// hundreds, one chain over all 72 k-steps broke the fp32 tolerance)
constexpr int KDEPTH = 4;

// cvt.rna.tf32.f32 on the integer pipe: round the 13 dropped mantissa
// bits to nearest, ties away from zero (the same bits as the cvt, which
// runs at a fraction of the rate), for every finite x
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (+ what lo's rounding drops), each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// A shared-memory operand split for the tensor cores; a widened bf16 is
// exact in TF32, so its lo part is 0 (and never multiplied).
__device__ __forceinline__ void load_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  split(x, hi, lo);
}
__device__ __forceinline__ void load_split(__nv_bfloat16 x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// d (16x8) += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: lo·hi + hi·lo + hi·hi, small terms first.  An
// operand that is exact in TF32 (A_EXACT / B_EXACT) has lo = 0, and the
// product with it is skipped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if constexpr (!A_EXACT) mma(d, al, bh0, bh1);
  if constexpr (!B_EXACT) mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

}  // namespace

// 3xTF32 on mma.sync, shared by the kernels that take float32 products on
// the tensor cores (flash_attention_packed.cu, fused_resnet_causal.cu).
//
// A finite float32 value v is split into two TF32 values, hi = tf32(v) and
// lo = tf32(v - hi), both rounded to nearest with ties away from zero (as
// cvt.rna.tf32.f32 rounds): hi + lo is v within 2^-21 relative. A product a.b is
// then taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on m16n8k8 tf32 with
// float32 accumulation; the dropped a_lo.b_lo is ~2^-22 of it. One TF32
// product alone keeps 11 significand bits.

#pragma once

#include <cuda_runtime.h>

// tf32(v) for a finite v, as cvt.rna.tf32.f32 rounds it: half an ulp of the
// 10-bit mantissa added to the bits, the 13 low bits cleared. Two integer
// instructions; cvt.rna.tf32.f32 lowers to four on sm_90 (it keeps inf and
// NaN), and with it the float32 attention body, which splits every operand
// where it reads it, runs ~1.45x as long (scripts/torch_kernel_ablation.py).
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32 values: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(v));
  lo = __uint_as_float(tf32_rna(v - hi));
}

// The same split, as the bit patterns mma.sync takes.
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a . b, m16n8k8, tf32 in, f32 accumulate. Not volatile: the scheduler
// may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

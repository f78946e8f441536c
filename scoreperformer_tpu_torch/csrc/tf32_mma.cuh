// Split-TF32 tensor-core products (`mma.sync`) and cp.async copies of the
// fp32 flash forward (flash_attention_fwd.cu), and the TF32 rounding and
// split that the fp32 backward's `wgmma` operands take too (wgmma.cuh).
//
// fp32 accuracy from TF32 units: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest, ties away (`rna`), and
// a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b, summed in fp32 (the dropped lo.lo
// term and lo's rounding leave an error near 2^-21 relative). The tensor
// cores truncate the fp32 sums they accumulate, so a long chain of products
// in one accumulator drifts toward zero: each k-step's three products start
// from zero and join the running sum by a rounded fp32 add.
//
// Fragments of `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`, with g = lane/4
// and t4 = lane%4: A (16x8) a0 (g, t4), a1 (g+8, t4), a2 (g, t4+4),
// a3 (g+8, t4+4); B (8x8) b0 (k t4, n g), b1 (k t4+4, n g); C (16x8)
// c0 (g, 2t4), c1 (g, 2t4+1), c2 (g+8, 2t4), c3 (g+8, 2t4+1).
//
// The fp32 backward (flash_attention_bwd.cu) and the bf16 kernels
// (flash_attention_fwd_bf16.cu, flash_attention_bwd_bf16.cu) run on
// `wgmma` (wgmma.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// the bits of `cvt.rna.tf32.f32` for every x but a NaN whose payload lies
// in the 13 dropped bits. cvt.rna compiles to a NaN test and a select
// around this add and mask, twice the instructions, and the split is on
// the kernels' hot paths.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32, lo the rounded remainder
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// c += a.b on one m16n8k8 tile
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in split TF32: the three products of this k-step start from zero,
// the small ones first, and join c by rounded fp32 adds.
__device__ __forceinline__ void mma_split(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                          const uint32_t* b_hi, const uint32_t* b_lo) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a_lo, b_hi);
  mma(t, a_hi, b_lo);
  mma(t, a_hi, b_hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// 16 bytes from global to shared memory; zeros when !in
__device__ __forceinline__ void cp_async16(void* smem, const float* gmem, bool in) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// 4 fp32 elements from global to shared memory by cp.async; zeros when !in
__device__ __forceinline__ void load4(float* smem, const float* gmem, bool in) { cp_async16(smem, gmem, in); }

// two adjacent elements (an even index)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

}  // namespace tf32

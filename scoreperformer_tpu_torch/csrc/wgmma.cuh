// Hopper warpgroup MMA (`wgmma`) on tiles in shared memory, filled by TMA:
// bf16 tiles for the bf16 flash-attention forward (flash_attention_fwd_bf16.cu)
// and backward (flash_attention_bwd_bf16.cu), TF32 tiles of fp32 values for
// the fp32 forward and backward (flash_attention_fwd.cu,
// flash_attention_bwd.cu, below "TF32", with the TF32 rounding and split in
// namespace tf32), and the pieces they share: the tensor maps, mbarriers,
// cluster barriers, the key mask's words and the JAX wrapper's keys for a
// query row with no valid key.
//
// A tile is 64 rows of d bf16 values, swizzled as `wgmma` reads it: rows of
// 32 bytes (d = 16), 64 (d = 32) or 128 (d = 64), each 16-byte chunk XORed
// by address bits 7 and up (32-, 64- or 128-byte swizzle); at d = 128 two
// such 64 x 128-byte blocks, columns 0-63 and 64-127. The same bytes serve as
// a K-major operand (rows are M or N, K runs along d: S = Q.K^T and dP =
// dO.V^T) and as an MN-major B operand through the transpose bit (K runs
// along the rows, N along d: P^T.dO, dS^T.Q and dS.K), which bf16 allows.
// Every tile starts on a 1024-byte boundary, so the descriptors need no base
// offset.
//
// Fragments (per warp w of the warpgroup, g = lane/4, t4 = lane%4): the
// fp32 accumulator of m64nNk16 holds d[4j + 2i + c] = (row 16w + g + 8i,
// column 8j + 2t4 + c); the A registers of an m64k16 step kk hold the bf16
// pairs (row 16w + g + 8(r&1), columns 16kk + 8(r>>1) + 2t4, +1), r = 0..3,
// so accumulator elements 8kk + 2r and +1 are A register r of step kk.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// fp32 accuracy from TF32 units: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest, ties away (`rna`), and
// a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b, summed in fp32 (the dropped lo.lo
// term and lo's rounding leave an error near 2^-21 relative). The tensor
// cores truncate the fp32 sums they accumulate, so a long chain of products
// in one accumulator drifts toward zero: the fp32 kernels start each chain
// from zero on a short stretch of its summed dimension and join the chains
// by rounded fp32 adds.
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

// two adjacent elements (an even index)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

}  // namespace tf32

namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the bytes of a 64-row tile of head dim D, and its shared-memory operands
template <int D>
struct Tile {
  static constexpr int kRows = 64;
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;  // a row within one swizzled block
  static constexpr int kBlockBytes = kRows * kRowBytes;
  static constexpr int kBytes = kRows * D * 2;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;  // 128B, 64B, 32B swizzle
};

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}

// the tile at `tile` as a K-major operand (K along d), k-step kk (16 columns)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Tile<D>;
  constexpr int kStepsPerBlock = L::kRowBytes / 32;
  return desc(tile + (kk / kStepsPerBlock) * L::kBlockBytes + (kk % kStepsPerBlock) * 32, 16, 8 * L::kRowBytes,
              L::kLayout);
}

// the tile at `tile` as an MN-major B operand (K along the rows, N along
// d), k-step kk (16 rows); at d = 128 the second 64 columns lie one block on
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = Tile<D>;
  return desc(tile + kk * 16 * L::kRowBytes, L::kBlockBytes, 8 * L::kRowBytes, L::kLayout);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// keeps registers that an asynchronous wgmma reads or writes where they are
// across this point (before wgmma::fence, after wait_all)
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void hold(uint32_t (&a)[N][M][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][j][r])::"memory");
}

// ---- TMA copies and mbarriers ----
//
// A tile comes by TMA (`cp.async.bulk.tensor`) from a 3-d tensor map over
// (d, rows, slabs) with boxes of (min(d, 64), rows, slabs) and the tile's
// swizzle, which writes the layout above; rows past the tensor's end land as
// zeros. The copy completes on an mbarrier that expects the tile's bytes.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the initialized barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the tensor map's descriptor into the TMA unit's cache ahead of its first copy
__device__ __forceinline__ void prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the tile at (row, slab) of `map` into shared memory at `dst`, completing
// on `bar`: one copy a 128-byte column block
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const void* map, int row, int slab, uint32_t bar) {
#pragma unroll
  for (int blk = 0; blk < (D > 64 ? D / 64 : 1); ++blk)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
        "%4}], [%5];\n" ::"r"(dst + blk * Tile<D>::kBlockBytes),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(blk * 64), "r"(row), "r"(slab), "r"(bar)
        : "memory");
}

// d (64 x 64) = A (64 x 16, shared) . B (16 x 64, shared), plus d when accumulate
template <int kTransB>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d (64 x 16) = A (64 x 16, registers) . B (16 x 16, shared), plus d when accumulate
template <int kTransB>
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d (64 x 32) = A (64 x 16, registers) . B (16 x 32, shared), plus d when accumulate
template <int kTransB>
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d (64 x 64) = A (64 x 16, registers) . B (16 x 64, shared), plus d when accumulate
template <int kTransB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d (64 x 128) = A (64 x 16, registers) . B (16 x 128, shared), plus d when accumulate
template <int kTransB>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}


// d (64 x N) = a (registers) . B, plus d when accumulate, for N = 16, 32, 64, 128
template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  if constexpr (N == 16) mma_rs_n16<kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 32) mma_rs_n32<kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 64) mma_rs_n64<kTransB>(d, a, desc_b, accumulate);
  else mma_rs_n128<kTransB>(d, a, desc_b, accumulate);
}

// x and y as three bf16 pairs whose sums are x and y exactly (down to bf16's
// subnormals): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid);
// the low half of each word is x's term
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the 64 x 64 fp32 accumulator x as A operands of four k-steps in kTerms
// bf16 terms each, a[kk][term][r]: three (term 0 hi, 1 mid, 2 lo; x
// exactly), or one, bf16(x) rounded to nearest even (hi alone: the TPU's
// DEFAULT precision, one MXU pass)
template <int kTerms>
__device__ __forceinline__ void split_a(const float (&x)[32], uint32_t (&a)[4][kTerms][4]) {
  static_assert(kTerms == 1 || kTerms == 3, "one bf16 term or three");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (kTerms == 3) {
        split3(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], a[kk][0][r], a[kk][1][r], a[kk][2][r]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
        a[kk][0][r] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
}



// ---- operands rounded to bf16 in the kernel ----
//
// An fp32 operand tile lands by TMA with no swizzle, as 64 rows of D floats
// (a box of all D columns, `rows_map_f32`), and the threads round it into
// the bf16 tile above (`round_tile`): the one-pass instances on fp32
// operands (csrc/flash_attention_bwd_bf16.cu, csrc/flash_attention_fwd_bf16.cu;
// the forward scales q before it rounds it). A bf16 tile that must be scaled
// (the one-pass forward's q on bf16 operands) lands swizzled as any other
// and is scaled and rounded where it lies (`scale_tile`).

// the fp32 box at (row, slab) of `map` (`rows_map_f32`) into shared memory
// at `dst`, completing on `bar`: one copy
__device__ __forceinline__ void tma_rows(uint32_t dst, const void* map, int row, int slab, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
      "%4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(slab), "r"(bar)
      : "memory");
}

// The 64 x D fp32 rows at `src` rounded to bf16, to nearest even (the bits
// of torch's `.to(torch.bfloat16)`, which takes the same `cvt.rn`), into the
// swizzled Tile<D> at `dst`, by kThreads threads from `tid`; with kScaled
// each value times `mul` in fp32 first (the bits of `(x * mul).to(
// torch.bfloat16)`). A thread takes 4 floats at a time, one 16-byte load (a
// warp reads 512 contiguous bytes), and writes their 8 bytes where the
// tile's swizzle puts them (a half-warp fills whole 128-byte spans: no bank
// conflict either way); up to kBatchMax loads in flight before their
// stores.
template <int D, int kThreads, bool kScaled = false, int kBatchMax = 8>
__device__ __forceinline__ void round_tile(const uint8_t* src, uint8_t* dst, int tid, float mul = 1.f) {
  using L = Tile<D>;
  constexpr int kQuads = L::kRows * D / 4;
  constexpr int kIters = kQuads / kThreads;
  constexpr int kBatch = kIters < kBatchMax ? kIters : kBatchMax;
  static_assert(kIters * kThreads == kQuads && kIters % kBatch == 0, "quads a thread");
  constexpr int kPerRow = L::kRowBytes / 2;  // a row's elements within one swizzled block
  constexpr int kMask = L::kRowBytes / 16 - 1;
#pragma unroll
  for (int i0 = 0; i0 < kIters; i0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) x[i] = reinterpret_cast<const float4*>(src)[tid + (i0 + i) * kThreads];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = 4 * (tid + (i0 + i) * kThreads);  // its first element, row-major
      const int row = e / D, col = e % D;
      const int o = row * L::kRowBytes + (col % kPerRow) * 2;
      if constexpr (kScaled)
        x[i] = make_float4(__fmul_rn(x[i].x, mul), __fmul_rn(x[i].y, mul), __fmul_rn(x[i].z, mul),
                           __fmul_rn(x[i].w, mul));
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x[i].x, x[i].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[i].z, x[i].w);
      *reinterpret_cast<uint2*>(dst + (col / kPerRow) * L::kBlockBytes + (o ^ (((o >> 7) & kMask) << 4))) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// The bf16 Tile<D> at `tile` times `mul`, in place: each value widened to
// fp32 (exact), multiplied, and rounded to bf16 to nearest even (the bits of
// `(x.float() * mul).to(torch.bfloat16)`), by kThreads threads from `tid`,
// 8 values a 16-byte load. Scaling is elementwise, so the swizzle is left as
// it is; rows past t, zero, stay zero.
template <int D, int kThreads>
__device__ __forceinline__ void scale_tile(uint8_t* tile, int tid, float mul) {
  constexpr int kChunks = Tile<D>::kBytes / 16;
  static_assert(kChunks % kThreads == 0, "chunks a thread");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    uint4* at = reinterpret_cast<uint4*>(tile) + tid + i * kThreads;
    uint4 x = *at;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[p]));
      const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(f.x, mul), __fmul_rn(f.y, mul));
      w[p] = *reinterpret_cast<const uint32_t*>(&r);
    }
    *at = x;
  }
}

// ---- TF32: fp32 tiles for wgmma.m64nNk8.f32.tf32.tf32 ----
//
// TF32 wgmma reads its shared-memory operands K-major only (no transpose
// bit), 8 fp32 values (32 bytes) a k-step. F32Tile<R, C> is R rows of C fp32
// values, K running along the row: rows of 64 bytes (C = 16, 64-byte
// swizzle) or blocks of 128-byte rows (C >= 32, 128-byte swizzle), the
// blocks (columns 0-31, 32-63, ...) one after another, each R x 128 bytes.
// A 16-byte chunk's index within its row is XORed with address bits 7 and
// up, as TMA writes the tile with the same swizzle; every tile starts on a
// 1024-byte boundary. `offset` gives the byte of (row, col) for the threads
// that read or write a tile themselves (a transposed copy).
//
// A from registers (m64k8): register r of a thread holds (row 16w + g +
// 8*(r&1), k = t4 + 4*(r>>1)), w the warp of the warpgroup, g = lane/4, t4 =
// lane%4. The fp32 accumulator holds (row 16w + g + 8i, column 8j + 2t4 +
// c) in d[4j + 2i + c], so a k-step's A registers come straight from the
// accumulator's columns 8j..8j+7 taken in the order 0, 2, 4, 6, 1, 3, 5, 7
// (`acc_a`): the B tile of that product holds its K rows in the same order
// within each 8, row r at column (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2)
// (`split_transpose`).
template <int R, int C>
struct F32Tile {
  static_assert(C == 16 || C % 32 == 0, "rows of 64 bytes or of 128-byte blocks");
  static constexpr int kRows = R;
  static constexpr int kRowBytes = C >= 32 ? 128 : 64;  // a row within one swizzled block
  static constexpr int kBlockBytes = R * kRowBytes;
  static constexpr int kBytes = R * C * 4;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // 128B, 64B swizzle
  static constexpr int kMask = kRowBytes / 16 - 1;
  static_assert(kBlockBytes % 1024 == 0, "every block starts on a 1024-byte boundary");

  static __device__ __forceinline__ int swizzle(int o) { return o ^ (((o >> 7) & kMask) << 4); }
  // the byte of (row, col)
  static __device__ __forceinline__ int offset(int row, int col) {
    constexpr int kPerRow = kRowBytes / 4;
    return (col / kPerRow) * kBlockBytes + swizzle(row * kRowBytes + (col % kPerRow) * 4);
  }
  // the tile at `tile` as a K-major operand, k-step kk (8 columns)
  static __device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
    constexpr int kStepsPerBlock = kRowBytes / 32;
    return desc(tile + (kk / kStepsPerBlock) * kBlockBytes + (kk % kStepsPerBlock) * 32, 16, 8 * kRowBytes,
                kLayout);
  }
};

// the fp32 accumulator x (64 x 8K) as the A registers of K k-steps, split
// as `tf32::split` splits: a[kk][0] hi, a[kk][1] lo
template <int K>
__device__ __forceinline__ void acc_a(const float (&x)[4 * K], uint32_t (&a)[K][2][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    tf32::split(x[4 * kk + 0], a[kk][0][0], a[kk][1][0]);  // (g, column 2t4)
    tf32::split(x[4 * kk + 2], a[kk][0][1], a[kk][1][1]);  // (g + 8, column 2t4)
    tf32::split(x[4 * kk + 1], a[kk][0][2], a[kk][1][2]);  // (g, column 2t4 + 1)
    tf32::split(x[4 * kk + 3], a[kk][0][3], a[kk][1][3]);  // (g + 8, column 2t4 + 1)
  }
}

// The landed fp32 tile at `hi` (layout Nat), times `mul`, split in place:
// hi = tf32(x * mul) where x was, lo = tf32(x * mul - hi) at the same byte
// of `lo`, by kThreads threads, thread `tid` taking every kThreads-th
// 16-byte chunk. A thread issues all its loads before its stores: a pass
// runs with nothing else in flight, so its loads' latency is what it costs.
template <class Nat, int kThreads>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, float mul, int tid) {
  constexpr int kIters = Nat::kBytes / 16 / kThreads;
  static_assert(kIters * kThreads * 16 == Nat::kBytes, "chunks a thread");
  float4 x[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) x[k] = *reinterpret_cast<const float4*>(hi + (tid + k * kThreads) * 16);
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    uint32_t h[4], l[4];
    tf32::split(x[k].x * mul, h[0], l[0]);
    tf32::split(x[k].y * mul, h[1], l[1]);
    tf32::split(x[k].z * mul, h[2], l[2]);
    tf32::split(x[k].w * mul, h[3], l[3]);
    const int o = (tid + k * kThreads) * 16;
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// As split_tile, and the tile's transpose (layout Tr: Nat's C columns as
// rows, its R rows as columns in `acc_a`'s order) split at t_hi and t_lo;
// with kNatural false only the transpose (the tile at `hi` is only read, and
// `lo` is not used). A task is rows 8a + c, +2, +4, +6 of column n (c = 0 or
// 1), whose transposes are one 16-byte chunk, columns 8a + 4c to 8a + 4c + 3,
// of row n: a warp reads 32 columns of a row (two rows of 16 at C = 16) and
// writes 8 rows' chunks a phase, both without bank conflicts; thread `tid`
// takes every kThreads-th task, all its loads first.
template <class Nat, class Tr, int kThreads, bool kNatural = true>
__device__ __forceinline__ void split_transpose(uint8_t* hi, uint8_t* lo, uint8_t* t_hi, uint8_t* t_lo, float mul,
                                                int tid) {
  constexpr int R = Nat::kRows, C = Nat::kBytes / (4 * R);
  constexpr int kIters = R / 8 * 2 * C / kThreads;
  static_assert(kIters * kThreads == R / 8 * 2 * C, "tasks a thread");
  int o[kIters][4];
  float x[kIters][4];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int t = tid + k * kThreads;
    const int n = t % C, c = (t / C) & 1, a8 = (t / (2 * C)) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[k][i] = Nat::offset(a8 + c + 2 * i, n);
      x[k][i] = *reinterpret_cast<const float*>(hi + o[k][i]);
    }
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int t = tid + k * kThreads;
    const int n = t % C, c = (t / C) & 1, a8 = (t / (2 * C)) * 8;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tf32::split(x[k][i] * mul, h[i], l[i]);
      if constexpr (kNatural) {
        *reinterpret_cast<uint32_t*>(hi + o[k][i]) = h[i];
        *reinterpret_cast<uint32_t*>(lo + o[k][i]) = l[i];
      }
    }
    const int to = Tr::offset(n, a8 + 4 * c);  // row a8 + c + 2i lands at column a8 + 4c + i
    *reinterpret_cast<uint4*>(t_hi + to) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(t_lo + to) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// generic-proxy writes to shared memory visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// d (64 x 16) = A (64 x 8, shared) . B (8 x 16, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32) = A (64 x 8, shared) . B (8 x 32, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) = A (64 x 8, shared) . B (8 x 64, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 16) = a (64 x 8, registers) . B (8 x 16, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32) = a (64 x 8, registers) . B (8 x 32, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) = a (64 x 8, registers) . B (8 x 64, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128) = a (64 x 8, registers) . B (8 x 128, shared), tf32, plus d when accumulate
__device__ __forceinline__ void tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}


// d (64 x N) = A . B in TF32, both from shared memory, for N = 16, 32, 64
template <int N>
__device__ __forceinline__ void tf32_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (N == 16) tf32_ss_n16(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 32) tf32_ss_n32(d, desc_a, desc_b, accumulate);
  else tf32_ss_n64(d, desc_a, desc_b, accumulate);
}

// d (64 x N) = a (registers) . B in TF32, for N = 16, 32, 64, 128
template <int N>
__device__ __forceinline__ void tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  if constexpr (N == 16) tf32_rs_n16(d, a, desc_b, accumulate);
  else if constexpr (N == 32) tf32_rs_n32(d, a, desc_b, accumulate);
  else if constexpr (N == 64) tf32_rs_n64(d, a, desc_b, accumulate);
  else tf32_rs_n128(d, a, desc_b, accumulate);
}

// the F32Tile<rows, D> at (row, slab) of `map` into shared memory at `dst`,
// completing on `bar`: one copy a swizzled column block
template <class T, int D>
__device__ __forceinline__ void tma_tile_f32(uint32_t dst, const void* map, int row, int slab, uint32_t bar) {
#pragma unroll
  for (int blk = 0; blk < (D > 32 ? D / 32 : 1); ++blk)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
        "%4}], [%5];\n" ::"r"(dst + blk * T::kBlockBytes),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(blk * 32), "r"(row), "r"(slab), "r"(bar)
        : "memory");
}

// both halves of a cluster barrier: every thread of every CTA of the
// cluster has arrived, and their shared-memory writes are visible
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at shared address `addr` of the cluster's CTA `rank`
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ---- shared by the flash kernels ----

// Keys the JAX wrapper averages v over for a query row with no valid key,
// the keys it pads past t included: every key of its key blocks of
// bk = max(128, min(256, t)), or with `causal` those up to the end of the
// row's query block of bq = max(8, min(256, t_q)) rows
// (ops/flash_attention.py::jax_masked_row_keys).
__device__ __forceinline__ int masked_row_keys(int qi, int tq, int tk, int causal) {
  const int bk = max(128, min(256, tk));
  const int n_kb = (tk + bk - 1) / bk;
  if (!causal) return n_kb * bk;
  const int bq = max(8, min(256, tq));
  const int q_end = (qi / bq + 1) * bq;
  return min(n_kb, (q_end + bk - 1) / bk) * bk;
}

// Keys (up to t) that the causal JAX kernels visit for a query row with no
// valid key.
__device__ __forceinline__ int jax_masked_row_keys(int qi, int tq, int tk) {
  return min(tk, masked_row_keys(qi, tq, tk, 1));
}

// The slope gradient's part from the keys the JAX wrapper pads past t, up to
// its key blocks' end (as ops/flash_attention.py::padded_key_dslopes): v is
// 0 there, so dS = -P * delta with P = exp(-1e30 - lse), 1 on a row with no
// valid key and 0 on every other; dS * (-|i-j|) sums to P * delta * the
// row's distances to the padded keys it visits (all of them, or with
// `causal` those below its query block's end).
__device__ __forceinline__ float padded_keys_dslope(int qi, float lse, float delta, int tq, int tk, int causal) {
  const float p = expf(-1e30f - lse);
  if (qi >= tq || p == 0.f) return 0.f;
  const int end = masked_row_keys(qi, tq, tk, causal);
  float dist = 0.f;  // a sum of integers, exact
  for (int j = tk; j < end; ++j) dist += fabsf((float)(j - qi));
  return p * delta * dist;
}

// keys [0, limit) can have P != 0 for query row qi (0 past t)
__device__ __forceinline__ int key_limit(int qi, int tq, int tk, int causal) {
  return qi >= tq ? 0 : causal ? jax_masked_row_keys(qi, tq, tk) : tk;
}

// The element's first valid key (INT_MAX if none), found by every warp over
// its share of 32-key words, four words' bytes in flight at once; `bits`, if
// given, receives the words. Ends with a block barrier.
__device__ __forceinline__ int first_valid_key(const uint8_t* mp, int tk, uint32_t* bits, int* warp_first) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  int first = INT_MAX;
  for (int w0 = warp; w0 * 32 < tk; w0 += 4 * warps) {
    uint8_t m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = (w0 + u * warps) * 32 + lane;
      m[u] = j < tk ? mp[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = w0 + u * warps;
      const uint32_t word = __ballot_sync(0xffffffffu, m[u] != 0);
      if (w * 32 >= tk) break;
      if (bits != nullptr && lane == 0) bits[w] = word;
      if (word != 0) first = min(first, w * 32 + __ffs(word) - 1);
    }
  }
  if (lane == 0) warp_first[warp] = first;
  __syncthreads();
  int f = warp_first[0];
  for (int w = 1; w < warps; ++w) f = min(f, warp_first[w]);
  return f;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// cuTensorMapEncodeTiled, looked up in libcuda by the runtime (the library
// links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// `map` over a (slabs, rows, D) bf16 tensor at `ptr`, in boxes of box_rows
// rows of box_slabs slabs and 64 columns at most, swizzled as Tile<D>
template <int D>
bool tile_map(CUtensorMap* map, const __nv_bfloat16* ptr, int rows, int slabs, int box_rows, int box_slabs) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(D < 64 ? D : 64), (cuuint32_t)box_rows, (cuuint32_t)box_slabs};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = Tile<D>::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Tile<D>::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `map` over a (slabs, rows, D) fp32 tensor at `ptr`, in boxes of box_rows
// rows of box_slabs slabs and 32 columns at most, swizzled as F32Tile<_, D>
template <int D>
bool tile_map_f32(CUtensorMap* map, const float* ptr, int rows, int slabs, int box_rows, int box_slabs) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)rows * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)(D < 32 ? D : 32), (cuuint32_t)box_rows, (cuuint32_t)box_slabs};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  static_assert(D >= 16, "rows of 64 bytes at least");
  const CUtensorMapSwizzle swizzle = D >= 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `map` over a (slabs, rows, D) fp32 tensor at `ptr`, in boxes of box_rows
// rows of box_slabs slabs and all D columns, unswizzled: a box lands as
// box_slabs * box_rows rows of D floats (`round_tile`'s source)
template <int D>
bool rows_map_f32(CUtensorMap* map, const float* ptr, int rows, int slabs, int box_rows, int box_slabs) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)rows * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, (cuuint32_t)box_slabs};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  static_assert(D % 4 == 0 && D <= 256, "a box row of 16-byte multiples, at most 256 columns");
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Grants `kernel` the device's dynamic shared memory and the largest
// shared-memory carveout, once; returns the bytes granted.
template <typename Kernel>
int grant_smem(Kernel kernel) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  return limit;
}

}  // namespace wg

// Flash-attention backward with ALiBi generated in the kernel, fp32 in and
// out, every product on the tensor cores in split TF32: dK/dV and dQ/dslope,
// P recomputed from the forward's logsumexp. The bf16 instances are
// csrc/flash_attention_bwd_bf16.cu's (bf16 `wgmma`).
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// and ::_flash_bwd_dq_kernel, the two Pallas kernels that
// `_flash_attention_bwd` launches inside the `jax.custom_vjp` of
// `flash_attention_alibi`.
//
// The math, per (batch, head), with s = (q*scale).k - slope*|i-j| masked to
// -1e30 and P = exp(s - lse):
//   dP = dO.V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (computed
//   outside, as the JAX code does);
//   dV = P^T.dO,  dK = dS^T.(q*scale),  dQ = scale * dS.K,
//   dslope = sum dS * (-|i-j|).
//
// Bounds on the H100. dK/dV does four d-long products per (query, key) pair
// and head (S, dP, dV, dK: 8*d operations), dQ/dslope three (S, dP, dQ:
// 6*d), over a few tens of MB, so both are bound by operations: at the
// training shapes (b=128, h=4, t=258, d=64, one KV head, padded keys)
// 0.124 and 0.093 ms at fp32's 67 TFLOP/s. On the TF32 tensor cores (495
// TFLOP/s) the floor is three products a product, 3 * operations / 495
// TFLOP/s (`bound_tc_ms` in chip_smoke.py): 0.050 and 0.038 ms there.
//
// Precision. As in the forward (csrc/tf32_mma.cuh): each operand is split
// into hi + lo TF32 parts, three products a product, and each k-step's three
// products start from zero and join the running sums by rounded fp32 adds,
// since the tensor cores truncate the sums they accumulate (the dK/dV sums
// run over h * t query rows a key, the slope sums over every pair). The
// softmax side (bias, mask, exp, dS) stays in fp32 in the accumulator
// registers.
//
// Design. Both kernels have one shape: 64 rows of one operand pair, 16 a
// warp (one m16 tile of `mma.sync.m16n8k8`), kept as split A fragments in
// shared memory where each lane reads its own 16 bytes at a time; the other
// pair streams through shared memory in tiles of 32 rows, copied with
// `cp.async` 16 bytes a lane, double-buffered (the next tile is in flight
// while this one is computed). The 64 rows are staged the same way, whole
// rows a copy, and split into fragments from shared memory, so that no lane
// waits on device memory once an element. When a tile has landed, its warps split
// it once: hi in place, lo beside it, so no warp repeats the cvt/subtract/cvt
// of an element it reads (the forward's note: its operand splitting
// outnumbers its MMAs). Rows are d floats with their 16-byte chunks
// XOR-swizzled by row % 8, so that both fragment reads of a tile, (row
// lane/4, column lane%4) and (row 2*(lane%4), column lane/4), hit 32
// distinct banks without padding; at d = 16, whose rows have 4 chunks,
// rows are padded to 20 floats instead (`swz`).
// - dK/dV (grid: 64-key blocks x b x KV heads): the A fragments are the
//   block's K and V rows. The block's (head, query tile) items are every
//   query head that reads its KV head (all h with one KV head, so the MQA
//   head sum stays in the block) times the query tiles of 32; Q*scale, dO,
//   lse and delta stream. Each warp computes S^T = K.(Q*scale)^T and
//   dP^T = V.dO^T for its 16 keys, then P^T and dS^T in registers, and
//   feeds them straight from the accumulator into dV += P^T.dO and
//   dK += dS^T.(Q*scale): a k-step's 8 queries are taken in the order 0, 2,
//   4, 6, 1, 3, 5, 7 in both operands, so P and dS never pass through shared
//   memory. The block has two groups of 4 warps on the same 64 keys and
//   fragments: group j takes the items of parity j, with tiles and barriers
//   of its own, and the groups' sums join at the end (group 0's plus group
//   1's). At the encoders' padded shape only about 320 of the 640 blocks
//   have a valid key, each with 36 items; as blocks of one group, two an SM,
//   they fill 1.2 waves, so the second runs nearly empty; two groups halve a
//   block's items, one 160 KB block an SM (0.51 to 0.41 ms there,
//   chip_probe_flash_bwd.py on the H100). Head dims 16, 32 and 64; at 128
//   this layout does not fit, and `flash_bwd_dkv_wide` (below) splits each
//   item's products between the two groups.
// - dQ/dslope (grid: 64-row blocks x b, or x b*h): with one KV head the 64
//   rows are the h heads x 64/h positions of one batch element, as in the
//   forward, so each K/V tile is read once for all heads; otherwise 64
//   positions of one head. The A fragments are Q*scale and dO; K and V
//   stream. S = Q.K^T and dP = dO.V^T, dS in registers, dQ += dS.K from the
//   accumulator (the same permutation over a k-step's 8 keys). The slope
//   gradient accumulates per row in registers; the block sums its rows in a
//   fixed order into one part per head it holds, in a (b, h, grid.x) tensor
//   that the caller sums. 4 warps and 112 KB a block at d = 64, two
//   blocks an SM; 229,376 bytes plus the key bits at d = 128, one.
// No atomics, and every sum runs in a fixed order: two runs give the same
// bits.
//
// What bounds them now (chip_probe_flash_bwd.py on the H100, at the train
// shapes): the three dependent MMAs of each product (with one TF32 MMA in
// place of three, dK/dV takes 35-38% less time, dQ 16-22%) and the
// shared-memory traffic of the B fragments, hi and lo, 8 loads a fragment.
// The dQ kernel's set-up and write-back alone (no tile loop) take 0.11-0.12
// of its 0.26-0.30 ms: 2,176 blocks, each copying 64 rows of q and dO, two
// an SM. Registers (nvcc
// -Xptxas=-v, sm_90a): dK/dV 255 at d=64 with 24 bytes spilled, 232 at
// d=32; dQ/dslope 230 and 158; no other spills.
//
// Masked tiles. dQ skips a key tile whose keys are all masked unless the
// block holds a row with no valid key: for a row with a valid key, a masked
// key's P = exp(-1e30 - lse) is exactly 0, so is its dS. dK/dV: a block
// whose 64 keys are all masked writes zeros and returns, but only where
// every query row of its element has a valid key (first valid key 0 with
// `causal`; any valid key without); otherwise rows with no valid key put
// P = 1 on masked keys. With `causal`, a query tile that ends before the
// block's first key is skipped unless it holds a row with no valid key that
// reaches those keys.
//
// Rows with no valid key. Their lse is -1e30, so P = exp(-1e30 - lse) = 1 on
// every key the JAX kernels visit for them: all t keys, or with `causal` the
// keys below `jax_masked_row_keys` (the key blocks up to the end of the
// row's query block, past the diagonal). Each (row, key) element takes that
// limit, so P does not depend on which tiles a block visits; the tile bounds
// only have to reach it. Rows with a valid key get P = 0 past their
// diagonal from the mask. The keys that the JAX wrapper pads past t add only
// to the slope gradient; the caller adds that part
// (ops/flash_attention.py::padded_key_dslopes). Keys and query rows past t
// take no part.
//
// Left for later work: `wgmma` (TF32 `wgmma` takes K-major operands only,
// so the dV/dK and dQ products would need dO, Q and K transposed in shared
// memory), TMA copies and warp specialisation.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;  // a dQ block, a dK/dV warp group
constexpr int kRowsPerWarp = 16;                    // one m16 tile
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // rows of the A operands a block
constexpr int kTile = 32;                          // rows of a streamed tile
constexpr int kTileN = kTile / 8;                  // its n-tiles, and k-steps of the last product
constexpr float kMaskValue = -1e30f;

using tf32::mma_split;
using tf32::split;

template <int D>
struct Layout {
  static constexpr int kSteps = D / 8;  // k-steps over d, n-tiles of dK, dV, dQ
  // floats a staged row: d, swizzled (swz); at d = 16, whose 4 chunks a row
  // cannot take the 8-way swizzle, d + 4, padded
  static constexpr int kRow = D == 16 ? D + 4 : D;
  static constexpr int kTileFloats = kTile * kRow;
  static constexpr int kFrags = kWarps * kSteps * 2 * 32;  // uint4 A fragments of one operand, hi and lo
  // the dQ block's: streamed hi [stage][operand], lo [operand], A fragments
  // [operand]
  static constexpr int kBytes = 6 * kTileFloats * 4 + 2 * kFrags * 16;
};

// offset of (row, col) in a staged tile: 16-byte chunks swizzled by row % 8;
// at d = 16 rows padded to 20 floats, which keeps both fragment reads on 32
// distinct banks (row lane/4 at 20*g + t4; rows 2*t4 and +1 at 40*t4 + g)
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  if constexpr (D == 16) return row * Layout<D>::kRow + col;
  return row * D + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

// Keys (up to t) that the causal JAX kernels visit for a query row with no
// valid key.
__device__ __forceinline__ int jax_masked_row_keys(int qi, int tq, int tk) {
  const int bk = max(128, min(256, tk));
  const int n_kb = (tk + bk - 1) / bk;
  const int bq = max(8, min(256, tq));
  const int q_end = (qi / bq + 1) * bq;
  return min(tk, min(n_kb, (q_end + bk - 1) / bk) * bk);
}

// keys [0, limit) can have P != 0 for query row qi (0 past t)
__device__ __forceinline__ int key_limit(int qi, int tq, int tk, int causal) {
  return qi >= tq ? 0 : causal ? jax_masked_row_keys(qi, tq, tk) : tk;
}

// The element's first valid key (INT_MAX if none), found by every warp over
// its share of 32-key words; `bits`, if given, receives the words. Ends
// with a block barrier.
__device__ __forceinline__ int first_valid_key(const uint8_t* mp, int tk, uint32_t* bits,
                                               int* warp_first) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  int first = INT_MAX;
  for (int w = warp; w * 32 < tk; w += warps) {
    const int j = w * 32 + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, j < tk && mp[j] != 0);
    if (bits != nullptr && lane == 0) bits[w] = word;
    if (word != 0 && first == INT_MAX) first = w * 32 + __ffs(word) - 1;
  }
  if (lane == 0) warp_first[warp] = first;
  __syncthreads();
  int f = warp_first[0];
  for (int w = 1; w < warps; ++w) f = min(f, warp_first[w]);
  return f;
}

// `rows` rows of two (rows, D) matrices into shared fp32 tiles (cp.async),
// swizzled: row r of each from
// row_ptr(src, r), zeros where that is null; thread `tid` of `threads` takes
// every threads-th 4-element chunk
template <int D, int kRows, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst0, float* dst1, const float* src0, const float* src1,
                                          RowPtr row_ptr, int tid, int threads) {
  constexpr int kChunks = kRows * D / 4;
  for (int c = tid; c < kChunks; c += threads) {
    const int r = c / (D / 4), cc = c % (D / 4);
    const float* p0 = row_ptr(src0, r);
    const float* p1 = row_ptr(src1, r);
    const int dst = swz<D>(r, cc * 4);
    tf32::load4(dst0 + dst, p0 != nullptr ? p0 + cc * 4 : src0, p0 != nullptr);
    tf32::load4(dst1 + dst, p1 != nullptr ? p1 + cc * 4 : src1, p1 != nullptr);
  }
}

// rows [r0, r0 + 32) of two (rows, D) matrices into stage tiles (zeros past
// `nrows`)
template <int D>
__device__ __forceinline__ void load_tiles(float* dst0, float* dst1, const float* src0, const float* src1,
                                           int r0, int nrows, int tid, int threads) {
  load_rows<D, kTile>(dst0, dst1, src0, src1, [&](const float* src, int r) {
    return r0 + r < nrows ? src + (size_t)(r0 + r) * D : nullptr;
  }, tid, threads);
}

// a landed tile, times `mul`, into its TF32 hi part (in place) and lo part
template <int D>
__device__ __forceinline__ void split_tile(float* hi, float* lo, float mul, int tid, int threads) {
  for (int i = tid * 4; i < Layout<D>::kTileFloats; i += threads * 4) {
    float4 x = *reinterpret_cast<float4*>(hi + i);
    uint32_t h[4], l[4];
    split(x.x * mul, h[0], l[0]);
    split(x.y * mul, h[1], l[1]);
    split(x.z * mul, h[2], l[2]);
    split(x.w * mul, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The block's 64 rows of one operand, landed (swizzled) in `x`, times `mul`,
// as the split A fragments of the 16 rows of warp slice w, in each lane's
// order: element e of k-step kk is (row g + 8*(e&1), column 8kk + t4 +
// 4*(e>>1)) of the slice.
template <int D>
__device__ __forceinline__ void store_a_fragments(uint4* frag, const float* x, float mul, int w) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(x[swz<D>(w * kRowsPerWarp + g + 8 * (e & 1), kk * 8 + t4 + 4 * (e >> 1))] * mul, hi[e], lo[e]);
    frag[((w * (D / 8) + kk) * 2 + 0) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    frag[((w * (D / 8) + kk) * 2 + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

__device__ __forceinline__ void load_a(const uint4* frag, int w, int kk, int steps, uint32_t* hi,
                                       uint32_t* lo) {
  const int lane = threadIdx.x % 32;
  const uint4 h = frag[((w * steps + kk) * 2 + 0) * 32 + lane];
  const uint4 l = frag[((w * steps + kk) * 2 + 1) * 32 + lane];
  hi[0] = h.x, hi[1] = h.y, hi[2] = h.z, hi[3] = h.w;
  lo[0] = l.x, lo[1] = l.y, lo[2] = l.z, lo[3] = l.w;
}

// B fragment (k = column 8kk + t4 and +4, n = row 8n + g) of a streamed tile:
// the operand of S^T, dP^T (dK/dV) and S, dP (dQ)
template <int D>
__device__ __forceinline__ void load_b_rows(const float* hi, const float* lo, int n, int kk,
                                            uint32_t* b_hi, uint32_t* b_lo) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int o0 = swz<D>(n * 8 + g, kk * 8 + t4), o1 = swz<D>(n * 8 + g, kk * 8 + t4 + 4);
  b_hi[0] = __float_as_uint(hi[o0]), b_hi[1] = __float_as_uint(hi[o1]);
  b_lo[0] = __float_as_uint(lo[o0]), b_lo[1] = __float_as_uint(lo[o1]);
}

// B fragment (k = rows 8kk + 2*t4 and +1, n = column 8n + g): the operand of
// dV, dK (dK/dV) and dQ, in the permuted order of the accumulator's columns
template <int D>
__device__ __forceinline__ void load_b_cols(const float* hi, const float* lo, int n, int kk,
                                            uint32_t* b_hi, uint32_t* b_lo) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int r = kk * 8 + 2 * t4;
  const int o0 = swz<D>(r, n * 8 + g), o1 = swz<D>(r + 1, n * 8 + g);
  b_hi[0] = __float_as_uint(hi[o0]), b_hi[1] = __float_as_uint(hi[o1]);
  b_lo[0] = __float_as_uint(lo[o0]), b_lo[1] = __float_as_uint(lo[o1]);
}

// an accumulator n-tile as split A fragments over its 8 columns, taken in
// the order 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ void split_acc(const float* c, uint32_t* hi, uint32_t* lo) {
  split(c[0], hi[0], lo[0]);  // (g, column 2*t4)
  split(c[2], hi[1], lo[1]);  // (g + 8, column 2*t4)
  split(c[1], hi[2], lo[2]);  // (g, column 2*t4 + 1)
  split(c[3], hi[3], lo[3]);  // (g + 8, column 2*t4 + 1)
}

// Groups of 4 warps share a block's 64 keys: group j takes the (head, query
// tile) items j, j + kGroups, ... with barriers of its own, and the groups'
// sums join in a fixed order at the end.
constexpr int kGroups = 2;
constexpr int kDkvThreads = kGroups * kThreads;

template <int D>
struct DkvLayout {
  static constexpr int kTileFloats = Layout<D>::kTileFloats;
  // streamed hi [stage][group][q*scale, dO], lo [group][q*scale, dO], A
  // fragments [K, V]
  static constexpr int kBytes = 6 * kGroups * kTileFloats * 4 + 2 * Layout<D>::kFrags * 16;
};

// barrier of warp group `group` alone (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kThreads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ slopes,
                  const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int tq, int tk,
                  int causal, float scale) {
  constexpr int kSteps = Layout<D>::kSteps;
  constexpr int TF = Layout<D>::kTileFloats;
  extern __shared__ __align__(16) float smem[];
  float* hi = smem;                         // [stage][group][q*scale, dO][TF]
  float* lo = smem + 4 * kGroups * TF;      // [group][q*scale, dO][TF]
  uint4* k_frag = reinterpret_cast<uint4*>(smem + 6 * kGroups * TF);
  uint4* v_frag = k_frag + Layout<D>::kFrags;
  __shared__ float lse_s[kGroups][kTile], delta_s[kGroups][kTile];
  __shared__ int limit_s[kGroups][kTile];
  __shared__ int warp_first[kGroups * kWarps];

  const int tid = threadIdx.x;
  const int group = tid / kThreads;
  const int gtid = tid % kThreads;  // thread of the group
  const int w = gtid / 32;          // the warp's slice of 16 keys
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bkv = blockIdx.y;  // batch * hk + KV head
  const int b = bkv / hk;
  const int kv_head = bkv % hk;
  const int k0 = blockIdx.x * kBlockRows;
  const uint8_t* mp = mask + (size_t)b * tk;
  const float* kp = k + (size_t)bkv * tk * D;
  const float* vp = v + (size_t)bkv * tk * D;

  const bool block_has_valid =
      __syncthreads_or(tid < kBlockRows && k0 + tid < tk && mp[k0 + tid] != 0);
  const int first_valid = first_valid_key(mp, tk, nullptr, warp_first);
  const bool every_row_valid = causal ? first_valid == 0 : first_valid < tk;
  if (!block_has_valid && every_row_valid) {  // P = 0 on every key of the block
    const int rows = min(kBlockRows, tk - k0);
    const size_t off = ((size_t)bkv * tk + k0) * D;
    for (int i = tid * 2; i < rows * D; i += kDkvThreads * 2) {
      tf32::store2(dk + off + i, 0.f, 0.f);
      tf32::store2(dv + off + i, 0.f, 0.f);
    }
    return;
  }

  const int head_begin = hk == 1 ? 0 : kv_head;
  const int n_q_tiles = (tq + kTile - 1) / kTile;
  const int n_items = (hk == 1 ? h : 1) * n_q_tiles;  // (head, query tile) pairs
  // with `causal`, a query tile that ends before k0 reaches these keys only
  // through rows with no valid key (those before first_valid)
  auto visits = [&](int item) {
    if (!causal) return true;
    const int q0 = (item % n_q_tiles) * kTile;
    const int q_last = min(q0 + kTile, tq) - 1;
    if (q_last >= k0) return true;
    return q0 < first_valid && jax_masked_row_keys(min(q_last, first_valid - 1), tq, tk) > k0;
  };
  // this group's next visited item from `item` on
  auto next_item = [&](int item) {
    item += (group - item % kGroups + kGroups) % kGroups;
    while (item < n_items && !visits(item)) item += kGroups;
    return item;
  };
  auto tile = [&](int stage, int op) { return hi + ((stage * kGroups + group) * 2 + op) * TF; };
  auto load = [&](int item, int stage) {
    const size_t bh = (size_t)b * h + head_begin + item / n_q_tiles;
    load_tiles<D>(tile(stage, 0), tile(stage, 1), q + bh * tq * D, dout + bh * tq * D,
                  (item % n_q_tiles) * kTile, tq, gtid, kThreads);
  };

  int item = next_item(0);
  if (item < n_items) load(item, 0);
  // the block's 64 keys of K and V, staged from the second stage's tiles on
  // (free until the loops start), then split into A fragments: K by group 0, V by
  // group 1 (by group 0 too if it is alone)
  float* staged = hi + 2 * kGroups * TF;
  load_rows<D, kBlockRows>(staged, staged + kBlockRows * Layout<D>::kRow, kp, vp, [&](const float* src, int r) {
    return k0 + r < tk ? src + (size_t)(k0 + r) * D : nullptr;
  }, tid, kDkvThreads);
  tf32::cp_async_commit();
  tf32::cp_async_wait_all();
  __syncthreads();
  for (int op = group; op < 2; op += kGroups)
    store_a_fragments<D>(op == 0 ? k_frag : v_frag, staged + op * kBlockRows * Layout<D>::kRow, 1.f, w);
  __syncthreads();  // every fragment is stored; the staged rows are read

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + w * kRowsPerWarp + g + 8 * i;
    key_ok[i] = key[i] < tk && mp[key[i]] != 0;
  }
  float acc_dk[kSteps][4], acc_dv[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  float* ql = lo + (group * 2 + 0) * TF;
  float* ol = lo + (group * 2 + 1) * TF;
  int stage = 0;
  while (item < n_items) {
    tf32::cp_async_wait_all();
    group_sync(group);  // this tile has landed; the group's warps are done with the last one
    const int nxt = next_item(item + 1);
    if (nxt < n_items) load(nxt, stage ^ 1);
    tf32::cp_async_commit();
    const int head = head_begin + item / n_q_tiles;
    const int q0 = (item % n_q_tiles) * kTile;
    float* qh = tile(stage, 0);  // q * scale
    float* oh = tile(stage, 1);  // dO
    split_tile<D>(qh, ql, scale, gtid, kThreads);
    split_tile<D>(oh, ol, 1.f, gtid, kThreads);
    if (gtid < kTile) {
      const int qi = q0 + gtid;
      const size_t row = ((size_t)b * h + head) * tq + qi;
      lse_s[group][gtid] = qi < tq ? lse[row] : 0.f;
      delta_s[group][gtid] = qi < tq ? delta[row] : 0.f;
      limit_s[group][gtid] = key_limit(qi, tq, tk, causal);
    }
    group_sync(group);
    const float slope = slopes[head];

    // S^T = K.(q*scale)^T and dP^T = V.dO^T: rows are this warp's keys,
    // columns the tile's queries
    float s[kTileN][4], dp[kTileN][4];
#pragma unroll
    for (int n = 0; n < kTileN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 1  // each k-step computes its own swizzled offsets: fewer registers, fewer spills
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ka_hi[4], ka_lo[4], va_hi[4], va_lo[4];
      load_a(k_frag, w, kk, kSteps, ka_hi, ka_lo);
      load_a(v_frag, w, kk, kSteps, va_hi, va_lo);
#pragma unroll
      for (int n = 0; n < kTileN; ++n) {
        uint32_t b_hi[2], b_lo[2];
        load_b_rows<D>(qh, ql, n, kk, b_hi, b_lo);
        mma_split(s[n], ka_hi, ka_lo, b_hi, b_lo);
        load_b_rows<D>(oh, ol, n, kk, b_hi, b_lo);
        mma_split(dp[n], va_hi, va_lo, b_hi, b_lo);
      }
    }

    // P^T and dS^T in place: element e is key g + 8*(e>>1), query 8n + 2*t4 + (e&1)
#pragma unroll
    for (int n = 0; n < kTileN; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jq = n * 8 + 2 * t4 + c;
        const int qi = q0 + jq;
        const float lse_q = lse_s[group][jq], delta_q = delta_s[group][jq];
        const int limit = limit_s[group][jq];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + c;
          const int kj = key[i];
          const float dist = fabsf((float)(kj - qi));
          float x = s[n][e] - slope * dist;
          x = (key_ok[i] && (!causal || kj <= qi)) ? x : kMaskValue;
          const float p = kj < limit ? expf(x - lse_q) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_q);
        }
      }
    }

    // dV += P^T.dO and dK += dS^T.(q*scale), A straight from the accumulator
#pragma unroll
    for (int kk = 0; kk < kTileN; ++kk) {
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      split_acc(s[kk], p_hi, p_lo);
      split_acc(dp[kk], ds_hi, ds_lo);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t b_hi[2], b_lo[2];
        load_b_cols<D>(oh, ol, n, kk, b_hi, b_lo);
        mma_split(acc_dv[n], p_hi, p_lo, b_hi, b_lo);
        load_b_cols<D>(qh, ql, n, kk, b_hi, b_lo);
        mma_split(acc_dk[n], ds_hi, ds_lo, b_hi, b_lo);
      }
    }
    item = nxt;
    stage ^= 1;
  }

  // the other groups' sums join group 0's (group 0 + group 1 + ..., in that
  // order), through the tiles, free once every group is done
  static_assert(2 * kSteps * 4 * kThreads * (kGroups - 1) <= 4 * kGroups * TF, "no room");
  // group j's sum of (dK or dV, n, e) for this lane of slice w
  auto part = [&](int j, int op, int n, int e) -> float& {
    return hi[((((j - 1) * 2 + op) * kWarps + w) * kSteps + n) * 128 + e * 32 + lane];
  };
  __syncthreads();
  if (group > 0) {
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part(group, 0, n, e) = acc_dk[n][e];
        part(group, 1, n, e) = acc_dv[n][e];
      }
  }
  __syncthreads();
  if (group > 0) return;
  for (int j = 1; j < kGroups; ++j)
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_dk[n][e] += part(j, 0, n, e);
        acc_dv[n][e] += part(j, 1, n, e);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= tk) continue;
    const size_t off = ((size_t)bkv * tk + key[i]) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      tf32::store2(dk + off + n * 8, acc_dk[n][2 * i], acc_dk[n][2 * i + 1]);
      tf32::store2(dv + off + n * 8, acc_dv[n][2 * i], acc_dv[n][2 * i + 1]);
    }
  }
}

// B fragments as load_b_rows and load_b_cols, from a tile of fp32 values
// that is split at use. The split gives the bits that split_tile's staged hi
// and lo parts would.
__device__ __forceinline__ void split_b(const float* x, int o0, int o1, uint32_t* b_hi, uint32_t* b_lo) {
  split(x[o0], b_hi[0], b_lo[0]);
  split(x[o1], b_hi[1], b_lo[1]);
}

template <int D>
__device__ __forceinline__ void load_b_rows_at_use(const float* x, int n, int kk, uint32_t* b_hi, uint32_t* b_lo) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  split_b(x, swz<D>(n * 8 + g, kk * 8 + t4), swz<D>(n * 8 + g, kk * 8 + t4 + 4), b_hi, b_lo);
}

template <int D>
__device__ __forceinline__ void load_b_cols_at_use(const float* x, int n, int kk, uint32_t* b_hi, uint32_t* b_lo) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int r = kk * 8 + 2 * t4;
  split_b(x, swz<D>(r, n * 8 + g), swz<D>(r + 1, n * 8 + g), b_hi, b_lo);
}

// dK/dV at head dim 128. The layout of flash_bwd_dkv would need 327,680
// bytes of shared memory a block (two warp groups' double-buffered tiles of
// q*scale and dO with their lo parts, 196,608, and K's and V's split A
// fragments, 131,072) against the 232,448 a block can have, and each warp
// would hold two m16 x 128 accumulators, dK's and dV's: 128 registers a
// thread before S, dP and the fragments. Here the two warp groups split the
// four products of a (head, query tile) item between them instead of the
// items: warp w of group 0 computes S^T = K.(q*scale)^T for its 16 keys,
// P^T, and dV += P^T.dO; warp w of group 1 computes dP^T = V.dO^T for the
// same keys, takes P^T from warp w through shared memory (one named barrier
// a pair: 2 KB a warp), and computes dS^T and dK += dS^T.(q*scale). Each
// warp holds one 64-register accumulator; no product is computed twice and
// no sum joins across warps. The tiles of q*scale and dO stay fp32 and are
// split into hi and lo at each B-fragment load (their lo tiles would not
// fit), so an element is split by the 4 warps that read it where
// flash_bwd_dkv splits it once. Shared memory: K's and V's fragments
// 131,072 bytes, two stages of the q*scale and dO tiles 65,536, the P
// exchange 8,192: 204,800 a block, one block an SM. Everything else (the
// grid of 64-key blocks x b x KV heads, the items, the masked blocks and
// tiles, rows with no valid key) is flash_bwd_dkv's.
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkv_wide(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ slopes,
                       const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int tq, int tk,
                       int causal, float scale) {
  constexpr int kSteps = Layout<D>::kSteps;
  constexpr int TF = Layout<D>::kTileFloats;
  constexpr int kAll = 2 * kThreads;
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;  // [stage][q*scale, dO][TF]
  uint4* k_frag = reinterpret_cast<uint4*>(smem + 4 * TF);
  uint4* v_frag = k_frag + Layout<D>::kFrags;
  float* p_x = reinterpret_cast<float*>(v_frag + Layout<D>::kFrags);  // [warp][n][e][lane]
  __shared__ float lse_s[kTile], delta_s[kTile];
  __shared__ int limit_s[kTile];
  __shared__ int warp_first[2 * kWarps];

  const int tid = threadIdx.x;
  const int role = tid / kThreads;  // 0: S, P, dV; 1: dP, dS, dK
  const int w = (tid % kThreads) / 32;  // the warp's slice of 16 keys
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bkv = blockIdx.y;  // batch * hk + KV head
  const int b = bkv / hk;
  const int kv_head = bkv % hk;
  const int k0 = blockIdx.x * kBlockRows;
  const uint8_t* mp = mask + (size_t)b * tk;
  const float* kp = k + (size_t)bkv * tk * D;
  const float* vp = v + (size_t)bkv * tk * D;

  const bool block_has_valid =
      __syncthreads_or(tid < kBlockRows && k0 + tid < tk && mp[k0 + tid] != 0);
  const int first_valid = first_valid_key(mp, tk, nullptr, warp_first);
  const bool every_row_valid = causal ? first_valid == 0 : first_valid < tk;
  if (!block_has_valid && every_row_valid) {  // P = 0 on every key of the block
    const int rows = min(kBlockRows, tk - k0);
    const size_t off = ((size_t)bkv * tk + k0) * D;
    for (int i = tid * 2; i < rows * D; i += kAll * 2) {
      tf32::store2(dk + off + i, 0.f, 0.f);
      tf32::store2(dv + off + i, 0.f, 0.f);
    }
    return;
  }

  const int head_begin = hk == 1 ? 0 : kv_head;
  const int n_q_tiles = (tq + kTile - 1) / kTile;
  const int n_items = (hk == 1 ? h : 1) * n_q_tiles;  // (head, query tile) pairs
  auto visits = [&](int item) {  // as in flash_bwd_dkv
    if (!causal) return true;
    const int q0 = (item % n_q_tiles) * kTile;
    const int q_last = min(q0 + kTile, tq) - 1;
    if (q_last >= k0) return true;
    return q0 < first_valid && jax_masked_row_keys(min(q_last, first_valid - 1), tq, tk) > k0;
  };
  auto next_item = [&](int item) {
    while (item < n_items && !visits(item)) ++item;
    return item;
  };
  auto tile = [&](int stage, int op) { return tiles + (stage * 2 + op) * TF; };
  auto load = [&](int item, int stage) {
    const size_t bh = (size_t)b * h + head_begin + item / n_q_tiles;
    load_tiles<D>(tile(stage, 0), tile(stage, 1), q + bh * tq * D, dout + bh * tq * D,
                  (item % n_q_tiles) * kTile, tq, tid, kAll);
  };

  // the block's 64 keys of K and V, staged in the tiles (free until the loop
  // starts), then split into A fragments: K by group 0, V by group 1
  load_rows<D, kBlockRows>(tiles, tiles + kBlockRows * Layout<D>::kRow, kp, vp, [&](const float* src, int r) {
    return k0 + r < tk ? src + (size_t)(k0 + r) * D : nullptr;
  }, tid, kAll);
  tf32::cp_async_commit();
  tf32::cp_async_wait_all();
  __syncthreads();
  store_a_fragments<D>(role == 0 ? k_frag : v_frag, tiles + role * kBlockRows * Layout<D>::kRow, 1.f, w);
  __syncthreads();  // every fragment is stored; the staged rows are read

  int item = next_item(0);
  if (item < n_items) load(item, 0);
  tf32::cp_async_commit();

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + w * kRowsPerWarp + g + 8 * i;
    key_ok[i] = key[i] < tk && mp[key[i]] != 0;
  }
  float acc[kSteps][4];  // dV (group 0) or dK (group 1)
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* px = p_x + w * (kTileN * 4 * 32);

  int stage = 0;
  while (item < n_items) {
    tf32::cp_async_wait_all();
    __syncthreads();  // this tile has landed; every warp is done with the last one and with px
    const int nxt = next_item(item + 1);
    if (nxt < n_items) load(nxt, stage ^ 1);
    tf32::cp_async_commit();
    const int head = head_begin + item / n_q_tiles;
    const int q0 = (item % n_q_tiles) * kTile;
    float* qs = tile(stage, 0);  // q, scaled in place below
    const float* os = tile(stage, 1);  // dO
    if (scale != 1.f)
      for (int i = tid * 4; i < TF; i += kAll * 4) {
        float4 x = *reinterpret_cast<float4*>(qs + i);
        *reinterpret_cast<float4*>(qs + i) = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
    if (tid < kTile) {
      const int qi = q0 + tid;
      const size_t row = ((size_t)b * h + head) * tq + qi;
      lse_s[tid] = qi < tq ? lse[row] : 0.f;
      delta_s[tid] = qi < tq ? delta[row] : 0.f;
      limit_s[tid] = key_limit(qi, tq, tk, causal);
    }
    __syncthreads();

    // group 0: S^T = K.(q*scale)^T; group 1: dP^T = V.dO^T. Rows are this
    // warp's keys, columns the tile's queries
    float x[kTileN][4];
#pragma unroll
    for (int n = 0; n < kTileN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
    if (role == 0) {
#pragma unroll 1
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        load_a(k_frag, w, kk, kSteps, a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < kTileN; ++n) {
          uint32_t b_hi[2], b_lo[2];
          load_b_rows_at_use<D>(qs, n, kk, b_hi, b_lo);
          mma_split(x[n], a_hi, a_lo, b_hi, b_lo);
        }
      }
    } else {
#pragma unroll 1
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        load_a(v_frag, w, kk, kSteps, a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < kTileN; ++n) {
          uint32_t b_hi[2], b_lo[2];
          load_b_rows_at_use<D>(os, n, kk, b_hi, b_lo);
          mma_split(x[n], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }

    // element e of x is key g + 8*(e>>1), query 8n + 2*t4 + (e&1)
    if (role == 0) {
      // P^T in place, handed to warp w of group 1
      const float slope = slopes[head];
#pragma unroll
      for (int n = 0; n < kTileN; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jq = n * 8 + 2 * t4 + c;
          const int qi = q0 + jq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c;
            const int kj = key[i];
            float s = x[n][e] - slope * fabsf((float)(kj - qi));
            s = (key_ok[i] && (!causal || kj <= qi)) ? s : kMaskValue;
            x[n][e] = kj < limit_s[jq] ? expf(s - lse_s[jq]) : 0.f;
            px[(n * 4 + e) * 32 + lane] = x[n][e];
          }
        }
      }
      asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + w), "r"(64) : "memory");
    } else {
      // dS^T = P^T * (dP^T - delta), once warp w of group 0 has put P^T
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "r"(64) : "memory");
#pragma unroll
      for (int n = 0; n < kTileN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[n][e] = px[(n * 4 + e) * 32 + lane] * (x[n][e] - delta_s[n * 8 + 2 * t4 + (e & 1)]);
    }

    // group 0: dV += P^T.dO; group 1: dK += dS^T.(q*scale); A straight from
    // the accumulator, a k-step's 8 queries in the order 0, 2, 4, 6, 1, 3, 5, 7
#pragma unroll
    for (int kk = 0; kk < kTileN; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_acc(x[kk], a_hi, a_lo);
      if (role == 0) {
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          uint32_t b_hi[2], b_lo[2];
          load_b_cols_at_use<D>(os, n, kk, b_hi, b_lo);
          mma_split(acc[n], a_hi, a_lo, b_hi, b_lo);
        }
      } else {
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          uint32_t b_hi[2], b_lo[2];
          load_b_cols_at_use<D>(qs, n, kk, b_hi, b_lo);
          mma_split(acc[n], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }
    item = nxt;
    stage ^= 1;
  }

  float* out = role == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= tk) continue;
    const size_t off = ((size_t)bkv * tk + key[i]) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) tf32::store2(out + off + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
struct DkvWideLayout {
  // the q*scale and dO tiles [stage][op], K's and V's A fragments, the P
  // exchange [warp][n][e][lane]
  static constexpr int kBytes = 4 * Layout<D>::kTileFloats * 4 + 2 * Layout<D>::kFrags * 16 +
                                kWarps * kTileN * 4 * 32 * 4;
};

// Grid: (blocks of 64 / heads_per_block positions, b) when heads_per_block
// == h (one KV head), else (blocks of 64 positions, b * h).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ slopes,
                 const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, float* __restrict__ dslope_part, int h, int hk, int tq,
                 int tk, int causal, float scale, int heads_per_block) {
  using L = Layout<D>;
  constexpr int kSteps = L::kSteps;
  constexpr int TF = L::kTileFloats;
  extern __shared__ __align__(16) float smem[];
  float* hi = smem;           // [stage][K, V][TF]
  float* lo = smem + 4 * TF;  // [K, V][TF]
  uint4* q_frag = reinterpret_cast<uint4*>(smem + 6 * TF);
  uint4* o_frag = q_frag + L::kFrags;
  uint32_t* bits = reinterpret_cast<uint32_t*>(o_frag + L::kFrags);  // [key tiles]
  __shared__ int warp_first[kWarps];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int positions = kBlockRows / heads_per_block;
  const int b = heads_per_block == 1 ? blockIdx.y / h : blockIdx.y;
  const int head0 = heads_per_block == 1 ? blockIdx.y % h : 0;
  const int q0 = blockIdx.x * positions;
  const size_t kv_off = ((size_t)b * hk + (hk == 1 ? 0 : head0)) * tk * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;
  const uint8_t* mp = mask + (size_t)b * tk;

  // this thread's rows: g and g + 8 of the warp's 16
  int row_head[2], row_pos[2], row_limit[2];
  float row_slope[2], row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * kRowsPerWarp + g + 8 * i;
    row_head[i] = head0 + r / positions;
    row_pos[i] = q0 + r % positions;
    row_slope[i] = slopes[row_head[i]];
    row_limit[i] = key_limit(row_pos[i], tq, tk, causal);
    const size_t row = ((size_t)b * h + row_head[i]) * tq + row_pos[i];
    row_lse[i] = row_pos[i] < tq ? lse[row] : 0.f;
    row_delta[i] = row_pos[i] < tq ? delta[row] : 0.f;
  }

  const int all_tiles = (tk + kTile - 1) / kTile;
  const int first_valid = first_valid_key(mp, tk, bits, warp_first);
  // a row of this block has no valid key: its first row's, if any
  const bool has_empty_row = first_valid >= tk || (causal && first_valid > q0);
  const int last_pos = min(tq, q0 + positions) - 1;
  int end = causal ? min(all_tiles, last_pos / kTile + 1) : all_tiles;
  if (causal && has_empty_row)
    end = max(end, (jax_masked_row_keys(last_pos, tq, tk) + kTile - 1) / kTile);
  auto next_tile = [&](int tile) {
    while (tile < end && !has_empty_row && bits[tile] == 0) ++tile;
    return tile;
  };
  auto load = [&](int tile, int stage) {
    load_tiles<D>(hi + (2 * stage) * TF, hi + (2 * stage + 1) * TF, kp, vp, tile * kTile, tk, tid,
                  kThreads);
  };

  int tile = next_tile(0);
  if (tile < end) load(tile, 0);
  // the block's 64 rows of q and dO, staged in the second stage and the lo
  // tiles (free until the loop starts), then split into A fragments
  const size_t row_base = (size_t)b * h;
  float* staged = hi + 2 * TF;
  load_rows<D, kBlockRows>(staged, staged + kBlockRows * L::kRow, q, dout, [&](const float* src, int r) {
    const int pos = q0 + r % positions;
    return pos < tq ? src + ((row_base + head0 + r / positions) * tq + pos) * D : nullptr;
  }, tid, kThreads);
  tf32::cp_async_commit();
  tf32::cp_async_wait_all();
  __syncthreads();
  store_a_fragments<D>(q_frag, staged, scale, warp);
  store_a_fragments<D>(o_frag, staged + kBlockRows * L::kRow, 1.f, warp);

  float acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float dslope[2] = {0.f, 0.f};

  int stage = 0;
  while (tile < end) {
    tf32::cp_async_wait_all();
    __syncthreads();  // this tile has landed; every warp is done with the last one
    const int nxt = next_tile(tile + 1);
    if (nxt < end) load(nxt, stage ^ 1);
    tf32::cp_async_commit();
    const float* kh = hi + (2 * stage) * TF;
    const float* vh = kh + TF;
    const float* kl = lo;
    const float* vl = lo + TF;
    split_tile<D>(hi + (2 * stage) * TF, lo, 1.f, tid, kThreads);
    split_tile<D>(hi + (2 * stage + 1) * TF, lo + TF, 1.f, tid, kThreads);
    __syncthreads();
    const int k0 = tile * kTile;

    // S = (q*scale).K^T and dP = dO.V^T
    float s[kTileN][4], dp[kTileN][4];
#pragma unroll
    for (int n = 0; n < kTileN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 1  // each k-step computes its own swizzled offsets: fewer registers, fewer spills
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa_hi[4], qa_lo[4], oa_hi[4], oa_lo[4];
      load_a(q_frag, warp, kk, kSteps, qa_hi, qa_lo);
      load_a(o_frag, warp, kk, kSteps, oa_hi, oa_lo);
#pragma unroll
      for (int n = 0; n < kTileN; ++n) {
        uint32_t b_hi[2], b_lo[2];
        load_b_rows<D>(kh, kl, n, kk, b_hi, b_lo);
        mma_split(s[n], qa_hi, qa_lo, b_hi, b_lo);
        load_b_rows<D>(vh, vl, n, kk, b_hi, b_lo);
        mma_split(dp[n], oa_hi, oa_lo, b_hi, b_lo);
      }
    }

    // dS in place of dP: element e is row g + 8*(e>>1), key k0 + 8n + 2*t4 + (e&1)
    const uint32_t word = bits[tile];
#pragma unroll
    for (int n = 0; n < kTileN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int jj = n * 8 + 2 * t4 + (e & 1);
        const int kj = k0 + jj;
        const bool valid = ((word >> jj) & 1u) != 0;
        const float dist = fabsf((float)(kj - row_pos[i]));
        float x = s[n][e] - row_slope[i] * dist;
        x = (valid && (!causal || kj <= row_pos[i])) ? x : kMaskValue;
        const float p = kj < row_limit[i] ? expf(x - row_lse[i]) : 0.f;
        const float ds = p * (dp[n][e] - row_delta[i]);
        dp[n][e] = ds;
        dslope[i] = fmaf(ds, -dist, dslope[i]);
      }
    }

    // dQ += dS.K, A straight from the accumulator
#pragma unroll
    for (int kk = 0; kk < kTileN; ++kk) {
      uint32_t ds_hi[4], ds_lo[4];
      split_acc(dp[kk], ds_hi, ds_lo);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t b_hi[2], b_lo[2];
        load_b_cols<D>(kh, kl, n, kk, b_hi, b_lo);
        mma_split(acc[n], ds_hi, ds_lo, b_hi, b_lo);
      }
    }
    tile = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row_pos[i] >= tq) continue;
    float* op = dq + ((row_base + row_head[i]) * tq + row_pos[i]) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) tf32::store2(op + n * 8, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }

  // the slope gradient: each head's rows of the block in a fixed order, in
  // the lo buffer, free now
  __syncthreads();
  float* rows = lo;  // [64 rows][4 lanes of a row]
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[(warp * kRowsPerWarp + g + 8 * i) * 4 + t4] = dslope[i];
  __syncthreads();
  if (tid < heads_per_block) {
    float total = 0.f;
    for (int r = tid * positions; r < (tid + 1) * positions; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) total += rows[r * 4 + c];
    dslope_part[(row_base + head0 + tid) * gridDim.x + blockIdx.x] = total;
  }
}

// Grants `kernel` the device's dynamic shared memory (less its static part)
// and the largest shared-memory carveout, once; returns the bytes granted.
template <typename Kernel>
int grant_smem(Kernel kernel) {
  int dev = 0, limit = 0;
  cudaFuncAttributes attr = {};
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncGetAttributes(&attr, kernel);
  const int dynamic = limit - (int)attr.sharedSizeBytes;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return dynamic;
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
               const float* dout, const float* lse, const float* delta, float* dk, float* dv, int b, int h,
               int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  static const int granted = grant_smem(flash_bwd_dkv<D>);
  const size_t smem = DkvLayout<D>::kBytes;
  if (smem > (size_t)granted) return (int)cudaErrorInvalidValue;
  const dim3 grid((tk + kBlockRows - 1) / kBlockRows, b * hk);
  flash_bwd_dkv<D><<<grid, kDkvThreads, smem, stream>>>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, h, hk, tq,
                                                        tk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wide(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
                    const float* dout, const float* lse, const float* delta, float* dk, float* dv, int b, int h,
                    int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  static const int granted = grant_smem(flash_bwd_dkv_wide<D>);
  const size_t smem = DkvWideLayout<D>::kBytes;
  if (smem > (size_t)granted) return (int)cudaErrorInvalidValue;
  const dim3 grid((tk + kBlockRows - 1) / kBlockRows, b * hk);
  flash_bwd_dkv_wide<D><<<grid, 2 * kThreads, smem, stream>>>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, h, hk,
                                                              tq, tk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
              const float* dout, const float* lse, const float* delta, float* dq, float* dslope_part, int b,
              int h, int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  static const int granted = grant_smem(flash_bwd_dq<D>);
  const size_t smem = Layout<D>::kBytes + sizeof(uint32_t) * ((tk + kTile - 1) / kTile);
  if (smem > (size_t)granted) return (int)cudaErrorInvalidValue;
  const bool mqa = hk == 1 && h > 1 && kBlockRows % h == 0;
  const int heads_per_block = mqa ? h : 1;
  const int positions = kBlockRows / heads_per_block;
  const dim3 grid((tq + positions - 1) / positions, mqa ? b : b * h);
  flash_bwd_dq<D><<<grid, kThreads, smem, stream>>>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, h, hk,
                                                    tq, tk, causal, scale, heads_per_block);
  return (int)cudaGetLastError();
}

// launch_dkv (kDkv) or launch_dq at head dim d; out0/out1: dk/dv or dq/dslope
// parts
template <bool kDkv, typename Out1>
int dispatch(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
             const float* dout, const float* lse, const float* delta, float* out0, Out1* out1, int b, int h,
             int hk, int tq, int tk, int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk != 1 && hk != h) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    if constexpr (kDkv && D == 128)
      return launch_dkv_wide<D>(q, k, v, slopes, mask, dout, lse, delta, out0, out1, b, h, hk, tq, tk, causal,
                                scale, s);
    else if constexpr (kDkv)
      return launch_dkv<D>(q, k, v, slopes, mask, dout, lse, delta, out0, out1, b, h, hk, tq, tk, causal, scale, s);
    else
      return launch_dq<D>(q, k, v, slopes, mask, dout, lse, delta, out0, out1, b, h, hk, tq, tk, causal, scale, s);
  };
  switch (d) {
    case 16:
      return run(std::integral_constant<int, 16>{});
    case 32:
      return run(std::integral_constant<int, 32>{});
    case 64:
      return run(std::integral_constant<int, 64>{});
    case 128:
      return run(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout: (b, h, tq, d); k, v: (b, hk, tk, d) with hk in {1, h}; slopes: (h,);
// mask: (b, tk) bytes, nonzero = valid key; lse, delta: (b, h, tq); dk, dv:
// (b, hk, tk, d), written whole (with hk = 1, summed over the h query heads).
// All fp32, contiguous and 16-byte aligned. Returns the CUDA error code of
// the launch.
extern "C" int sp_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                          const float* slopes, const uint8_t* mask,
                                          const float* dout, const float* lse,
                                          const float* delta, float* dk, float* dv, int b, int h,
                                          int hk, int tq, int tk, int d, int causal, float scale,
                                          void* stream) {
  return dispatch<true>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk, d,
                        causal, scale, stream);
}

// As above; dq: (b, h, tq, d); dslope_part: (b, h, blocks), each block's
// part of sum dS * (-|i-j|) for each head it holds, for the caller to sum
// over b and blocks. A block holds 64 (head, position) rows: with hk = 1 and
// h dividing 64, all h heads at 64/h positions (blocks = ceil(tq / (64/h))),
// else 64 positions of one head (blocks = ceil(tq / 64)).
extern "C" int sp_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                         const float* slopes, const uint8_t* mask,
                                         const float* dout, const float* lse, const float* delta,
                                         float* dq, float* dslope_part, int b, int h, int hk,
                                         int tq, int tk, int d, int causal, float scale,
                                         void* stream) {
  return dispatch<false>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk, tq,
                         tk, d, causal, scale, stream);
}

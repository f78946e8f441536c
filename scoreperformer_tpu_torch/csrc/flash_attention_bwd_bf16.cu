// Flash-attention backward on bf16 operands, with ALiBi generated in the
// kernel, on Hopper's warpgroup MMA (`wgmma`): dK/dV and dQ/dslope, P
// recomputed from the forward's logsumexp, every sum fp32-accurate; and,
// built from this file by csrc/flash_attention_bwd_one_pass.cu
// (SP_FLASH_ONE_PASS), the one-pass instances (kTerms = 1): bf16 operands
// and gradients, or fp32 operands rounded to bf16 in the kernel and fp32
// gradients.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (:135) and ::_flash_bwd_dq_kernel (:192), the two Pallas kernels that
// `_flash_attention_bwd` launches inside the `jax.custom_vjp` of
// `flash_attention_alibi`, for a model held in bf16 (q, k, v and dO bf16;
// lse and delta fp32; dK, dV, dQ written in bf16, the slope parts in fp32),
// and at the Pallas kernels' "default" precision for any operands. The fp32
// instances are csrc/flash_attention_bwd.cu's.
//
// The math, per (batch, head), with s = scale*(q.k) - slope*|i-j| masked to
// -1e30 and P = exp(s - lse):
//   dP = dO.V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (computed
//   outside, in bf16, as the JAX wrapper takes it);
//   dV = P^T.dO,  dK = scale * dS^T.q,  dQ = scale * dS.K,
//   dslope = sum dS * (-|i-j|).
//
// Numerics. The Pallas kernels upcast their blocks and take their products
// at the `precision` they are given: JAX's model gives none, so "default",
// where the TPU rounds each dot's operands to bf16 and sums in fp32 (one
// pass); "highest" is the JAX parity tests' setting. These instances
// (kTerms = 3) are fp32-accurate, as "highest" is. A bf16 times a bf16 is
// exact in fp32, so S =
// Q.K^T and dP = dO.V^T are single bf16 products (scale applied to S in
// fp32 afterwards, as `_recompute_p` does). P and dS are fp32: each is split
// into three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
// - mid), whose sum is x exactly down to bf16's subnormals (wgmma.cuh's
// split3), so P^T.dO, dS^T.q and dS.K take three bf16 products each against
// the same B tile. The tensor cores truncate the fp32 sums they accumulate
// (a long chain in one accumulator drifts toward zero), so each tile's
// products (64 rows of the summed dimension, 12 wgmmas) start from zero and
// join the running sums by rounded fp32 adds: the dK/dV sums run over h*t
// query rows a key with one KV head, dQ's over t keys. Bias, mask, exp and
// dS stay in fp32 registers. No atomics, and every sum runs in a fixed
// order: two calls give the same bits. The one-pass instances (kTerms = 1)
// take the TPU's "default" numerics: P^T, dS^T and dS are one bf16 term
// each, rounded to nearest even (dS and the slope gradient still from the
// unrounded fp32 values), 4 products a tile where there were 12; fp32
// operands (`In` = float) are read in fp32 and rounded to bf16 here, to
// nearest even as torch's `.to(torch.bfloat16)` rounds (the same `cvt.rn`,
// so the same bits as on fp32(bf16(x))), and dK, dV and dQ are written in
// their dtype (`Out`).
//
// Bound on the H100. dK/dV takes 8 bf16 passes over the (query, key) pairs
// of each head (S, dP, 3 for dV, 3 for dK), dQ/dslope 5 (S, dP, 3 for dQ),
// each pass 2*d operations a pair: at 989 TFLOP/s (bf16 dense) 13 passes of
// 2*d*h*pairs; the one-pass instances 4 and 3, 7 passes. The bytes (q, k,
// v, dO read once, lse and delta, dK, dV, dQ written once, 3.35 TB/s) are a
// few tens of MB in bf16: at the train shapes the operations bound both
// kernels (chip_smoke.py's `bound_tc_ms`: 0.044 + 0.028 ms at b 8, h 8, one
// KV head, d 128, t 1025 causal). On fp32 operands the one-pass instances
// read 4 bytes an element and write fp32 gradients, and the bytes bound
// them at the flagship's shapes: dK/dV about 102 MB, dQ/dslope 118 MB at b
// 128, h 4, one KV head, d 64, t 258 (0.030 + 0.035 ms;
// chip_smoke.py::check_flash_one_pass's bounds).
//
// Design. Every operand is a 64-row bf16 tile in shared memory, swizzled as
// wgmma reads it (wgmma.cuh), copied by TMA from a 3-d tensor map (rows
// past t land as zeros) and completing on an mbarrier. The streamed tiles
// are double-buffered: thread 0 issues the copy after next as soon as every
// warp has released that stage on its own mbarrier, so no warp waits for
// another between tiles. lse and delta come into registers, a thread's 16
// query columns (dK/dV) or 2 rows (dQ), and P and dS in a tile whose 64 x
// 64 pairs are all valid and below every row's key limit take a path with
// no mask.
// - dK/dV (grid: 64-key blocks x b x KV heads; 256 threads): the block's K
//   and V tiles stay; its (head, query tile of 64) items are every query
//   head that reads its KV head (all h with one KV head, so the MQA head sum
//   stays in the block) times the query tiles; q, dO, lse and delta stream.
//   Two warpgroups share the 64 keys and split each item's work: warpgroup
//   0 computes S^T = K.q^T (shared-memory operands), P^T in its accumulator,
//   hands P^T to warpgroup 1 through shared memory (a named barrier), and
//   takes dV += P^T.dO; warpgroup 1 computes dP^T = V.dO^T, dS^T = P^T *
//   (dP^T - delta), and dK += dS^T.q. P^T and dS^T go from the accumulator
//   straight into register-sourced wgmmas whose B is the q or dO tile read
//   MN-major through the transpose bit. Each warpgroup holds one running sum
//   and one tile sum of 64 x d fp32: 4 passes a warpgroup, no product
//   computed twice, no sum joined across warpgroups. With one KV head and
//   too few blocks to give every SM four, a cluster of 2, 4 or 8 CTAs
//   shares a block's keys and splits its query heads; the CTAs' sums join
//   in rank order through distributed shared memory.
// - dQ/dslope (grid: 64-row blocks x b, or x b*h; 128 threads): with one KV
//   head the 64 rows are the h heads x 64/h positions of one batch element,
//   so each K/V tile is read once for all heads; otherwise 64 positions of
//   one head. q and dO stay; K and V stream in tiles of 64 keys. S = q.K^T
//   and dP = dO.V^T (shared-memory operands), dS in registers, dQ += dS.K
//   with K read MN-major. The slope gradient accumulates per row in
//   registers; the block sums its rows in a fixed order into one part per
//   head it holds, in a (b, h, grid.x) tensor that the caller sums
//   (ops/flash_attention.py::dq_slope_parts).
//
// What bounds them now (clock64 phase counters and one-edit variants of a
// tile's steps on the H100, at the train shapes): each warpgroup runs its
// tile's steps in sequence (product, wait, exp and mask, split, products,
// wait), so the tensor cores idle while P is computed, and warpgroup 1 waits
// for warpgroup 0's P; one dK/dV block an SM (registers), two dQ blocks.
// Causal dK/dV blocks of late keys finish early while early ones walk every
// query tile; a dQ block's set-up (barriers, the mask's words, the first
// copies) is a large share of its life at the encoders' padded shapes.
//
// fp32 operands (design (a) of two: TMA lands fp32 rows, the threads round
// them). Rounding in the kernel takes the wrappers' bf16 copies away (four
// conversions of q, k, v and dO a wrapper, about 85 MB read and 42 MB
// written each time); rounding once a backward, or keeping the forward's
// copies, would still cost one such pass a call or hold the copies for the
// whole step. A tile of fp32 rows lands unswizzled (`wg::rows_map_f32`, a
// box of all d columns) in a staging area, `kStaged`, and the threads round
// it into the bf16 tile's swizzle (`wg::round_tile`: 16-byte loads, 8-byte
// stores, no bank conflict), fence it for the async proxy and mark the
// stage full on its mbarrier, which now counts the rounding threads; the
// stage's bf16 tiles, their descriptors and every wgmma stay as they are.
// Staging registers through global loads (design (b)) would need the
// rows past t masked by hand and its loads in flight across the products;
// TMA gives both, and its staging fits: one stage of fp32 rows is 4 bf16
// tiles.
// - dK/dV: K's and V's fp32 rows land first where stage 1 and the hand-over
//   space lie, the first item's q and dO in kStaged; all 256 threads round
//   them. After that warpgroup 1 rounds the next item's q and dO into the
//   other stage while its dP^T product runs and warpgroup 0 computes P^T
//   (time it otherwise waits), and its first thread then issues the item
//   after that into kStaged: a copy leads its rounding by one item, as the
//   bf16 copies lead their use. Shared memory: 115,792 B at d = 64 and
//   197,712 B at d = 128 (83,016 and 132,168 on bf16), one block an SM as
//   before.
// - dQ/dslope: q's and dO's fp32 rows land where the two K/V stages lie and
//   are rounded first, then key tile 0 from kStaged; after that the 128
//   threads round the next key tile's K and V while this tile's S and dP
//   products run. Shared memory: 84,068 B at d = 64 and t = 258 (51,292 on
//   bf16), two blocks an SM at d <= 64; 166,084 B at d = 128 and t = 1026,
//   one block.
// What the card showed (graph replay on the H100, PERF.md §6): at
// the flagship's shapes (b 128, h 4, one KV head, d 64, t 258 / 257) dK/dV
// takes 0.110 / 0.103 ms and dQ/dslope 0.080 / 0.072 on fp32 operands,
// against 0.094 / 0.088 and 0.062 / 0.056 on the wrappers' bf16 copies,
// which cost 0.049 ms more a wrapper; at d = 128 dQ/dslope, one block an
// SM, nearly doubles (0.133 against 0.070 at t 1025 causal). Each block
// reads its operands from L2 in fp32, twice the bytes, and rounds them
// through shared memory. Tried and dropped, each the same bits: warpgroup
// 0 rounding q while its dV product runs (dK/dV +15%: warpgroup 0's chain,
// S^T, exp and the hand-over, sets an item's time) and two fp32 staging
// buffers at d <= 64 (+4-6%).
//
// Masked tiles and rows with no valid key: as csrc/flash_attention_bwd.cu's
// header says, with tiles of 64. dQ skips a key tile whose keys are all
// masked unless the block holds a row with no valid key; a dK/dV block whose
// 64 keys are all masked writes zeros and returns where every query row of
// its element has a valid key; with `causal`, a query tile that ends before
// the block's first key is skipped unless it holds a row with no valid key
// that reaches those keys. Rows with no valid key (lse = -1e30) put P = 1 on
// the keys below `jax_masked_row_keys`, and the dQ kernel adds the slope
// gradient's part from the keys the JAX wrapper pads past t
// (wg::padded_keys_dslope, as the fp32 dQ kernel does).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wg::cluster_sync;
using wg::first_valid_key;
using wg::grant_smem;
using wg::jax_masked_row_keys;
using wg::key_limit;
using wg::ld_cluster;
using wg::padded_keys_dslope;
using wg::smem_addr;
using wg::store2;
using tf32::store2;  // fp32 gradients (the one-pass instances on fp32 operands)
using wg::Tile;
using wg::tile_map;

constexpr int kRows = 64;  // keys of a dK/dV block, rows of a dQ block, rows of every tile
constexpr int kWG = 128;   // threads of a warpgroup
constexpr float kMaskValue = -1e30f;

// the query column (0-15) of a thread's dK/dV accumulator element e: query
// 8*(e>>2) + 2*t4 + (e&1)
__host__ __device__ constexpr int column(int e) { return ((e >> 2) << 1) | (e & 1); }

// the block's shared memory, from a 1024-byte aligned base; kF32: fp32
// operands, whose q and dO land in `kStaged` (fp32 rows, `wg::round_tile`'s
// source) before they are rounded into their stage
template <int D, bool kF32>
struct DkvSmem {
  static constexpr int kTile = Tile<D>::kBytes;  // an fp32 tile of 64 rows: 2 * kTile
  static constexpr int kK = 0, kV = kTile;
  static constexpr int kQ = 2 * kTile;  // [stage][q, dO] tiles
  static constexpr int kX = 6 * kTile;  // P^T handed over: [stage][element][thread of the warpgroup] fp32
  static constexpr int kStaged = kX + 2 * kRows * kRows * 4;  // fp32 q and dO of the next item to round
  static constexpr int kBars = kStaged + (kF32 ? 4 * kTile : 0);
  // mbarriers: K and V, full[stage], empty[stage], and (kF32) staged
  static constexpr int kWarpFirst = kBars + (kF32 ? 6 : 5) * 8;
  static constexpr int kBytes = kWarpFirst + 8 * 4 + 1024;  // and the alignment's slack
};

// kTerms: P^T's and dS^T's bf16 terms (3, or 1 for the one-pass instances);
// Out: dK's and dV's type; In: q's, k's, v's and dO's (bf16, or fp32 for
// the one-pass instances, rounded here)
template <int D, int kTerms, typename Out, typename In>
__global__ void __launch_bounds__(2 * kWG, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                       const float* __restrict__ slopes, const uint8_t* __restrict__ mask,
                       const float* __restrict__ lse, const float* __restrict__ delta, Out* __restrict__ dk,
                       Out* __restrict__ dv, int h, int hk, int tq, int tk, int causal, float scale) {
  constexpr bool kF32 = std::is_same_v<In, float>;
  static_assert(kF32 || std::is_same_v<In, bf16>, "bf16 or fp32 operands");
  using S = DkvSmem<D, kF32>;
  constexpr int kThreads = 2 * kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* warp_first = reinterpret_cast<int*>(smem + S::kWarpFirst);
  const uint32_t bar_kv = base + S::kBars;
  const uint32_t full = bar_kv + 8, empty = bar_kv + 24;  // [stage] at + 8 * stage
  const uint32_t staged = bar_kv + 40;  // kF32: the fp32 q and dO in kStaged

  const int tid = threadIdx.x;
  const int role = tid / kWG;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int wtid = tid % kWG;
  const int w = wtid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int bkv = blockIdx.y;  // batch * hk + KV head
  const int b = bkv / hk;
  const int kv_head = bkv % hk;
  const int k0 = blockIdx.x * kRows;
  const uint8_t* mp = mask + (size_t)b * tk;

  const bool block_has_valid = __syncthreads_or(tid < kRows && k0 + tid < tk && mp[k0 + tid] != 0);
  const bool all_valid = __syncthreads_and(tid >= kRows || (k0 + tid < tk && mp[k0 + tid] != 0));
  const int first_valid = first_valid_key(mp, tk, nullptr, warp_first);
  const bool every_row_valid = causal ? first_valid == 0 : first_valid < tk;
  if (!block_has_valid && every_row_valid) {  // P = 0 on every key of the block
    const int rows = min(kRows, tk - k0);
    const size_t off = ((size_t)bkv * tk + k0) * D;
    for (int i = tid * 2; blockIdx.z == 0 && i < rows * D; i += kThreads * 2) {
      store2(dk + off + i, 0.f, 0.f);
      store2(dv + off + i, 0.f, 0.f);
    }
    return;  // the cluster's every CTA, before any cluster barrier
  }

  // the items: (query head, query tile) pairs, every query head that reads
  // this KV head (all h with one KV head) times the query tiles, in order
  struct Item {
    int head, tile;  // head: past the first, head_begin
  };
  // with one KV head the cluster's gridDim.z CTAs split the query heads,
  // CTA z taking heads z*h/gridDim.z on
  const int n_heads = hk == 1 ? h / gridDim.z : 1;
  const int head_begin = hk == 1 ? blockIdx.z * n_heads : kv_head;
  const int n_q_tiles = (tq + kRows - 1) / kRows;
  // with `causal`, a query tile that ends before k0 reaches these keys only
  // through rows with no valid key (those before first_valid)
  auto visits = [&](int tile) {
    if (!causal) return true;
    const int q0 = tile * kRows;
    const int q_last = min(q0 + kRows, tq) - 1;
    if (q_last >= k0) return true;
    return q0 < first_valid && jax_masked_row_keys(min(q_last, first_valid - 1), tq, tk) > k0;
  };
  // the first visited item from `it` on (it.head == n_heads: none)
  auto next_item = [&](Item it) {
    while (it.head < n_heads && !visits(it.tile))
      if (++it.tile == n_q_tiles) it = Item{it.head + 1, 0};
    return it;
  };
  auto after = [&](Item it) {  // the next visited item past `it`
    return next_item(it.tile + 1 == n_q_tiles ? Item{it.head + 1, 0} : Item{it.head, it.tile + 1});
  };
  // the item's q and dO tiles into stage `stage` (thread 0), or with fp32
  // operands their fp32 rows into kStaged (one thread)
  auto issue = [&](Item item, int stage) {
    const int slab = b * h + head_begin + item.head;
    const int q0 = item.tile * kRows;
    if constexpr (kF32) {
      wg::mbar_expect_tx(staged, 4 * S::kTile);
      wg::tma_rows(base + S::kStaged, &tm_q, q0, slab, staged);
      wg::tma_rows(base + S::kStaged + 2 * S::kTile, &tm_o, q0, slab, staged);
    } else {
      const uint32_t qt = base + S::kQ + stage * 2 * S::kTile;
      wg::mbar_expect_tx(full + 8 * stage, 2 * S::kTile);
      wg::tma_tile<D>(qt, &tm_q, q0, slab, full + 8 * stage);
      wg::tma_tile<D>(qt + S::kTile, &tm_o, q0, slab, full + 8 * stage);
    }
  };
  // fp32 operands: the fp32 q and dO in kStaged rounded into stage `stage`
  // by `threads` (a std::integral_constant) threads, this one the t-th
  auto round_item = [&](int stage, int t, auto threads) {
    uint8_t* qt = smem + S::kQ + stage * 2 * S::kTile;
    wg::round_tile<D, decltype(threads)::value>(smem + S::kStaged, qt, t);
    wg::round_tile<D, decltype(threads)::value>(smem + S::kStaged + 2 * S::kTile, qt + S::kTile, t);
  };

  Item item = next_item(Item{0, 0});
  if (tid == 0) {
    wg::mbar_init(bar_kv, 1);
    for (int st = 0; st < 2; ++st) {
      // with fp32 operands warpgroup 1's threads fill a stage
      wg::mbar_init(full + 8 * st, kF32 ? kWG : 1);
      wg::mbar_init(empty + 8 * st, 2 * kWG / 32);  // every warp releases a stage
    }
    if (kF32) wg::mbar_init(staged, 1);
    wg::mbar_init_fence();
    // the block's 64 keys of K and V, then the first two items (with fp32
    // operands the first: its q and dO land in kStaged, K and V where stage 1
    // and the hand-over space lie, until all are rounded)
    if constexpr (kF32) {
      wg::mbar_expect_tx(bar_kv, 4 * S::kTile);
      wg::tma_rows(base + S::kQ + 2 * S::kTile, &tm_k, k0, bkv, bar_kv);
      wg::tma_rows(base + S::kQ + 4 * S::kTile, &tm_v, k0, bkv, bar_kv);
      if (item.head < n_heads) issue(item, 0);
    } else {
      wg::mbar_expect_tx(bar_kv, 2 * S::kTile);
      wg::tma_tile<D>(base + S::kK, &tm_k, k0, bkv, bar_kv);
      wg::tma_tile<D>(base + S::kV, &tm_v, k0, bkv, bar_kv);
      if (item.head < n_heads) {
        issue(item, 0);
        const Item second = after(item);
        if (second.head < n_heads) issue(second, 1);
      }
    }
  }
  __syncthreads();  // the barriers are initialized

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + w * 16 + g + 8 * i;
    key_ok[i] = key[i] < tk && mp[key[i]] != 0;
  }
  float acc[D / 2];  // dV (warpgroup 0) or dK / scale (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  wg::mbar_wait(bar_kv, 0);
  if constexpr (kF32) {
    // every thread rounds K, V and the first item; warpgroup 1 marks stage 0
    // filled, and the second item's fp32 rows take kStaged
    static_assert(S::kQ + 6 * S::kTile <= S::kStaged, "K's and V's fp32 rows fit before kStaged");
    wg::round_tile<D, kThreads>(smem + S::kQ + 2 * S::kTile, smem + S::kK, tid);
    wg::round_tile<D, kThreads>(smem + S::kQ + 4 * S::kTile, smem + S::kV, tid);
    if (item.head < n_heads) {
      wg::mbar_wait(staged, 0);
      round_item(0, tid, std::integral_constant<int, kThreads>{});
    }
    wg::fence_proxy_async();
    __syncthreads();
    if (role == 1) wg::mbar_arrive(full);
    if (tid == 0 && item.head < n_heads) {
      const Item second = after(item);
      if (second.head < n_heads) issue(second, 1);
    }
  }

  for (int j = 0; item.head < n_heads; ++j) {
    const int stage = j & 1;
    const Item nxt = after(item);
    const int head = head_begin + item.head;
    const int q0 = item.tile * kRows;
    const uint32_t qt = base + S::kQ + stage * 2 * S::kTile;
    const uint32_t ot = qt + S::kTile;
    float* xchg = reinterpret_cast<float*>(smem + S::kX) + stage * kRows * kRows;
    // lse (warpgroup 0) or delta (warpgroup 1) of this thread's 16 query
    // columns, 8*(c>>1) + 2*t4 + (c&1), in flight during the first product
    float row_v[16];
    {
      const float* src = (role == 0 ? lse : delta) + ((size_t)b * h + head) * tq + q0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int jq = 8 * (c >> 1) + 2 * t4 + (c & 1);
        row_v[c] = q0 + jq < tq ? src[jq] : 0.f;
      }
    }
    wg::mbar_wait(full + 8 * stage, (j >> 1) & 1);

    // S^T = K.q^T (warpgroup 0) or dP^T = V.dO^T (warpgroup 1): rows are
    // the block's keys, columns the item's queries. The first wgmma of a
    // product ignores what its accumulator holds, so no accumulator is
    // zeroed.
    float x[32];  // S^T, then P^T (warpgroup 0); dP^T, then dS^T (warpgroup 1)
    {
      const uint32_t a = base + (role == 0 ? S::kK : S::kV);
      const uint32_t bt = role == 0 ? qt : ot;
      wg::hold(x);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wg::mma_ss_n64<0>(x, wg::desc_k<D>(a, kk), wg::desc_k<D>(bt, kk), kk > 0);
      wg::commit();
    }
    if constexpr (kF32) {
      // warpgroup 1, while the products run and warpgroup 0 computes P^T:
      // the next item's fp32 q and dO (landed in kStaged during this item's
      // predecessor) rounded into the other stage, once every warp has
      // released it; then the item after that into kStaged, once every
      // thread of warpgroup 1 has read it (its first thread)
      if (role == 1 && nxt.head < n_heads) {
        if (j >= 1) wg::mbar_wait(empty + 8 * (stage ^ 1), ((j - 1) >> 1) & 1);
        wg::mbar_wait(staged, (j + 1) & 1);
        round_item(stage ^ 1, wtid, std::integral_constant<int, kWG>{});
        wg::fence_proxy_async();
        wg::mbar_arrive(full + 8 * (stage ^ 1));
        if (wtid == 0) {
          const Item far = after(nxt);
          if (far.head < n_heads) {
            wg::mbar_wait(full + 8 * (stage ^ 1), ((j + 1) >> 1) & 1);
            issue(far, 0);
          }
        }
      }
    } else if (tid == 0 && j >= 1 && nxt.head < n_heads) {
      // the item after next into the other stage, once every warp has
      // released it (thread 0; the first two came before the loop)
      wg::mbar_wait(empty + 8 * (stage ^ 1), ((j - 1) >> 1) & 1);
      issue(nxt, stage ^ 1);
    }
    wg::wait_all();
    wg::hold(x);

    // element e of x: key row g + 8*((e>>1)&1) of warp w, query 8*(e>>2) +
    // 2*t4 + (e&1) (row_v[column(e)]); kq[i] - c is key row i's distance to the
    // query of column offset c = 8*(e>>2) + (e&1)
    if (role == 0) {
      const float slope = slopes[head];
      const float kq[2] = {(float)(key[0] - q0 - 2 * t4), (float)(key[1] - q0 - 2 * t4)};
      if (all_valid && q0 + kRows <= tq && (!causal || q0 >= k0 + kRows - 1)) {
        // every (key, query) pair of the item is valid and below every
        // row's key limit: no mask
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + (e & 1);
          x[e] = expf(x[e] * scale - slope * fabsf(kq[(e >> 1) & 1] - (float)c) - row_v[column(e)]);
        }
      } else if (every_row_valid) {
        // a key past a row's limit lies past its diagonal: the mask zeroes
        // P there; rows past t get P = 0
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + (e & 1);
          const int qi = q0 + c + 2 * t4;
          float s = x[e] * scale - slope * fabsf(kq[i] - (float)c);
          s = (key_ok[i] && (!causal || key[i] <= qi)) ? s : kMaskValue;
          const float p = expf(s - row_v[column(e)]);
          x[e] = qi < tq ? p : 0.f;
        }
      } else {
        // rows with no valid key: P = 1 up to their key limit
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + (e & 1);
          const int qi = q0 + c + 2 * t4;
          float s = x[e] * scale - slope * fabsf(kq[i] - (float)c);
          s = (key_ok[i] && (!causal || key[i] <= qi)) ? s : kMaskValue;
          const float p = expf(s - row_v[column(e)]);
          x[e] = key[i] < key_limit(qi, tq, tk, causal) ? p : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) xchg[e * kWG + wtid] = x[e];
      asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + stage), "n"(kThreads) : "memory");
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + stage), "n"(kThreads) : "memory");
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] = xchg[e * kWG + wtid] * (x[e] - row_v[column(e)]);
    }

    // dV += P^T.dO (warpgroup 0) or dK += dS^T.q (warpgroup 1): A from the
    // accumulator in kTerms bf16 terms, the tile's products from zero
    {
      uint32_t a[4][kTerms][4];
      wg::split_a(x, a);
      const uint32_t bt = role == 0 ? ot : qt;
      float tile_sum[D / 2];
      wg::hold(a);
      wg::hold(tile_sum);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term)
          wg::mma_rs<D, 1>(tile_sum, a[kk][term], wg::desc_mn<D>(bt, kk), kk > 0 || term < kTerms - 1);
      wg::commit();
      wg::wait_all();
      wg::hold(tile_sum);
      wg::hold(a);
      if (lane == 0) wg::mbar_arrive(empty + 8 * stage);  // this warp is done with the stage
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile_sum[i];
    }
    item = nxt;
  }

  // element 4j + 2i + c of acc: key row g + 8i of warp w, column 8j + 2t4 + c
  Out* out = role == 0 ? dv : dk;
  const float mul = role == 0 ? 1.f : scale;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= tk) continue;
      Out* op = out + ((size_t)bkv * tk + key[i]) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
    return;
  }
  // the cluster's sums join in rank order through distributed shared
  // memory: each CTA puts its sums in the tiles' space ([role][element]
  // [thread]), then writes every gridDim.z-th pair of each thread's
  // elements, summed over the CTAs 0, 1, ...
  __syncthreads();  // every warp is done with the tiles
  float* part = reinterpret_cast<float*>(smem + S::kK);
  static_assert(2 * (D / 2) * kWG * 4 <= 6 * S::kTile, "no room");
#pragma unroll
  for (int e = 0; e < D / 2; ++e) part[(role * (D / 2) + e) * kWG + wtid] = acc[e];
  cluster_sync();
  const uint32_t mine = smem_addr(part + role * (D / 2) * kWG + wtid);
  for (int pr = blockIdx.z; pr < D / 4; pr += gridDim.z) {  // pair pr: elements 2pr, 2pr + 1
    const int i = pr & 1, j = pr >> 1;
    float x = 0.f, y = 0.f;
    for (int r = 0; r < (int)gridDim.z; ++r) {
      x += ld_cluster(mine + (2 * pr) * kWG * 4, r);
      y += ld_cluster(mine + (2 * pr + 1) * kWG * 4, r);
    }
    if (key[i] < tk) store2(out + ((size_t)bkv * tk + key[i]) * D + 8 * j + 2 * t4, x * mul, y * mul);
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory
}

// kF32: fp32 operands, whose K and V land in `kStaged` (fp32 rows) before
// they are rounded into their stage; q and dO land where the two stages lie
template <int D, bool kF32>
struct DqSmem {
  static constexpr int kTile = Tile<D>::kBytes;  // an fp32 tile of 64 rows: 2 * kTile
  static constexpr int kQ = 0, kO = kTile;
  static constexpr int kK = 2 * kTile;  // [stage][K, V] tiles
  static constexpr int kSlopeRows = 6 * kTile;  // [64 rows][4 lanes] fp32
  static constexpr int kStaged = kSlopeRows + kRows * 4 * 4;  // fp32 K and V of the key tile after next
  static constexpr int kBars = kStaged + (kF32 ? 4 * kTile : 0);
  // mbarriers: q and dO, full[stage], empty[stage], and (kF32) staged
  static constexpr int kWarpFirst = kBars + (kF32 ? 6 : 5) * 8;
  static constexpr int kBits = kWarpFirst + 4 * 4;  // [32-key words]
  static int bytes(int tk) { return kBits + 4 * ((tk + 31) / 32) + 1024; }  // and the alignment's slack
};

// Grid: (blocks of 64 / heads_per_block positions, b) when heads_per_block
// == h (one KV head), else (blocks of 64 positions, b * h). tm_q and tm_o
// take boxes of (positions, heads_per_block) rows, so a block's 64 rows
// come in one copy of each. kTerms: dS's bf16 terms; Out: dQ's type; In:
// the operands' (bf16, or fp32 for the one-pass instances, rounded here).
template <int D, int kTerms, typename Out, typename In>
__global__ void __launch_bounds__(kWG, 2)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                      const float* __restrict__ slopes, const uint8_t* __restrict__ mask,
                      const float* __restrict__ lse, const float* __restrict__ delta, Out* __restrict__ dq,
                      float* __restrict__ dslope_part, int h, int hk, int tq, int tk, int causal, float scale,
                      int heads_per_block) {
  constexpr bool kF32 = std::is_same_v<In, float>;
  static_assert(kF32 || std::is_same_v<In, bf16>, "bf16 or fp32 operands");
  using S = DqSmem<D, kF32>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* slope_rows = reinterpret_cast<float*>(smem + S::kSlopeRows);
  int* warp_first = reinterpret_cast<int*>(smem + S::kWarpFirst);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + S::kBits);
  const uint32_t bar_qo = base + S::kBars;
  const uint32_t full = bar_qo + 8, empty = bar_qo + 24;  // [stage] at + 8 * stage
  const uint32_t staged = bar_qo + 40;  // kF32: the fp32 K and V in kStaged

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int positions = kRows / heads_per_block;
  const int b = heads_per_block == 1 ? blockIdx.y / h : blockIdx.y;
  const int head0 = heads_per_block == 1 ? blockIdx.y % h : 0;
  const int q0 = blockIdx.x * positions;
  const int kv_slab = b * hk + (hk == 1 ? 0 : head0);
  const uint8_t* mp = mask + (size_t)b * tk;
  const size_t row_base = (size_t)b * h;

  // the block's 64 rows of q and dO, and key tile 0 before the mask is
  // read: the walk over the key tiles starts there whatever the mask (a tile
  // whose keys are all masked gives P = 0 on every row with a valid key).
  // With fp32 operands q's and dO's fp32 rows land where the two stages lie
  // and key tile 0's in kStaged, until they are rounded.
  if (tid == 0) {
    wg::mbar_init(bar_qo, 1);
    for (int st = 0; st < 2; ++st) {
      wg::mbar_init(full + 8 * st, kF32 ? kWG : 1);  // with fp32 operands every thread fills a stage
      wg::mbar_init(empty + 8 * st, kWG / 32);  // every warp releases a stage
    }
    if (kF32) wg::mbar_init(staged, 1);
    wg::mbar_init_fence();
    if constexpr (kF32) {
      wg::mbar_expect_tx(bar_qo, 4 * S::kTile);
      wg::tma_rows(base + S::kK, &tm_q, q0, b * h + head0, bar_qo);
      wg::tma_rows(base + S::kK + 2 * S::kTile, &tm_o, q0, b * h + head0, bar_qo);
      wg::mbar_expect_tx(staged, 4 * S::kTile);
      wg::tma_rows(base + S::kStaged, &tm_k, 0, kv_slab, staged);
      wg::tma_rows(base + S::kStaged + 2 * S::kTile, &tm_v, 0, kv_slab, staged);
    } else {
      wg::mbar_expect_tx(bar_qo, 2 * S::kTile);
      wg::tma_tile<D>(base + S::kQ, &tm_q, q0, b * h + head0, bar_qo);
      wg::tma_tile<D>(base + S::kO, &tm_o, q0, b * h + head0, bar_qo);
      wg::mbar_expect_tx(full, 2 * S::kTile);
      wg::tma_tile<D>(base + S::kK, &tm_k, 0, kv_slab, full);
      wg::tma_tile<D>(base + S::kK + S::kTile, &tm_v, 0, kv_slab, full);
    }
  }

  // this thread's rows: g and g + 8 of the warp's 16
  int row_head[2], row_pos[2], row_limit[2];
  float row_slope[2], row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w * 16 + g + 8 * i;
    row_head[i] = head0 + r / positions;
    row_pos[i] = q0 + r % positions;
    row_slope[i] = slopes[row_head[i]];
    row_limit[i] = key_limit(row_pos[i], tq, tk, causal);
    const size_t row = (row_base + row_head[i]) * tq + row_pos[i];
    row_lse[i] = row_pos[i] < tq ? lse[row] : 0.f;
    row_delta[i] = row_pos[i] < tq ? delta[row] : 0.f;
  }

  const int words = (tk + 31) / 32;
  const int all_tiles = (tk + kRows - 1) / kRows;
  const int first_valid = first_valid_key(mp, tk, bits, warp_first);  // and the barriers' initialization
  // a row of this block has no valid key: its first row's, if any
  const bool has_empty_row = first_valid >= tk || (causal && first_valid > q0);
  const int last_pos = min(tq, q0 + positions) - 1;
  int end = causal ? min(all_tiles, last_pos / kRows + 1) : all_tiles;
  if (causal && has_empty_row) end = max(end, (jax_masked_row_keys(last_pos, tq, tk) + kRows - 1) / kRows);
  auto word = [&](int i) { return i < words ? bits[i] : 0u; };
  auto next_tile = [&](int tile) {
    while (tile < end && !has_empty_row && (word(2 * tile) | word(2 * tile + 1)) == 0) ++tile;
    return tile;
  };
  // the key tile's K and V into stage `stage` (thread 0), or with fp32
  // operands their fp32 rows into kStaged
  auto issue = [&](int tile, int stage) {
    if constexpr (kF32) {
      wg::mbar_expect_tx(staged, 4 * S::kTile);
      wg::tma_rows(base + S::kStaged, &tm_k, tile * kRows, kv_slab, staged);
      wg::tma_rows(base + S::kStaged + 2 * S::kTile, &tm_v, tile * kRows, kv_slab, staged);
    } else {
      const uint32_t kt = base + S::kK + stage * 2 * S::kTile;
      wg::mbar_expect_tx(full + 8 * stage, 2 * S::kTile);
      wg::tma_tile<D>(kt, &tm_k, tile * kRows, kv_slab, full + 8 * stage);
      wg::tma_tile<D>(kt + S::kTile, &tm_v, tile * kRows, kv_slab, full + 8 * stage);
    }
  };
  // fp32 operands: the fp32 K and V in kStaged rounded into stage `stage`,
  // then the stage marked filled (every thread)
  auto round_tiles = [&](int stage) {
    uint8_t* kt = smem + S::kK + stage * 2 * S::kTile;
    wg::round_tile<D, kWG>(smem + S::kStaged, kt, tid);
    wg::round_tile<D, kWG>(smem + S::kStaged + 2 * S::kTile, kt + S::kTile, tid);
    wg::fence_proxy_async();
    wg::mbar_arrive(full + 8 * stage);
  };

  int tile = 0;  // end >= 1: every block has a key tile to walk
  if constexpr (kF32) {
    // q and dO rounded first (their fp32 rows lie where key tile 0 goes),
    // then key tile 0; the second tile's fp32 rows take kStaged once every
    // thread has read it
    wg::mbar_wait(bar_qo, 0);
    wg::round_tile<D, kWG>(smem + S::kK, smem + S::kQ, tid);
    wg::round_tile<D, kWG>(smem + S::kK + 2 * S::kTile, smem + S::kO, tid);
    __syncthreads();
    wg::mbar_wait(staged, 0);
    round_tiles(0);
    if (tid == 0) {
      const int second = next_tile(1);
      if (second < end) {
        wg::mbar_wait(full, 0);
        issue(second, 1);
      }
    }
  } else if (tid == 0) {
    const int second = next_tile(1);
    if (second < end) issue(second, 1);
  }

  float acc[D / 2];  // dQ / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float dslope[2] = {0.f, 0.f};
  // full tiles below every row need no mask
  const bool rows_plain = !has_empty_row && last_pos + 1 == q0 + positions;
  if (!kF32) wg::mbar_wait(bar_qo, 0);

  for (int j = 0; tile < end; ++j) {
    const int stage = j & 1;
    const int nxt = next_tile(tile + 1);
    const int k0 = tile * kRows;
    const uint32_t kt = base + S::kK + stage * 2 * S::kTile;
    const uint32_t vt = kt + S::kTile;
    wg::mbar_wait(full + 8 * stage, (j >> 1) & 1);

    // S = q.K^T and dP = dO.V^T (no accumulator is zeroed: the first wgmma
    // of a product ignores it)
    float s[32], dp[32];
    wg::hold(s);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64<0>(s, wg::desc_k<D>(base + S::kQ, kk), wg::desc_k<D>(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64<0>(dp, wg::desc_k<D>(base + S::kO, kk), wg::desc_k<D>(vt, kk), kk > 0);
    wg::commit();
    if constexpr (kF32) {
      // while the products run: the next tile's fp32 K and V (landed in
      // kStaged during this tile's predecessor) rounded into the other
      // stage, once every warp has released it; then the tile after that
      // into kStaged, once every thread has read it (thread 0)
      if (nxt < end) {
        if (j >= 1) wg::mbar_wait(empty + 8 * (stage ^ 1), ((j - 1) >> 1) & 1);
        wg::mbar_wait(staged, (j + 1) & 1);
        round_tiles(stage ^ 1);
        if (tid == 0) {
          const int far = next_tile(nxt + 1);
          if (far < end) {
            wg::mbar_wait(full + 8 * (stage ^ 1), ((j + 1) >> 1) & 1);
            issue(far, 0);
          }
        }
      }
    } else if (tid == 0 && j >= 1 && nxt < end) {
      // the tile after next into the other stage, once every warp has
      // released it (thread 0; the first two came before the loop)
      wg::mbar_wait(empty + 8 * (stage ^ 1), ((j - 1) >> 1) & 1);
      issue(nxt, stage ^ 1);
    }
    wg::wait_all();
    wg::hold(s);
    wg::hold(dp);

    // dS in place of dP: element e is row g + 8*((e>>1)&1) of warp w, key
    // k0 + 8*(e>>2) + 2*t4 + (e&1); kd[i] + c is the key of column offset c
    // = 8*(e>>2) + (e&1) less row i's position
    const uint32_t valid_lo = word(2 * tile), valid_hi = word(2 * tile + 1);
    const float kd[2] = {(float)(k0 + 2 * t4 - row_pos[0]), (float)(k0 + 2 * t4 - row_pos[1])};
    if (rows_plain && (valid_lo & valid_hi) == 0xffffffffu && (!causal || k0 + kRows - 1 <= q0)) {
      // every (row, key) pair of the tile is valid and below every row's
      // key limit: no mask
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const float dist = fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        const float p = expf(s[e] * scale - row_slope[i] * dist - row_lse[i]);
        dp[e] = p * (dp[e] - row_delta[i]);
        dslope[i] = fmaf(dp[e], -dist, dslope[i]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const int jj = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const int kj = k0 + jj;
        const bool valid = (((jj < 32 ? valid_lo : valid_hi) >> (jj & 31)) & 1u) != 0;
        const float dist = fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        float x = s[e] * scale - row_slope[i] * dist;
        x = (valid && (!causal || kj <= row_pos[i])) ? x : kMaskValue;
        const float p = expf(x - row_lse[i]);
        dp[e] = (kj < row_limit[i] ? p : 0.f) * (dp[e] - row_delta[i]);
        dslope[i] = fmaf(dp[e], -dist, dslope[i]);
      }
    }

    // dQ += dS.K: A from the accumulator in kTerms bf16 terms, the tile's
    // products from zero
    uint32_t a[4][kTerms][4];
    wg::split_a(dp, a);
    float tile_sum[D / 2];
    wg::hold(a);
    wg::hold(tile_sum);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int term = kTerms - 1; term >= 0; --term)
        wg::mma_rs<D, 1>(tile_sum, a[kk][term], wg::desc_mn<D>(kt, kk), kk > 0 || term < kTerms - 1);
    wg::commit();
    wg::wait_all();
    wg::hold(tile_sum);
    wg::hold(a);
    if (lane == 0) wg::mbar_arrive(empty + 8 * stage);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += tile_sum[i];
    tile = nxt;
  }

  // element 4j + 2i + c of acc: row g + 8i of warp w, column 8j + 2t4 + c
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row_pos[i] >= tq) continue;
    Out* op = dq + ((row_base + row_head[i]) * tq + row_pos[i]) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }

  // the slope gradient, with the padded keys' part (once a row): each
  // head's rows of the block in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (t4 == 0) dslope[i] += padded_keys_dslope(row_pos[i], row_lse[i], row_delta[i], tq, tk, causal);
    slope_rows[(w * 16 + g + 8 * i) * 4 + t4] = dslope[i];
  }
  __syncthreads();
  if (tid < heads_per_block) {
    float total = 0.f;
    for (int r = tid * positions; r < (tid + 1) * positions; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) total += slope_rows[r * 4 + c];
    dslope_part[(row_base + head0 + tid) * gridDim.x + blockIdx.x] = total;
  }
}

// `map` over an operand, (slabs, rows, D), in boxes of box_rows rows of
// box_slabs slabs: bf16 tiles swizzled as wgmma reads them, or fp32 rows
// for `wg::round_tile`
template <int D, typename In>
bool operand_map(CUtensorMap* map, const In* ptr, int rows, int slabs, int box_rows, int box_slabs) {
  if constexpr (std::is_same_v<In, float>)
    return wg::rows_map_f32<D>(map, ptr, rows, slabs, box_rows, box_slabs);
  else
    return tile_map<D>(map, ptr, rows, slabs, box_rows, box_slabs);
}

template <int D, int kTerms, typename Out, typename In>
int launch_dkv(const In* q, const In* k, const In* v, const float* slopes, const uint8_t* mask, const In* dout,
               const float* lse, const float* delta, Out* dk, Out* dv, int b, int h, int hk, int tq, int tk,
               int causal, float scale, cudaStream_t stream) {
  static const int granted = grant_smem(flash_bwd_dkv_bf16<D, kTerms, Out, In>);
  const int smem = DkvSmem<D, std::is_same_v<In, float>>::kBytes;
  if (smem > granted) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!(operand_map<D>(&tm_q, q, tq, b * h, kRows, 1) && operand_map<D>(&tm_o, dout, tq, b * h, kRows, 1) &&
        operand_map<D>(&tm_k, k, tk, b * hk, kRows, 1) && operand_map<D>(&tm_v, v, tk, b * hk, kRows, 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (tk + kRows - 1) / kRows * b * hk;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // with one KV head a block walks every query head's tiles, so at long t
  // the busiest blocks set the time while blocks of late keys finish early:
  // split the heads over a cluster until there are 4 CTAs an SM
  int split = 1;
  while (hk == 1 && split < 8 && h % (2 * split) == 0 && blocks * split < 4 * sms) split *= 2;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((tk + kRows - 1) / kRows, b * hk, split);
  config.blockDim = dim3(2 * kWG);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, flash_bwd_dkv_bf16<D, kTerms, Out, In>, tm_q, tm_k, tm_v,
                                             tm_o, slopes, mask, lse, delta, dk, dv, h, hk, tq, tk, causal, scale);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D, int kTerms, typename Out, typename In>
int launch_dq(const In* q, const In* k, const In* v, const float* slopes, const uint8_t* mask, const In* dout,
              const float* lse, const float* delta, Out* dq, float* dslope_part, int b, int h, int hk, int tq,
              int tk, int causal, float scale, cudaStream_t stream) {
  static const int granted = grant_smem(flash_bwd_dq_bf16<D, kTerms, Out, In>);
  const int smem = DqSmem<D, std::is_same_v<In, float>>::bytes(tk);
  if (smem > granted) return (int)cudaErrorInvalidValue;
  const bool mqa = hk == 1 && h > 1 && kRows % h == 0;
  const int heads_per_block = mqa ? h : 1;
  const int positions = kRows / heads_per_block;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!(operand_map<D>(&tm_q, q, tq, b * h, positions, heads_per_block) &&
        operand_map<D>(&tm_o, dout, tq, b * h, positions, heads_per_block) &&
        operand_map<D>(&tm_k, k, tk, b * hk, kRows, 1) && operand_map<D>(&tm_v, v, tk, b * hk, kRows, 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((tq + positions - 1) / positions, mqa ? b : b * h);
  flash_bwd_dq_bf16<D, kTerms, Out, In><<<grid, kWG, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, slopes, mask, lse, delta,
                                                                      dq, dslope_part, h, hk, tq, tk, causal, scale,
                                                                      heads_per_block);
  return (int)cudaGetLastError();
}

// launch_dkv (kDkv) or launch_dq at head dim d; out0/out1: dk/dv or dq/dslope parts
template <bool kDkv, int kTerms, typename In, typename Out0, typename Out1>
int dispatch(const In* q, const In* k, const In* v, const float* slopes, const uint8_t* mask, const In* dout,
             const float* lse, const float* delta, Out0* out0, Out1* out1, int b, int h, int hk, int tq, int tk,
             int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk != 1 && hk != h) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    if constexpr (kDkv)
      return launch_dkv<D, kTerms>(q, k, v, slopes, mask, dout, lse, delta, out0, out1, b, h, hk, tq, tk, causal,
                                   scale, s);
    else
      return launch_dq<D, kTerms>(q, k, v, slopes, mask, dout, lse, delta, out0, out1, b, h, hk, tq, tk, causal,
                                  scale, s);
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

// q, dout: (b, h, tq, d) bf16 (fp32 for `_f32`); k, v: (b, hk, tk, d) of
// the same type with hk in {1, h}; slopes: (h,) fp32; mask: (b, tk) bytes,
// nonzero = valid key; lse, delta: (b, h, tq) fp32; dk, dv: (b, hk, tk, d)
// bf16 (fp32 for `_f32`), written whole (with hk = 1, summed over the h
// query heads). Contiguous and 16-byte aligned. Returns the CUDA error code
// of the launch.
#ifndef SP_FLASH_ONE_PASS
extern "C" int sp_flash_attention_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const float* slopes,
                                               const uint8_t* mask, const bf16* dout, const float* lse,
                                               const float* delta, bf16* dk, bf16* dv, int b, int h, int hk, int tq,
                                               int tk, int d, int causal, float scale, void* stream) {
  return dispatch<true, 3, bf16>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk, d, causal,
                                 scale, stream);
}
#endif

// As above; dq: (b, h, tq, d) bf16 (fp32 for `_f32`); dslope_part: (b, h,
// blocks) fp32, each block's part of sum dS * (-|i-j|) for each head it
// holds, for the caller to sum over b and blocks. A block holds 64 (head,
// position) rows: with hk = 1 and h dividing 64, all h heads at 64/h
// positions (blocks = ceil(tq / (64/h))), else 64 positions of one head
// (blocks = ceil(tq / 64)).
#ifndef SP_FLASH_ONE_PASS
extern "C" int sp_flash_attention_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const float* slopes,
                                              const uint8_t* mask, const bf16* dout, const float* lse,
                                              const float* delta, bf16* dq, float* dslope_part, int b, int h, int hk,
                                              int tq, int tk, int d, int causal, float scale, void* stream) {
  return dispatch<false, 3, bf16>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk, tq, tk, d,
                                  causal, scale, stream);
}
#else
// The one-pass instances (P^T, dS^T and dS in one bf16 term): bf16 operands
// and gradients, or (`_f32`) fp32 operands, rounded to bf16 in the kernel,
// and fp32 gradients.
extern "C" int sp_flash_attention_bwd_dkv_one_pass(const bf16* q, const bf16* k, const bf16* v, const float* slopes,
                                                   const uint8_t* mask, const bf16* dout, const float* lse,
                                                   const float* delta, bf16* dk, bf16* dv, int b, int h, int hk,
                                                   int tq, int tk, int d, int causal, float scale, void* stream) {
  return dispatch<true, 1, bf16>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk, d, causal,
                                 scale, stream);
}

extern "C" int sp_flash_attention_bwd_dkv_one_pass_f32(const float* q, const float* k, const float* v,
                                                       const float* slopes, const uint8_t* mask, const float* dout,
                                                       const float* lse, const float* delta, float* dk, float* dv,
                                                       int b, int h, int hk, int tq, int tk, int d, int causal,
                                                       float scale, void* stream) {
  return dispatch<true, 1, float>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk, d, causal,
                                  scale, stream);
}

extern "C" int sp_flash_attention_bwd_dq_one_pass(const bf16* q, const bf16* k, const bf16* v, const float* slopes,
                                                  const uint8_t* mask, const bf16* dout, const float* lse,
                                                  const float* delta, bf16* dq, float* dslope_part, int b, int h,
                                                  int hk, int tq, int tk, int d, int causal, float scale,
                                                  void* stream) {
  return dispatch<false, 1, bf16>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk, tq, tk, d,
                                  causal, scale, stream);
}

extern "C" int sp_flash_attention_bwd_dq_one_pass_f32(const float* q, const float* k, const float* v,
                                                      const float* slopes, const uint8_t* mask, const float* dout,
                                                      const float* lse, const float* delta, float* dq,
                                                      float* dslope_part, int b, int h, int hk, int tq, int tk, int d,
                                                      int causal, float scale, void* stream) {
  return dispatch<false, 1, float>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk, tq, tk, d,
                                   causal, scale, stream);
}
#endif

// Flash-attention forward on bf16 operands, with ALiBi generated in the
// kernel, on Hopper's warpgroup MMA (`wgmma`): o in bf16 and the row
// logsumexp in fp32, every sum fp32-accurate; and, built from this file by
// csrc/flash_attention_fwd_one_pass.cu (SP_FLASH_ONE_PASS), the one-pass
// instances (kTerms = 1): bf16 operands and o, or fp32 operands rounded to
// bf16 in the kernel and fp32 o.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_kernel (:49),
// the Pallas forward that `_flash_forward` launches (:314) for
// `flash_attention_alibi`, for a model held in bf16 (q, k, v bf16, slopes
// fp32), and at the Pallas kernel's "default" precision for any operands.
// The fp32 instances are csrc/flash_attention_fwd.cu's.
//
// The math, per (batch, head): s = scale*(q.k) - slope*|i-j|, masked to
// -1e30 (key mask, causal); o = softmax(s).v, lse = m + log(l).
//
// Numerics. The Pallas kernel upcasts its blocks and takes its products at
// the `precision` it is given: JAX's model gives none, so "default", where
// the TPU rounds each dot's operands to bf16 and sums in fp32 (one pass);
// "highest" is the JAX parity tests' setting. These instances (kTerms = 3)
// are fp32-accurate, as "highest" is. A bf16 times a bf16 is exact in fp32, so S =
// q.K^T is a single bf16 product, scale applied to S in fp32 afterwards (the
// Pallas kernel scales q before the dot: at d = 32 and 128, whose scale is no
// power of two, the two orders differ by fp32 rounding, within one bf16 ulp
// of o and 1e-5 of lse, tests/test_torch_flash_fwd_bf16_split.py). Bias,
// mask, the online max, exp and the row sums stay in fp32 registers. P is
// fp32: it is split into three bf16 terms (wgmma.cuh's split3), whose sum is
// P exactly down to bf16's subnormals, so P.V takes three bf16 products
// against the same V tile. The tensor cores truncate the fp32 sums they
// accumulate, so each key tile's 12 products start from zero and join the
// running o by rounded fp32 operations, o = alpha*o, then o + tile. No
// atomics, and every sum runs in a fixed order: two calls give the same bits.
// The one-pass instances (kTerms = 1) take the TPU's "default" numerics: P
// is one bf16 term, bf16(P) rounded to nearest even, so P.V is 4 products a
// tile, and S = bf16(q*scale).bf16(k) (the Pallas kernel scales q before
// its dot). They take q, k and v as the caller holds them (`In`: bf16, or
// fp32) with the real scale, and round them here: q times the scale in
// fp32, then to bf16, and k and v (fp32) to bf16, each to nearest even as
// torch rounds (`cvt.rn`), so the bits are those of `(q.float() *
// scale).to(torch.bfloat16)` and `.to(torch.bfloat16)`; S is then scaled
// by 1. The rest is the arithmetic the instances ran on such copies, and o
// is written in the operands' dtype (`Out`).
//
// Bound on the H100: 4 bf16 passes over the valid (query, key) pairs of
// each head (S, and three for P.V; 2 for the one-pass instances), each 2*d
// operations a pair, at 989 TFLOP/s (bf16 dense); the bytes (q, k, v, o in
// bf16, lse) are far below at the timed shapes (chip_smoke.py's
// `bound_tc_ms`, BF16_FWD_PASSES, ONE_PASS_PASSES). On fp32 operands the
// one-pass instances read 4 bytes an element and write fp32 o, and the
// bytes bound them at the flagship's shapes (about 85 MB at b 128, h 4,
// one KV head, d 64, t 258: 0.025 ms; chip_smoke.py::check_flash_one_pass).
//
// Design. A CTA of two warpgroups (256 threads) holds 128 query rows: each
// warpgroup 64, wgmma's M. With one KV head the 64 rows of a warpgroup are
// the h heads x 64/h positions of one batch element, and the CTA's two row
// blocks are consecutive positions of it, so each K/V tile is read once for
// 128 rows; otherwise 64 positions of one head each. Every operand is a
// 64-row bf16 tile in shared memory, swizzled as wgmma reads it (wgmma.cuh),
// copied by TMA from a 3-d tensor map (rows past t land as zeros) onto
// mbarriers: q once, K and V in tiles of 64 keys through a ring of three
// stages. Thread 0 issues each tile two ahead, once every warp has released
// the stage it refills on that stage's empty barrier. A warpgroup's tile
// step: the masked online softmax on S in the accumulator layout (a row's 64
// keys over the four lanes of a quad, two shuffles for its max), P split
// into three bf16 A fragments straight from the accumulator, P.V as 12
// register-sourced wgmmas whose B is the V tile read MN-major through the
// transpose bit (the running o rescaled while they run), then the next
// tile's S = q.K^T (shared-memory operands) while the tile joins o. S
// cannot be issued before the softmax: beside o, the tile's sum and P's 48
// registers (16 in one term), its 32 would spill at d = 128 (255
// registers). The two
// warpgroups run independently, so one's softmax overlaps the other's
// products; making them take turns at the tensor cores on named barriers
// gained nothing (0.99-1.03x the time, chip_probe_flash_fwd_bf16.py). A
// tile whose 64 x 64 pairs are all valid and below every row's key limit
// takes a path with no mask. exp is `__expf` (ex2.approx of x*log2(e)):
// within every gate, and 7-15% faster than `expf`. Causal CTAs run in
// reverse order of their rows, so the CTAs with the most key tiles start
// first. Every branch that a wgmma follows is on a value that ptxas sees as
// warp-uniform (`uniform`), and S is waited for on every path: otherwise
// ptxas serializes every wgmma (its C7518), which cost 4-15%.
//
// Operands rounded here (the one-pass instances). Rounding in the kernel
// takes the wrapper's copies away (three conversions a forward on fp32
// operands, bf16(q*scale) on bf16 ones: a pass over q, k and v each time,
// 30 a flagship train step). fp32 operand rows land by TMA unswizzled
// (`wg::rows_map_f32`, a box of all d columns) in a staging area,
// `kStaged`, and the threads round them into the bf16 swizzle that the
// unchanged wgmmas read (`wg::round_tile`), fence them for the async proxy
// and then mark them ready, as the backward's fp32 instances do
// (csrc/flash_attention_bwd_bf16.cu).
// - q lands once a CTA, each warpgroup's 64 rows on their own: fp32 rows in
//   its half of kStaged, a bf16 tile swizzled where the wgmmas read it; each
//   warpgroup scales and rounds its own q tile (bf16 in place,
//   `wg::scale_tile`: the scale is elementwise, so the swizzle stays) and
//   waits only for its own threads (a named barrier). On bf16 operands that
//   is all: K and V come swizzled into the ring as before.
// - fp32 K and V: key tile 0's rows land where stages 1 and 2 lie, with q
//   on q's barrier, and are rounded into stage 0 before the loop (stage 0's
//   barrier orders those reads before stage 1's first rounding). After
//   that one staging buffer takes one key tile's rows at a time, split
//   between the warpgroups: warpgroup 0 rounds K, warpgroup 1 V, each
//   through its own half of kStaged, which its first thread refills with
//   the tile after next once the warpgroup's threads have read it (a named
//   barrier) and waits for on its own mbarrier; a stage's full barrier
//   counts all 256 threads, so neither warpgroup waits for the other but
//   where it needs the other's half of a tile. Each warpgroup rounds its
//   half of tile j+1 while its P.V wgmmas of tile j run, into the stage
//   that tile j-2 used once every warp has released it; a half's copy is
//   issued a whole tile step before its rounding. Loads in flight a thread
//   are held to 4 at d = 128, where the accumulators take most registers.
//   Shared memory: one fp32 stage of K and V is 4 bf16 tiles, so at d = 128
//   the CTA holds 192 KB of tiles (128 KB on bf16 operands), still one CTA
//   an SM (chip_smoke.py::one_pass_fwd_smem, with ptxas's report).
// What the card showed (graph replay on the H100, PERF.md §6 PR 24): the
// route's bits are those of the wrapper's copies through the same kernel;
// on fp32 operands at the flagship's shapes (b 128, h 4, one KV head, d 64,
// t 258 / 257) 0.081 / 0.071 ms, against 0.116 / 0.110 for the copies and
// the kernel on them (0.067 / 0.059 alone), and 0.74x / 0.37x SDPA's bf16
// forward; on bf16 operands 0.069 / 0.063 ms, 2.5-4.7% over the kernel on
// the wrapper's bf16(q*scale) (q's scale in place on its tile). Tried and
// dropped, each the same bits and within 1% at d = 64:
// q landed where the q tiles and stage 0 lie so that key tile 1 lands at
// the start; each warpgroup rounding its half two tiles ahead (a tile and
// a half of slack between the warpgroups); K and V loaded into registers a
// tile ahead, never in fp32 in shared memory (at d = 128 it spills, 2.2x).
// So neither the prologue, the coupling nor the staging round trip costs
// the 22% over the kernel on copies; the fp32 rows read from L2, twice the
// bytes, are what is left. 8 loads in flight at d = 128 spill (+5%).
//
// Masked tiles and rows with no valid key: a key tile whose keys are all
// masked is skipped unless the CTA holds a query row with no valid key; with
// `causal`, tiles past the CTA's last row are not read (a warpgroup whose
// rows end earlier computes the CTA's last tile with its rows masked). A row
// with no valid key gets the JAX wrapper's answer: that wrapper pads keys to
// whole blocks with mask 0, so the row averages v (zero past t) over the
// keys of the key blocks it visits (`masked_row_keys`): its scores are all
// -1e30, so P = 1 on every key below its key limit (`wg::key_limit`: t, or
// with `causal` the keys up to its query block's end) and 0 past it, and l
// is the count of the padded keys.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wg::first_valid_key;
using wg::grant_smem;
using wg::key_limit;
using wg::masked_row_keys;
using wg::smem_addr;
using wg::store2;
using tf32::store2;  // fp32 o (the one-pass instances on fp32 operands)
using wg::Tile;
using wg::tile_map;

constexpr int kRows = 64;     // query rows of a warpgroup, keys of a tile
constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kGroups = 2;    // warpgroups of a CTA
constexpr int kStages = 3;    // K/V tiles in flight
constexpr float kMaskValue = -1e30f;

// the CTA's shared memory, from a 1024-byte aligned base; on fp32 operands
// (kF32) with a staging area, where fp32 rows land before the threads round
// them: q's, then a key tile's K and V, 4 bf16 tiles' worth. Keep
// chip_smoke.py::one_pass_fwd_smem, which prints a launch's bytes, in step.
template <int D, bool kF32>
struct FwdSmem {
  static constexpr int kTile = Tile<D>::kBytes;
  static constexpr int kQ = 0;                       // [warpgroup] q tiles
  static constexpr int kKV = kGroups * kTile;        // [stage][K, V] tiles
  static constexpr int kStaged = kKV + kStages * 2 * kTile;  // [warpgroup] halves of the rows to round
  // mbarriers: q, full[stage], empty[stage], and on fp32 operands staged[warpgroup]
  static constexpr int kBars = kStaged + (kF32 ? 4 * kTile : 0);
  static constexpr int kWarpFirst = kBars + (1 + 2 * kStages + (kF32 ? kGroups : 0)) * 8;
  static constexpr int kBits = kWarpFirst + kGroups * 4 * 4;  // [32-key words]
  static int bytes(int tk) { return kBits + 4 * ((tk + 31) / 32) + 1024; }  // and the alignment's slack
};

// Grid: (b when heads_per_block == h (one KV head), else b * h; CTAs of two
// row blocks). A row block is 64 (head, position) rows: heads_per_block
// heads x 64 / heads_per_block positions. tm_q takes boxes of (positions,
// heads_per_block) rows, so a warpgroup's 64 rows come in one copy. kTerms:
// P's bf16 terms (3, or 1 for the one-pass instances); Out: o's type; In:
// q's, k's and v's (bf16, or fp32 for the one-pass instances, rounded
// here). S is scaled by `scale`; the one-pass instances round
// bf16(q*q_scale) themselves and take `scale` 1.
template <int D, int kTerms, typename Out, typename In>
__global__ void __launch_bounds__(kGroups * kWG, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ slopes,
                   const uint8_t* __restrict__ mask, Out* __restrict__ out, float* __restrict__ lse, int h, int hk,
                   int tq, int tk, int causal, float scale, float q_scale, int heads_per_block) {
  constexpr bool kF32 = std::is_same_v<In, float>;
  constexpr bool kRoundQ = kTerms == 1;  // q scaled and rounded here
  static_assert(kF32 || std::is_same_v<In, bf16>, "bf16 or fp32 operands");
  static_assert(!kF32 || kRoundQ, "fp32 operands in the one-pass instances");
  using S = FwdSmem<D, kF32>;
  // loads in flight a thread while it rounds K or V beside P.V's wgmmas,
  // whose accumulators hold most registers at d = 128
  constexpr int kRoundBatch = D >= 128 ? 4 : 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* warp_first = reinterpret_cast<int*>(smem + S::kWarpFirst);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + S::kBits);
  const uint32_t bar_q = base + S::kBars;
  const uint32_t full = bar_q + 8, empty = full + 8 * kStages;  // [stage] at + 8 * stage
  const uint32_t staged = empty + 8 * kStages;  // fp32 operands: [warpgroup] its half of kStaged at + 8 * group

  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform as ptxas sees it: wgmmas behind a branch
  // on a value that ptxas takes as divergent (one of threadIdx, or a load)
  // are serialized, so such values that the branches read are broadcast
  // from lane 0 (`uniform`)
  auto uniform = [](int x) { return __shfl_sync(0xffffffffu, x, 0); };
  const int group = uniform(tid / kWG);
  const int wtid = tid % kWG;
  const int w = wtid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int positions = kRows / heads_per_block;
  const int b = heads_per_block == 1 ? blockIdx.x / h : blockIdx.x;
  const int head0 = heads_per_block == 1 ? blockIdx.x % h : 0;
  const int cta = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // the latest rows first
  const int cta_q0 = cta * kGroups * positions;
  const int q0 = cta_q0 + group * positions;  // this warpgroup's first position
  const int kv_slab = b * hk + (hk == 1 ? 0 : head0);
  const uint8_t* mp = mask + (size_t)b * tk;
  const size_t row_base = (size_t)b * h;
  const uint32_t qt = base + S::kQ + group * S::kTile;

  // both row blocks of q, and key tile 0 before the mask is read: the walk
  // over the key tiles starts there whatever the mask. On fp32 operands q
  // lands as rows in kStaged, warpgroup gr's in its half, and key tile 0's
  // K and V rows where stages 1 and 2 lie, on q's barrier.
  if (tid == 0) {
    wg::prefetch_map(&tm_q);
    wg::prefetch_map(&tm_k);
    wg::prefetch_map(&tm_v);
    wg::mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      wg::mbar_init(full + 8 * st, kF32 ? kGroups * kWG : 1);  // on fp32 operands every thread fills a stage
      wg::mbar_init(empty + 8 * st, kGroups * kWG / 32);  // every warp releases a stage
    }
    if constexpr (kF32)
      for (int gr = 0; gr < kGroups; ++gr) wg::mbar_init(staged + 8 * gr, 1);
    wg::mbar_init_fence();
    if constexpr (kF32) {
      wg::mbar_expect_tx(bar_q, 8 * S::kTile);
      for (int gr = 0; gr < kGroups; ++gr)
        wg::tma_rows(base + S::kStaged + gr * 2 * S::kTile, &tm_q, cta_q0 + gr * positions, b * h + head0, bar_q);
      wg::tma_rows(base + S::kKV + 2 * S::kTile, &tm_k, 0, kv_slab, bar_q);
      wg::tma_rows(base + S::kKV + 4 * S::kTile, &tm_v, 0, kv_slab, bar_q);
    } else {
      wg::mbar_expect_tx(bar_q, kGroups * S::kTile);
      for (int gr = 0; gr < kGroups; ++gr)
        wg::tma_tile<D>(base + S::kQ + gr * S::kTile, &tm_q, cta_q0 + gr * positions, b * h + head0, bar_q);
      wg::mbar_expect_tx(full, 2 * S::kTile);
      wg::tma_tile<D>(base + S::kKV, &tm_k, 0, kv_slab, full);
      wg::tma_tile<D>(base + S::kKV + S::kTile, &tm_v, 0, kv_slab, full);
    }
  }

  // this thread's rows: g and g + 8 of its warp's 16
  int row_head[2], row_pos[2], row_limit[2];
  float row_slope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w * 16 + g + 8 * i;
    row_head[i] = head0 + r / positions;
    row_pos[i] = q0 + r % positions;
    row_slope[i] = slopes[row_head[i]];
    row_limit[i] = key_limit(row_pos[i], tq, tk, causal);
  }

  const int words = (tk + 31) / 32;
  const int all_tiles = (tk + kRows - 1) / kRows;
  const int first_valid = uniform(first_valid_key(mp, tk, bits, warp_first));  // and the barriers' initialization
  // the tiles the CTA reads: each row block's, with `causal` up to its last
  // row's, or up to that row's JAX key limit when a row of it has no valid
  // key
  auto tiles_end = [&](int first_pos) {
    const int last_pos = max(0, min(tq, first_pos + positions) - 1);
    if (!causal) return all_tiles;
    int e = min(all_tiles, last_pos / kRows + 1);
    if (first_valid > first_pos) e = max(e, (key_limit(last_pos, tq, tk, 1) + kRows - 1) / kRows);
    return e;
  };
  const bool cta_empty_row = first_valid >= tk || (causal && first_valid > cta_q0);
  const bool empty_row = first_valid >= tk || (causal && first_valid > q0);
  int end = 0;
  for (int gr = 0; gr < kGroups; ++gr) end = max(end, tiles_end(cta_q0 + gr * positions));
  auto word = [&](int i) { return i < words ? bits[i] : 0u; };
  auto next_tile = [&](int tile) {
    while (tile < end && !cta_empty_row && (word(2 * tile) | word(2 * tile + 1)) == 0) ++tile;
    return tile;
  };
  // the key tile's K and V into stage `stage` (thread 0)
  auto issue = [&](int tile, int stage) {
    const uint32_t kt = base + S::kKV + stage * 2 * S::kTile;
    wg::mbar_expect_tx(full + 8 * stage, 2 * S::kTile);
    wg::tma_tile<D>(kt, &tm_k, tile * kRows, kv_slab, full + 8 * stage);
    wg::tma_tile<D>(kt + S::kTile, &tm_v, tile * kRows, kv_slab, full + 8 * stage);
  };
  // fp32 operands: the warpgroups share each key tile's rounding, warpgroup
  // 0 K's and warpgroup 1 V's, each through its own half of kStaged, which
  // its first thread refills (`stage_rows`) once its threads have read it
  // (`group_sync`): neither waits for the other but on a stage's barriers
  auto group_sync = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kWG) : "memory"); };
  auto stage_rows = [&](int tile) {
    const uint32_t bar = staged + 8 * group;
    wg::mbar_expect_tx(bar, 2 * S::kTile);
    wg::tma_rows(base + S::kStaged + group * 2 * S::kTile, group == 0 ? &tm_k : &tm_v, tile * kRows, kv_slab, bar);
  };
  // this warpgroup's half of the key tile at `src` (fp32 rows) rounded into
  // stage `stage`, then the stage marked filled by its threads
  auto round_half = [&](const uint8_t* src, int stage) {
    wg::round_tile<D, kWG, false, kRoundBatch>(src, smem + S::kKV + (stage * 2 + group) * S::kTile, wtid);
    wg::fence_proxy_async();
    wg::mbar_arrive(full + 8 * stage);
  };

  // thread 0's cursor over the tiles still to issue (on fp32 operands, the
  // tile whose rows come to kStaged next); the first stages now
  int ahead = next_tile(1);
  if (!kF32 && tid == 0)
    for (int st = 1; st < kStages && ahead < end; ++st) {
      issue(ahead, st);
      ahead = next_tile(ahead + 1);
    }

  float acc[D / 2];  // o, unnormalized
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  // full tiles below every row need no mask
  const bool rows_plain = !empty_row && q0 + positions <= tq;

  // bf16 operands: the tile after the ring's others into the stage tile j-1
  // used, once every warp has released it (thread 0; the first ones came
  // before the loop)
  auto refill = [&](int j) {
    if (!kF32 && tid == 0 && j >= 1 && ahead < end) {
      const int prev = (j - 1) % kStages;
      wg::mbar_wait(empty + 8 * prev, ((j - 1) / kStages) & 1);
      issue(ahead, prev);
      ahead = next_tile(ahead + 1);
    }
  };
  auto stage_tile = [&](int j) { return base + S::kKV + (j % kStages) * 2 * S::kTile; };  // K; V follows
  // S = q.K^T of the tile in stage j (no accumulator is zeroed: the first
  // wgmma of a product ignores it)
  float s[32];
  auto issue_s = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64<0>(s, wg::desc_k<D>(qt, kk), wg::desc_k<D>(stage_tile(j), kk), kk > 0);
  };
  wg::mbar_wait(bar_q, 0);
  if constexpr (kRoundQ) {
    // this warpgroup's q times the scale, rounded into its q tile
    // (bf16(q*scale), as `_flash_kernel` scales q before its dot): on fp32
    // operands from its rows, on bf16 ones where the tile lies; the tile
    // whole before its wgmmas read it
    if constexpr (kF32)
      wg::round_tile<D, kWG, true>(smem + S::kStaged + group * 2 * S::kTile, smem + S::kQ + group * S::kTile, wtid,
                                   q_scale);
    else
      wg::scale_tile<D, kWG>(smem + S::kQ + group * S::kTile, wtid, q_scale);
    wg::fence_proxy_async();
    group_sync();
  }
  if constexpr (kF32) {
    // this warpgroup's half of kStaged, read, takes key tile 1's rows; tile
    // 0's, landed where stages 1 and 2 lie, are rounded into stage 0, and
    // stage 0's barrier orders those reads before stage 1's first rounding
    if (wtid == 0 && ahead < end) stage_rows(ahead);
    round_half(smem + S::kKV + (2 + 2 * group) * S::kTile, 0);
  }
  wg::mbar_wait(full, 0);
  wg::hold(s);
  wg::fence();
  issue_s(0);
  wg::commit();
  wg::wait_all();
  wg::hold(s);

  int tile = 0;  // end >= 1: every CTA has a key tile to walk
  for (int j = 0; tile < end; ++j) {
    const int stage = j % kStages;
    const int nxt = uniform(next_tile(tile + 1));
    const bool last = nxt >= end;
    const int k0 = tile * kRows;
    // the scores in place of S: element e is row g + 8*((e>>1)&1) of warp
    // w, key k0 + 8*(e>>2) + 2*t4 + (e&1); kd[i] + c is the key of column
    // offset c = 8*(e>>2) + (e&1) less row i's position
    const float kd[2] = {(float)(k0 + 2 * t4 - row_pos[0]), (float)(k0 + 2 * t4 - row_pos[1])};
    const uint32_t valid_lo = word(2 * tile), valid_hi = word(2 * tile + 1);
    const bool plain = rows_plain && (valid_lo & valid_hi) == 0xffffffffu && (!causal || k0 + kRows - 1 <= q0);
    float mx[2] = {m[0], m[1]};
    if (plain) {
      // every (row, key) pair of the tile is valid and below every row's
      // key limit: no mask
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        s[e] = s[e] * scale - row_slope[i] * fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        mx[i] = fmaxf(mx[i], s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const int jj = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const bool valid = (((jj < 32 ? valid_lo : valid_hi) >> (jj & 31)) & 1u) != 0;
        const float x = s[e] * scale - row_slope[i] * fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        s[e] = (valid && (!causal || k0 + jj <= row_pos[i])) ? x : kMaskValue;
        mx[i] = fmaxf(mx[i], s[e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float sum[2] = {0.f, 0.f};
    if (plain) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = __expf(s[e] - m[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += s[e];
      }
    } else {
      // a key at or past a row's key limit (past t, or past a causal row's
      // JAX key blocks) takes no part
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const int kj = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        s[e] = kj < row_limit[i] ? __expf(s[e] - m[i]) : 0.f;
        sum[i] += s[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

    // the tile's P.V, A from the accumulator in kTerms bf16 terms, the
    // products from zero; o is rescaled while they run
    uint32_t a[4][kTerms][4];
    wg::split_a(s, a);
    float tile_sum[D / 2];
    wg::hold(a);
    wg::hold(tile_sum);
    wg::fence();
    const uint32_t vt = stage_tile(j) + S::kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int term = kTerms - 1; term >= 0; --term)
        wg::mma_rs<D, 1>(tile_sum, a[kk][term], wg::desc_mn<D>(vt, kk), kk > 0 || term < kTerms - 1);
    wg::commit();
    refill(j);
    if constexpr (kF32) {
      // while P.V runs: this warpgroup's half of the next tile, from
      // kStaged into its stage once every warp has released the stage's
      // last tile; then the tile after it into kStaged
      if (!last) {
        const int ns = (j + 1) % kStages;
        if (j + 1 >= kStages) wg::mbar_wait(empty + 8 * ns, ((j - 2) / kStages) & 1);
        wg::mbar_wait(staged + 8 * group, j & 1);
        round_half(smem + S::kStaged + group * 2 * S::kTile, ns);
        group_sync();
        if (wtid == 0) {
          const int far = next_tile(nxt + 1);
          if (far < end) stage_rows(far);
        }
      }
    }
    // element 4j + 2i + c of acc: row g + 8i of warp w, column 8j + 2t4 + c
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    wg::wait_all();
    wg::hold(tile_sum);
    wg::hold(a);
    if (lane == 0) wg::mbar_arrive(empty + 8 * stage);  // this warp is done with the stage
    // the next tile's S (P is spent), while the tile joins o
    if (!last) {
      wg::mbar_wait(full + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
      wg::hold(s);
      wg::fence();
      issue_s(j + 1);
      wg::commit();
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] += tile_sum[e];
    // unconditional, so that ptxas sees no path on which S is still in flight
    wg::wait_all();
    wg::hold(s);
    tile = nxt;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row_pos[i];
    if (qi >= tq) continue;
    const float lc = m[i] == kMaskValue ? (float)masked_row_keys(qi, tq, tk, causal) : fmaxf(l[i], 1e-30f);
    const size_t row = (row_base + row_head[i]) * tq + qi;
    Out* op = out + row * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, acc[4 * j + 2 * i] / lc, acc[4 * j + 2 * i + 1] / lc);
    if (lse != nullptr && t4 == 0) lse[row] = m[i] + logf(lc);
  }
}

template <int D, int kTerms, typename Out, typename In>
int launch(const In* q, const In* k, const In* v, const float* slopes, const uint8_t* mask, Out* out, float* lse,
           int b, int h, int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  constexpr bool kRoundQ = kTerms == 1;
  static const int granted = grant_smem(flash_fwd_bf16<D, kTerms, Out, In>);
  const int smem = FwdSmem<D, std::is_same_v<In, float>>::bytes(tk);
  if (smem > granted) return (int)cudaErrorInvalidValue;
  const bool mqa = hk == 1 && h > 1 && kRows % h == 0;
  const int heads_per_block = mqa ? h : 1;
  const int positions = kRows / heads_per_block;
  CUtensorMap tm_q, tm_k, tm_v;
  bool mapped;
  if constexpr (std::is_same_v<In, float>)
    mapped = wg::rows_map_f32<D>(&tm_q, q, tq, b * h, positions, heads_per_block) &&
             wg::rows_map_f32<D>(&tm_k, k, tk, b * hk, kRows, 1) &&
             wg::rows_map_f32<D>(&tm_v, v, tk, b * hk, kRows, 1);
  else
    mapped = tile_map<D>(&tm_q, q, tq, b * h, positions, heads_per_block) &&
             tile_map<D>(&tm_k, k, tk, b * hk, kRows, 1) && tile_map<D>(&tm_v, v, tk, b * hk, kRows, 1);
  if (!mapped) return (int)cudaErrorInvalidValue;
  const int row_blocks = (tq + positions - 1) / positions;
  const dim3 grid(mqa ? b : b * h, (row_blocks + kGroups - 1) / kGroups);
  // the one-pass instances scale q before they round it and S by 1
  flash_fwd_bf16<D, kTerms, Out, In><<<grid, kGroups * kWG, smem, stream>>>(
      tm_q, tm_k, tm_v, slopes, mask, out, lse, h, hk, tq, tk, causal, kRoundQ ? 1.f : scale, kRoundQ ? scale : 1.f,
      heads_per_block);
  return (int)cudaGetLastError();
}

template <int kTerms, typename Out, typename In>
int dispatch(const In* q, const In* k, const In* v, const float* slopes, const uint8_t* mask, Out* out, float* lse,
             int b, int h, int hk, int tq, int tk, int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk != 1 && hk != h) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch<D, kTerms, Out, In>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
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

// q: (b, h, tq, d); k, v: (b, hk, tk, d) with hk in {1, h}, all of one
// dtype, bf16 (fp32 for `_f32`); slopes: (h,) fp32; mask: (b, tk) bytes,
// nonzero = valid key; out: (b, h, tq, d) in the operands' dtype; lse:
// (b, h, tq) fp32 or null. Contiguous and 16-byte aligned. Returns the CUDA
// error code of the launch.
#ifndef SP_FLASH_ONE_PASS
extern "C" int sp_flash_attention_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* slopes,
                                           const uint8_t* mask, bf16* out, float* lse, int b, int h, int hk, int tq,
                                           int tk, int d, int causal, float scale, void* stream) {
  return dispatch<3>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, d, causal, scale, stream);
}
#else
// The one-pass instances: P in one bf16 term; q as the caller holds it,
// rounded here to bf16(q*scale) as the TPU's "default" rounds the Pallas
// kernel's scaled q, and k and v rounded here (`_f32`) or bf16 already.
extern "C" int sp_flash_attention_fwd_one_pass(const bf16* q, const bf16* k, const bf16* v, const float* slopes,
                                               const uint8_t* mask, bf16* out, float* lse, int b, int h, int hk,
                                               int tq, int tk, int d, int causal, float scale, void* stream) {
  return dispatch<1>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, d, causal, scale, stream);
}

extern "C" int sp_flash_attention_fwd_one_pass_f32(const float* q, const float* k, const float* v,
                                                   const float* slopes, const uint8_t* mask, float* out, float* lse,
                                                   int b, int h, int hk, int tq, int tk, int d, int causal,
                                                   float scale, void* stream) {
  return dispatch<1>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, d, causal, scale, stream);
}
#endif

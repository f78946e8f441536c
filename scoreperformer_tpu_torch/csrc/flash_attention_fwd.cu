// Flash-attention forward with ALiBi generated in the kernel, fp32 in and
// out, on Hopper's warpgroup MMA (`wgmma`) in split TF32: o and the row
// logsumexp, every sum fp32-accurate. The bf16 instances are
// csrc/flash_attention_fwd_bf16.cu's.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_kernel (:49),
// the Pallas forward that `_flash_forward` launches (`pl.pallas_call` at
// :314) for `flash_attention_alibi`, on fp32 operands.
//
// The math, per (batch, head): s = (q*scale).k - slope*|i-j|, masked to
// -1e30 (key mask, causal); o = softmax(s).v, lse = m + log(l), l clamped at
// 1e-30.
//
// Numerics: those of the Pallas kernel at "highest", and of the port's fp32
// backward (flash_attention_bwd.cu), which recomputes S from this lse. q is
// scaled before the dot, as the Pallas kernel scales it. Both products are
// three TF32 `wgmma` products each, lo.hi + hi.lo + hi.hi, every operand
// split by wgmma.cuh's `tf32::split` (x = hi + lo, rounded to nearest). The
// tensor cores truncate the fp32 sums they accumulate, so both products take
// each k-step (8 of d for S = (q*scale).K^T, as the backward takes S; 8 keys
// for P.V) from zero and join the k-steps in order by rounded fp32 adds, P.V's
// into the running o after o = alpha*o. Longer chains bias the sums toward
// zero, and the slope gradients that the backward takes from this o and lse
// follow: P.V over a 64-key tile in one chain of 24 wgmma adds moved a batch-4
// train step's ALiBi slope gradients on the card to 1.99e-3 of the CPU's at
// d = 16 (the gate is 1e-3) and to 6.0e-4 at the flagship's d = 64; one
// k-step a chain gave 1.9e-4 and 3.1e-4.
// Bias, mask, the online max, exp and the row sums stay in fp32 registers;
// exp is `__expf` (ex2.approx of x*log2(e)), as in the bf16 forward: within
// every gate, and 4-15% faster than `expf` at the paths' shapes
// (chip_probe_flash_fwd.py). No atomics, and every sum runs in a fixed
// order: two calls give the same bits.
//
// Bound on the H100: 4*d fp32 operations a valid (query, key) pair and head
// (q.k and p.v, a multiply and an add each), three TF32 tensor-core products
// each at 495 TFLOP/s (chip_smoke.py's `bound_tc_ms`: 0.0284 ms at the
// flagship's padded encoders, 0.0672 at the served batch); the bytes (q, k,
// v and o once, lse) are far below. Between the kernel and that floor: TF32
// wgmma reads shared-memory operands K-major only, and P.V sums over V's
// rows, so V has to be transposed in shared memory; both operands of S come
// from shared memory (q's tile and a key tile), and at N = 32 keys a TF32
// wgmma reads more bytes than the SM's shared memory delivers in its tensor
// time; the split pass and the softmax run on the CUDA cores between
// products; and a CTA's copies of q and o take a third of the time at the
// flagship's shapes unless other CTAs' products run beside them.
//
// Design. A CTA is G warpgroups, each owning 64 query rows, wgmma's M: two
// at d = 128 where the grid fills the SMs, else one. At d = 64 one
// warpgroup and 32-key tiles take 66 KB, so three CTAs share an SM and one's
// copies of q and o, its first tile and its splits (30-36% of the time at
// the flagship's shapes when a CTA holds an SM alone) overlap another's
// products: 0.84-0.91x the time of two warpgroups on 64-key tiles; at
// d = 128 two warpgroups sharing each key tile take 0.63-0.71x the time of
// one (chip_probe_flash_fwd.py). With one KV head the 64 rows of a
// warpgroup are the h heads x 64/h positions of one batch element (64/h
// divides 256, so no block straddles the JAX wrapper's query blocks), and a
// CTA's row blocks are consecutive positions of it, so each K/V tile serves
// every row of the CTA; otherwise 64 positions of one head. Every operand is
// an F32Tile in shared memory, swizzled as wgmma reads it, copied by TMA from
// a 3-d tensor map (rows past t land as zeros) onto an mbarrier: q once (a
// warpgroup's 64 rows in one box of positions x heads), K and V in tiles of
// kKeys keys (32, 64 at d = 16). Each warpgroup splits its q*scale once in
// place (hi where q landed, lo beside). A key tile is split once for the
// whole CTA: V, which lands where K's lo goes, is written split and
// transposed (wg::split_transpose, the columns of each 8 keys in the order
// that `wg::acc_a` gives P's), then K is split in place with its lo over V.
// S comes in the accumulator layout (a row's keys over the four lanes of a
// quad), the masked online softmax runs there, and P goes from the
// accumulator into register A fragments for P.V against V's transpose: P
// never passes through shared memory. Once every warp's S has read K's
// tiles, thread 0 copies the next tile over them, so the copy runs under
// the softmax and P.V. One tile in flight: a ring of two stages, whose
// second let the next tile's split run under P.V, took the same time on the
// H100 at every timed shape (two warpgroups, 64-key tiles) and would cost
// CTAs an SM. A tile whose pairs are all valid and below every row's key
// limit takes a path with no mask. Causal CTAs run in reverse order of their
// rows, so the CTAs with the most key tiles start first. Every branch that a
// wgmma follows is on a value that ptxas sees as warp-uniform (`uniform`),
// and every wgmma is waited for on every path: otherwise ptxas serializes
// every wgmma (its C7518).
//
// Masked tiles and rows with no valid key: a key tile whose keys are all
// masked is skipped unless the CTA holds a query row with no valid key (for
// a row with a valid key, a masked key's weight exp(-1e30 - m) is 0, or is
// wiped by the rescale exp(-1e30 - m_new) = 0 once a valid key arrives);
// with `causal`, tiles past the CTA's last row are not read. A row with no
// valid key gets the JAX wrapper's answer: that wrapper pads keys to whole
// blocks with mask 0, so the row averages v (zero past t) over the keys of
// the key blocks it visits (`masked_row_keys`): its scores are all -1e30, so
// P = 1 on every key below its key limit (`wg::key_limit`: t, or with
// `causal` the keys up to its query block's end) and 0 past it, and l is the
// count of the padded keys. Keys past t take no part, and with one KV head
// every query head reads KV head 0.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using tf32::store2;
using wg::F32Tile;
using wg::first_valid_key;
using wg::grant_smem;
using wg::key_limit;
using wg::masked_row_keys;
using wg::smem_addr;
using wg::tile_map_f32;

constexpr int kRows = 64;  // query rows of a warpgroup, M of every product
constexpr int kWG = 128;   // threads of a warpgroup
constexpr float kMaskValue = -1e30f;

// d (64 x N) = A.B over k-step ks in split TF32, three products from zero,
// A and B from shared memory (hi at a and b, lo one tile on)
template <int N, class A, class B>
__device__ __forceinline__ void split_ss(float (&d)[N / 2], uint32_t a, uint32_t b, int ks) {
  wg::tf32_ss<N>(d, A::desc_k(a + A::kBytes, ks), B::desc_k(b, ks), 0);  // lo.hi
  wg::tf32_ss<N>(d, A::desc_k(a, ks), B::desc_k(b + B::kBytes, ks), 1);  // hi.lo
  wg::tf32_ss<N>(d, A::desc_k(a, ks), B::desc_k(b, ks), 1);              // hi.hi
}

// d (64 x N) = A.B summed over kSteps k-steps in split TF32: each k-step's
// three products from zero into one of two temporaries, joined to d in order
// by a rounded fp32 add while the next k-step's run
template <int N, class A, class B, int kSteps>
__device__ __forceinline__ void split_ss_sum(float (&d)[N / 2], uint32_t a, uint32_t b) {
  float t[2][N / 2];
#pragma unroll
  for (int ks = 0; ks <= kSteps; ++ks) {
    if (ks < kSteps) {
      wg::hold(t[ks & 1]);
      wg::fence();
      split_ss<N, A, B>(t[ks & 1], a, b, ks);
      wg::commit();
    }
    if (ks > 0) {  // join k-step ks - 1, k-step ks still running
      if (ks < kSteps)
        wg::wait<1>();
      else
        wg::wait<0>();
      float(&x)[N / 2] = t[(ks - 1) & 1];
      wg::hold(x);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] = ks == 1 ? x[i] : d[i] + x[i];
    }
  }
}

// d (64 x N) = a.B over k-step kk in split TF32, three products from zero,
// a in registers (a[0] hi, a[1] lo), B from shared memory
template <int N, class B>
__device__ __forceinline__ void split_rs(float (&d)[N / 2], const uint32_t (&a)[2][4], uint32_t b, int kk) {
  wg::tf32_rs<N>(d, a[1], B::desc_k(b, kk), 0);              // lo.hi
  wg::tf32_rs<N>(d, a[0], B::desc_k(b + B::kBytes, kk), 1);  // hi.lo
  wg::tf32_rs<N>(d, a[0], B::desc_k(b, kk), 1);              // hi.hi
}

// The CTA's shared memory, from a 1024-byte aligned base: G warpgroups'
// rows of q*scale and one key tile of kKeys keys.
template <int D, int G>
struct FwdSmem {
  static constexpr int kKeys = D == 16 ? 64 : 32;
  using QT = F32Tile<kRows, D>;  // a warpgroup's rows of q*scale
  using KT = F32Tile<kKeys, D>;  // a key tile of K, and V as it lands
  using VT = F32Tile<D, kKeys>;  // V's transpose, the B of P.V
  // [group][hi, lo] of q*scale; K (split in place: hi), then K's lo, where V
  // lands; V's transpose, hi and lo
  static constexpr int kK = G * 2 * QT::kBytes, kVT = kK + 2 * KT::kBytes;
  static constexpr int kBars = kVT + 2 * VT::kBytes;  // mbarriers: q, key tile, its K tiles free
  static constexpr int kWarpFirst = kBars + 3 * 8;
  static constexpr int kBits = kWarpFirst + G * 4 * 4;  // [32-key words]
  static int bytes(int tk) { return kBits + 4 * ((tk + 31) / 32) + 1024; }  // and the alignment's slack
};

// Grid: (b when heads_per_block == h (one KV head), else b * h; CTAs of G
// row blocks). A row block is 64 (head, position) rows: heads_per_block
// heads x 64 / heads_per_block positions. tm_q takes boxes of (positions,
// heads_per_block) rows, so a warpgroup's 64 rows come in one copy.
template <int D, int G>
__global__ void __launch_bounds__(G * kWG, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ slopes,
              const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int h, int hk,
              int tq, int tk, int causal, float scale, int heads_per_block) {
  using S = FwdSmem<D, G>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  using VT = typename S::VT;
  constexpr int Kt = S::kKeys;
  constexpr int kThreads = G * kWG;
  constexpr uint64_t kAllKeys = Kt == 64 ? ~0ull : (1ull << Kt) - 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* warp_first = reinterpret_cast<int*>(smem + S::kWarpFirst);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + S::kBits);
  const uint32_t bar_q = base + S::kBars, full = bar_q + 8, k_free = bar_q + 16;
  const uint32_t kt = base + S::kK, vt = base + S::kVT;

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
  const int cta_q0 = cta * G * positions;
  const int q0 = cta_q0 + group * positions;  // this warpgroup's first position
  const int kv_slab = b * hk + (hk == 1 ? 0 : head0);
  const uint8_t* mp = mask + (size_t)b * tk;
  const size_t row_base = (size_t)b * h;
  const uint32_t qt = base + group * 2 * QT::kBytes;

  // every row block of q, and key tile 0 before the mask is read: the walk
  // over the key tiles starts there whatever the mask
  if (tid == 0) {
    wg::prefetch_map(&tm_q);
    wg::prefetch_map(&tm_k);
    wg::prefetch_map(&tm_v);
    wg::mbar_init(bar_q, 1);
    wg::mbar_init(full, 1);
    wg::mbar_init(k_free, kThreads / 32);  // every warp releases a tile's K
    wg::mbar_init_fence();
    wg::mbar_expect_tx(bar_q, G * QT::kBytes);
    for (int gr = 0; gr < G; ++gr)
      wg::tma_tile_f32<QT, D>(base + gr * 2 * QT::kBytes, &tm_q, cta_q0 + gr * positions, b * h + head0, bar_q);
    wg::mbar_expect_tx(full, 2 * KT::kBytes);
    wg::tma_tile_f32<KT, D>(kt, &tm_k, 0, kv_slab, full);
    wg::tma_tile_f32<KT, D>(kt + KT::kBytes, &tm_v, 0, kv_slab, full);
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
  const int all_tiles = (tk + Kt - 1) / Kt;
  const int first_valid = uniform(first_valid_key(mp, tk, bits, warp_first));  // and the barriers' initialization
  // the tiles the CTA reads: each row block's, with `causal` up to its last
  // row's, or up to that row's JAX key limit when a row of it has no valid
  // key
  auto tiles_end = [&](int first_pos) {
    const int last_pos = max(0, min(tq, first_pos + positions) - 1);
    if (!causal) return all_tiles;
    int e = min(all_tiles, last_pos / Kt + 1);
    if (first_valid > first_pos) e = max(e, (key_limit(last_pos, tq, tk, 1) + Kt - 1) / Kt);
    return e;
  };
  const bool cta_empty_row = first_valid >= tk || (causal && first_valid > cta_q0);
  const bool empty_row = first_valid >= tk || (causal && first_valid > q0);
  int end = 0;
  for (int gr = 0; gr < G; ++gr) end = max(end, tiles_end(cta_q0 + gr * positions));
  auto word = [&](int i) { return i < words ? bits[i] : 0u; };
  // bit jj: key tile*Kt + jj is valid
  auto tile_bits = [&](int tile) -> uint64_t {
    if constexpr (Kt == 64) return (uint64_t)word(2 * tile) | (uint64_t)word(2 * tile + 1) << 32;
    else return word(tile);
  };
  auto next_tile = [&](int tile) {
    while (tile < end && !cta_empty_row && tile_bits(tile) == 0) ++tile;
    return tile;
  };
  // the key tile's K over K's tile and its V over K's lo (thread 0)
  auto issue = [&](int tile) {
    wg::mbar_expect_tx(full, 2 * KT::kBytes);
    wg::tma_tile_f32<KT, D>(kt, &tm_k, tile * Kt, kv_slab, full);
    wg::tma_tile_f32<KT, D>(kt + KT::kBytes, &tm_v, tile * Kt, kv_slab, full);
  };
  // the j-th tile the CTA walks, once landed, split for the whole CTA by
  // thread `me`: V's transpose first, then K in place with its lo over V
  auto split_key_tile = [&](int j, int me) {
    wg::mbar_wait(full, j & 1);
    wg::split_transpose<KT, VT, kThreads, false>(smem + S::kK + KT::kBytes, nullptr, smem + S::kVT,
                                                 smem + S::kVT + VT::kBytes, 1.f, me);
    __syncthreads();  // V is read: K's lo may go over it
    wg::split_tile<KT, kThreads>(smem + S::kK, smem + S::kK + KT::kBytes, 1.f, me);
    wg::fence_proxy_async();
  };

  float acc[D / 2];  // o, unnormalized
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  // full tiles below every row need no mask
  const bool rows_plain = !empty_row && q0 + positions <= tq;
  // this warpgroup's rows of q*scale, split once
  wg::mbar_wait(bar_q, 0);
  uint8_t* qs = smem + (qt - base);
  wg::split_tile<QT, kWG>(qs, qs + QT::kBytes, scale, wtid);
  split_key_tile(0, tid);
  __syncthreads();

  int tile = 0;  // end >= 1: every CTA has a key tile to walk
  for (int j = 0; tile < end; ++j) {
    const int nxt = uniform(next_tile(tile + 1));
    const int k0 = tile * Kt;
    // the tiles' addresses and this thread's index, opaque to the compiler
    // within an iteration: otherwise it keeps every k-step's descriptors and
    // the split passes' offsets in registers across the loop (and spilled
    // at d = 128)
    uint32_t q_at = qt, k_at = kt, v_at = vt;
    int me = tid;
    asm volatile("" : "+r"(q_at), "+r"(k_at), "+r"(v_at), "+r"(me));

    // S = (q*scale).K^T
    float s[Kt / 2];
    split_ss_sum<Kt, QT, KT, D / 8>(s, q_at, k_at);
    // the next key tile over K's tiles, once every warp has read them
    // (thread 0)
    if (lane == 0) wg::mbar_arrive(k_free);
    if (tid == 0 && nxt < end) {
      wg::mbar_wait(k_free, j & 1);
      issue(nxt);
    }

    // the scores in place of S: element e is row g + 8*((e>>1)&1) of warp
    // w, key k0 + 8*(e>>2) + 2*t4 + (e&1); kd[i] + c is the key of column
    // offset c = 8*(e>>2) + (e&1) less row i's position
    const float kd[2] = {(float)(k0 + 2 * t4 - row_pos[0]), (float)(k0 + 2 * t4 - row_pos[1])};
    const uint64_t valid_keys = tile_bits(tile);
    const bool plain = uniform(rows_plain && valid_keys == kAllKeys && (!causal || k0 + Kt - 1 <= q0));
    float mx[2] = {m[0], m[1]};
    if (plain) {
      // every (row, key) pair of the tile is valid and below every row's
      // key limit: no mask
#pragma unroll
      for (int e = 0; e < Kt / 2; ++e) {
        const int i = (e >> 1) & 1;
        s[e] -= row_slope[i] * fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        mx[i] = fmaxf(mx[i], s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < Kt / 2; ++e) {
        const int i = (e >> 1) & 1;
        const int jj = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const bool valid = ((valid_keys >> jj) & 1u) != 0;
        const float x = s[e] - row_slope[i] * fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
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
      for (int e = 0; e < Kt / 2; ++e) {
        s[e] = __expf(s[e] - m[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += s[e];
      }
    } else {
      // a key at or past a row's key limit (past t, or past a causal row's
      // JAX key blocks) takes no part
#pragma unroll
      for (int e = 0; e < Kt / 2; ++e) {
        const int i = (e >> 1) & 1;
        const int kj = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        s[e] = kj < row_limit[i] ? __expf(s[e] - m[i]) : 0.f;
        sum[i] += s[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

    // the tile's P.V, A from the accumulator, B V's transpose: each k-step
    // (8 keys) from zero into one of two temporaries, joined to o in order
    // by a rounded fp32 add while the next k-step's run; o is rescaled while
    // the first does
    constexpr int kSteps = Kt / 8;
    uint32_t a[kSteps][2][4];
    wg::acc_a<kSteps>(s, a);
    float t[2][D / 2];
    wg::hold(a);
#pragma unroll
    for (int kk = 0; kk <= kSteps; ++kk) {
      if (kk < kSteps) {
        wg::hold(t[kk & 1]);
        wg::fence();
        split_rs<D, VT>(t[kk & 1], a[kk], v_at, kk);
        wg::commit();
      }
      if (kk == 0) {
        // element 4j + 2i + c of acc: row g + 8i of warp w, column 8j + 2t4 + c
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
      } else {  // join k-step kk - 1, k-step kk still running
        if (kk < kSteps)
          wg::wait<1>();
        else
          wg::wait<0>();
        float(&x)[D / 2] = t[(kk - 1) & 1];
        wg::hold(x);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] += x[e];
      }
    }
    wg::hold(a);
    if (nxt < end) {
      __syncthreads();  // every warp is done with this tile's V^T
      split_key_tile(j + 1, me);
    }
    __syncthreads();  // the next tile is split for every warp
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
    float* op = out + row * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, acc[4 * j + 2 * i] / lc, acc[4 * j + 2 * i + 1] / lc);
    if (lse != nullptr && t4 == 0) lse[row] = m[i] + logf(lc);
  }
}

template <int D, int G>
int launch_groups(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v, const float* slopes,
                  const uint8_t* mask, float* out, float* lse, dim3 grid, int h, int hk, int tq, int tk, int causal,
                  float scale, int heads_per_block, cudaStream_t stream) {
  static const int granted = grant_smem(flash_fwd<D, G>);
  const int smem = FwdSmem<D, G>::bytes(tk);
  if (smem > granted) return (int)cudaErrorInvalidValue;
  flash_fwd<D, G><<<grid, G * kWG, smem, stream>>>(tm_q, tm_k, tm_v, slopes, mask, out, lse, h, hk, tq, tk, causal,
                                                  scale, heads_per_block);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask, float* out,
           float* lse, int b, int h, int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  const bool mqa = hk == 1 && h > 1 && kRows % h == 0;
  const int heads_per_block = mqa ? h : 1;
  const int positions = kRows / heads_per_block;
  const int row_blocks = (tq + positions - 1) / positions;
  const int slabs = mqa ? b : b * h;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // at d = 128 two warpgroups a CTA share each key tile, unless that leaves
  // SMs idle; elsewhere one, so that several CTAs an SM overlap one's copies
  // and splits with another's products
  const int groups = D == 128 && (row_blocks + 1) / 2 * slabs >= sms ? 2 : 1;
  constexpr int Kt = FwdSmem<D, 1>::kKeys;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!(tile_map_f32<D>(&tm_q, q, tq, b * h, positions, heads_per_block) &&
        tile_map_f32<D>(&tm_k, k, tk, b * hk, Kt, 1) && tile_map_f32<D>(&tm_v, v, tk, b * hk, Kt, 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, (row_blocks + groups - 1) / groups);
  if constexpr (D == 128)
    if (groups == 2)
      return launch_groups<D, 2>(tm_q, tm_k, tm_v, slopes, mask, out, lse, grid, h, hk, tq, tk, causal, scale,
                                 heads_per_block, stream);
  return launch_groups<D, 1>(tm_q, tm_k, tm_v, slopes, mask, out, lse, grid, h, hk, tq, tk, causal, scale,
                             heads_per_block, stream);
}

int dispatch(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask, float* out,
             float* lse, int b, int h, int hk, int tq, int tk, int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk != 1 && hk != h) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch<D>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
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

// q: (b, h, tq, d); k, v: (b, hk, tk, d) with hk in {1, h}; slopes: (h,);
// mask: (b, tk) bytes, nonzero = valid key; out: (b, h, tq, d); lse: (b, h, tq)
// or null. All fp32, contiguous and 16-byte aligned. Returns the CUDA error
// code of the launch.
extern "C" int sp_flash_attention_fwd(const float* q, const float* k, const float* v,
                                      const float* slopes, const uint8_t* mask, float* out,
                                      float* lse, int b, int h, int hk, int tq, int tk, int d,
                                      int causal, float scale, void* stream) {
  return dispatch(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, d, causal, scale, stream);
}

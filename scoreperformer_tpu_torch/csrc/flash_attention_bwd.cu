// Flash-attention backward with ALiBi generated in the kernel, fp32 in and
// out, on Hopper's warpgroup MMA (`wgmma`) in split TF32: dK/dV and
// dQ/dslope, P recomputed from the forward's logsumexp, every sum
// fp32-accurate. The bf16 instances are csrc/flash_attention_bwd_bf16.cu's.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (:135) and ::_flash_bwd_dq_kernel (:192), the two Pallas kernels that
// `_flash_attention_bwd` launches (`pl.pallas_call` at :397 and :423) inside
// the `jax.custom_vjp` of `flash_attention_alibi`.
//
// The math, per (batch, head), with s = (q*scale).k - slope*|i-j| masked to
// -1e30 and P = exp(s - lse):
//   dP = dO.V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (computed
//   outside, as the JAX code does);
//   dV = P^T.dO,  dK = dS^T.(q*scale),  dQ = scale * dS.K,
//   dslope = sum dS * (-|i-j|), with the part of the keys the JAX wrapper
//   pads past t (wg::padded_keys_dslope).
//
// Numerics: those of the Pallas kernels at "highest". Every product is
// three TF32 `wgmma` products, hi.hi + hi.lo + lo.hi, with x = hi + lo, hi =
// tf32(x) and lo = tf32(x - hi) rounded to nearest (wgmma.cuh's `tf32::split`):
// S^T, dP^T, dV and dK in dK/dV, S, dP and dQ in dQ/dslope. The tensor cores
// truncate the fp32 sums they accumulate (a long chain in one accumulator
// drifts toward zero), so each product's chain starts from zero on a tile of
// at most 64 of its summed dimension and the tiles join the running sums by
// rounded fp32 adds: S and dP, whose errors P and dS = P * (dP - delta) turn
// into the slope gradient's, take one k-step (8 of d, three wgmmas) a tile
// (split_ss_sum); dV and dK an item's queries, dQ a key tile. Bias, mask,
// exp, dS and the slope sum stay in fp32 registers. No atomics, and every
// sum runs in a fixed order: two calls give the same bits.
//
// Bound on the H100. dK/dV takes four d-long products a (query, key) pair
// and head (8*d operations), dQ/dslope three (6*d); in split TF32 each is
// three tensor-core products, so at 495 TFLOP/s the floor is 3 x operations
// (chip_smoke.py's `bound_tc_ms`: 0.050 + 0.038 ms at the flagship's
// padded encoders, 0.26 + 0.20 ms at d = 128, t 1026). The bytes (q, k, v,
// dO, lse and delta read once, dK, dV, dQ written once) are tens of MB: the
// operations bound both kernels. Three things stand between them and that
// floor, and the design answers each:
// - TF32 wgmma reads shared-memory operands K-major only (bf16's transpose
//   bit does not exist for TF32), while dV = P^T.dO, dK = dS^T.q and
//   dQ = dS.K sum over the rows of dO, q and K. Those three are written,
//   split, in a transposed copy (wg::F32Tile, wg::split_transpose) by the pass
//   that splits a landed tile anyway, and P^T, dS^T and dS go from the
//   accumulator straight into register A fragments, a k-step's 8 columns in
//   the order 0, 2, 4, 6, 1, 3, 5, 7 (wg::acc_a) with the transposed copy's
//   columns in the same order: P and dS never pass through shared memory
//   as B.
// - Split operands double a tile's bytes and the transposed copies double
//   them again: at d = 128 K's and V's hi and lo alone take 128 KB, so a
//   dK/dV item there has 16 queries, not 64 (DkvSmem), and dQ streams keys
//   in tiles of 32 beside one warpgroup's rows (64 keys beside two
//   warpgroups' rows, sharing each key tile, at d <= 64).
// - Both operands of S^T, dP^T, S and dP come from shared memory: at N = 64
//   a TF32 wgmma reads as many bytes as the SM's shared memory delivers in
//   its tensor time, and at N = 16 or 32 more, so those products are bound
//   by shared-memory bandwidth, not the tensor cores.
//
// Design. Every operand is an F32Tile in shared memory, swizzled as wgmma
// reads it, copied by TMA from a 3-d tensor map (rows past t land as zeros)
// onto an mbarrier, then split in place (hi where x was, lo beside, and the
// transposed hi and lo where a product needs them) by every thread, and made
// visible to wgmma (fence.proxy.async). Once a tile's S-side products have
// read its natural hi and lo, thread 0 copies the next tile over them (an
// mbarrier that every warp arrives on), so the copy runs under the dV/dK or
// dQ products; the split of the next tile waits for those.
// - dK/dV (grid: 64-key blocks x b x KV heads; 256 threads): the block's K
//   and V tiles stay; its (head, query tile) items are every query head that
//   reads its KV head (all h with one KV head, so the MQA head sum stays in
//   the block) times the query tiles, and q*scale and dO stream. Warpgroup 0
//   computes S^T = K.(q*scale)^T, P^T, hands P^T to warpgroup 1 through
//   shared memory (a named barrier) and takes dV += P^T.dO; warpgroup 1
//   computes dP^T = V.dO^T, dS^T = P^T * (dP^T - delta) and dK +=
//   dS^T.(q*scale). With one KV head and too few blocks to give every SM
//   four, a cluster of 2, 4 or 8 CTAs shares a block's keys and splits its
//   query heads; the CTAs' sums join in rank order through distributed
//   shared memory, as in the bf16 kernel.
// - dQ/dslope (grid: 64-row blocks x b, or x b*h; one or two per CTA, a
//   warpgroup each): with one KV head the 64 rows are the h heads x 64/h
//   positions of one batch element, so each K/V tile is read once for all
//   heads; otherwise 64 positions of one head. q*scale and dO stay; K and V
//   stream. S = (q*scale).K^T and dP = dO.V^T, dS in registers, dQ += dS.K
//   from K's transposed copy. The slope gradient accumulates per row in
//   registers, with the padded keys' part; each block sums its rows in a
//   fixed order into one part per head it holds, in a (b, h, blocks) tensor
//   that the caller sums (ops/flash_attention.py::dq_slope_parts).
//
// Masked tiles and rows with no valid key, as in the bf16 kernels. dQ skips
// a key tile whose keys are all masked unless the CTA holds a row with no
// valid key: for a row with a valid key, a masked key's P = exp(-1e30 - lse)
// is exactly 0, so is its dS. A dK/dV block whose 64 keys are all masked
// writes zeros and returns where every query row of its element has a valid
// key; with `causal`, a query tile that ends before the block's first key is
// skipped unless it holds a row with no valid key that reaches those keys.
// Rows with no valid key (lse = -1e30) put P = 1 on every key the JAX kernels
// visit for them, the keys below `jax_masked_row_keys` (key_limit): each
// (row, key) element takes that limit, so P does not depend on which tiles a
// block visits; the tile bounds only have to reach it. Keys and query rows
// past t take no part.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using wg::cluster_sync;
using wg::F32Tile;
using wg::first_valid_key;
using wg::grant_smem;
using wg::jax_masked_row_keys;
using wg::key_limit;
using wg::ld_cluster;
using wg::padded_keys_dslope;
using wg::smem_addr;
using wg::tile_map_f32;
using tf32::store2;

constexpr int kRows = 64;  // keys of a dK/dV block, rows of a dQ warpgroup, M of every product
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

// d[p] (64 x N) = A_p.B_p summed over kSteps k-steps in split TF32, for
// kProducts products (A_p at a[p], B_p at b[p]): each k-step's three
// products from zero into one of two temporaries, joined to d[p] by a
// rounded fp32 add while the next k-step's run, the products' k-steps in
// turn. The sums over d meet a model's logits, where a chain of truncating
// tensor-core adds biases S and dP enough to move the slope gradient.
template <int N, class A, class B, int kSteps, int kProducts>
__device__ __forceinline__ void split_ss_sum(float (&d)[kProducts][N / 2], const uint32_t (&a)[kProducts],
                                             const uint32_t (&b)[kProducts]) {
  constexpr int G = kSteps * kProducts;
  float t[2][N / 2];
#pragma unroll
  for (int g = 0; g <= G; ++g) {
    if (g < G) {
      wg::hold(t[g & 1]);
      wg::fence();
      split_ss<N, A, B>(t[g & 1], a[g % kProducts], b[g % kProducts], g / kProducts);
      wg::commit();
    }
    if (g > 0) {  // join group g - 1, group g still running
      if (g < G)
        wg::wait<1>();
      else
        wg::wait<0>();
      float(&x)[N / 2] = t[(g - 1) & 1];
      float(&y)[N / 2] = d[(g - 1) % kProducts];
      wg::hold(x);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) y[i] = g - 1 < kProducts ? x[i] : y[i] + x[i];
    }
  }
}

// d (64 x N) += a.B over k-step kk in split TF32, a in registers (a[0] hi,
// a[1] lo), B from shared memory; from zero when `first`
template <int N, class B>
__device__ __forceinline__ void split_rs(float (&d)[N / 2], const uint32_t (&a)[2][4], uint32_t b, int kk,
                                         bool first) {
  wg::tf32_rs<N>(d, a[1], B::desc_k(b, kk), !first);         // lo.hi
  wg::tf32_rs<N>(d, a[0], B::desc_k(b + B::kBytes, kk), 1);  // hi.lo
  wg::tf32_rs<N>(d, a[0], B::desc_k(b, kk), 1);              // hi.hi
}

// the query column (0 to Q/4 - 1 of a thread's own) of dK/dV accumulator
// element e: query 8*(e>>2) + 2*t4 + (e&1)
__host__ __device__ constexpr int column(int e) { return ((e >> 2) << 1) | (e & 1); }

// The block's shared memory, from a 1024-byte aligned base. An item has Q
// query rows: 64, or 16 at d = 128, where K's and V's hi and lo take 128 KB.
template <int D>
struct DkvSmem {
  static constexpr int Q = D == 128 ? 16 : 64;
  using KT = F32Tile<kRows, D>;  // K and V: the block's keys
  using QT = F32Tile<Q, D>;      // q*scale and dO: an item's queries
  using TT = F32Tile<D, Q>;      // their transposes, the B of dK and dV
  // each operand's hi, then its lo
  static constexpr int kK = 0, kV = 2 * KT::kBytes;
  static constexpr int kQ = 4 * KT::kBytes, kO = kQ + 2 * QT::kBytes;
  static constexpr int kQT = kO + 2 * QT::kBytes, kOT = kQT + 2 * TT::kBytes;
  static constexpr int kX = kOT + 2 * TT::kBytes;  // P^T handed over: [element][thread of the warpgroup] fp32
  static constexpr int kBars = kX + kRows * Q * 4;  // mbarriers: K and V, the item's tiles, their natural tiles free
  static constexpr int kWarpFirst = kBars + 3 * 8;
  static constexpr int kBytes = kWarpFirst + 8 * 4 + 1024;  // and the alignment's slack
};

template <int D>
__global__ void __launch_bounds__(2 * kWG, 1)
    flash_bwd_dkv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                  const float* __restrict__ slopes, const uint8_t* __restrict__ mask,
                  const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int h, int hk, int tq, int tk, int causal, float scale) {
  using S = DkvSmem<D>;
  using KT = typename S::KT;
  using QT = typename S::QT;
  using TT = typename S::TT;
  constexpr int Q = S::Q;
  constexpr int kThreads = 2 * kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* warp_first = reinterpret_cast<int*>(smem + S::kWarpFirst);
  const uint32_t bar_kv = base + S::kBars, full = bar_kv + 8, nat_free = bar_kv + 16;

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
  const int n_q_tiles = (tq + Q - 1) / Q;
  // with `causal`, a query tile that ends before k0 reaches these keys only
  // through rows with no valid key (those before first_valid)
  auto visits = [&](int tile) {
    if (!causal) return true;
    const int q0 = tile * Q;
    const int q_last = min(q0 + Q, tq) - 1;
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
  // the item's q and dO tiles over their natural hi (thread 0)
  auto issue = [&](Item item) {
    const int slab = b * h + head_begin + item.head;
    wg::mbar_expect_tx(full, 2 * QT::kBytes);
    wg::tma_tile_f32<QT, D>(base + S::kQ, &tm_q, item.tile * Q, slab, full);
    wg::tma_tile_f32<QT, D>(base + S::kO, &tm_o, item.tile * Q, slab, full);
  };

  Item item = next_item(Item{0, 0});
  if (tid == 0) {
    wg::mbar_init(bar_kv, 1);
    wg::mbar_init(full, 1);
    wg::mbar_init(nat_free, kThreads / 32);  // every warp releases an item's natural tiles
    wg::mbar_init_fence();
    wg::mbar_expect_tx(bar_kv, 2 * KT::kBytes);
    wg::tma_tile_f32<KT, D>(base + S::kK, &tm_k, k0, bkv, bar_kv);
    wg::tma_tile_f32<KT, D>(base + S::kV, &tm_v, k0, bkv, bar_kv);
    if (item.head < n_heads) issue(item);
  }
  __syncthreads();  // the barriers are initialized

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + w * 16 + g + 8 * i;
    key_ok[i] = key[i] < tk && mp[key[i]] != 0;
  }
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // the block's keys, split once
  wg::mbar_wait(bar_kv, 0);
  wg::split_tile<KT, kThreads>(smem + S::kK, smem + S::kK + KT::kBytes, 1.f, tid);
  wg::split_tile<KT, kThreads>(smem + S::kV, smem + S::kV + KT::kBytes, 1.f, tid);

  for (int j = 0; item.head < n_heads; ++j) {
    const Item nxt = after(item);
    const int head = head_begin + item.head;
    const int q0 = item.tile * Q;
    // lse (warpgroup 0) or delta (warpgroup 1) of this thread's Q/4 query
    // columns, 8*(c>>1) + 2*t4 + (c&1)
    float row_v[Q / 4];
    {
      const float* src = (role == 0 ? lse : delta) + ((size_t)b * h + head) * tq + q0;
#pragma unroll
      for (int c = 0; c < Q / 4; ++c) {
        const int jq = 8 * (c >> 1) + 2 * t4 + (c & 1);
        row_v[c] = q0 + jq < tq ? src[jq] : 0.f;
      }
    }
    __syncthreads();  // every warp is done with the last item's transposed tiles
    wg::mbar_wait(full, j & 1);
    wg::split_transpose<QT, TT, kThreads>(smem + S::kQ, smem + S::kQ + QT::kBytes, smem + S::kQT,
                                          smem + S::kQT + TT::kBytes, scale, tid);
    wg::split_transpose<QT, TT, kThreads>(smem + S::kO, smem + S::kO + QT::kBytes, smem + S::kOT,
                                          smem + S::kOT + TT::kBytes, 1.f, tid);
    wg::fence_proxy_async();
    __syncthreads();

    // S^T = K.(q*scale)^T (warpgroup 0) or dP^T = V.dO^T (warpgroup 1):
    // rows are the block's keys, columns the item's queries
    float x[1][Q / 2];  // S^T, then P^T (warpgroup 0); dP^T, then dS^T (warpgroup 1)
    {
      const uint32_t a[1] = {base + (role == 0 ? S::kK : S::kV)};
      const uint32_t bt[1] = {base + (role == 0 ? S::kQ : S::kO)};
      split_ss_sum<Q, KT, QT, D / 8, 1>(x, a, bt);
    }
    // the next item over the natural tiles, once every warp has read them
    // (thread 0)
    if (lane == 0) wg::mbar_arrive(nat_free);
    if (tid == 0 && nxt.head < n_heads) {
      wg::mbar_wait(nat_free, j & 1);
      issue(nxt);
    }

    // element e of x: key row g + 8*((e>>1)&1) of warp w, query 8*(e>>2) +
    // 2*t4 + (e&1) (row_v[column(e)]); kq[i] - c is key row i's distance to
    // the query of column offset c = 8*(e>>2) + (e&1)
    float* xchg = reinterpret_cast<float*>(smem + S::kX);
    if (role == 0) {
      const float slope = slopes[head];
      const float kq[2] = {(float)(key[0] - q0 - 2 * t4), (float)(key[1] - q0 - 2 * t4)};
      if (all_valid && q0 + Q <= tq && (!causal || q0 >= k0 + kRows - 1)) {
        // every (key, query) pair of the item is valid and below every
        // row's key limit: no mask
#pragma unroll
        for (int e = 0; e < Q / 2; ++e) {
          const int c = 8 * (e >> 2) + (e & 1);
          x[0][e] = expf(x[0][e] - slope * fabsf(kq[(e >> 1) & 1] - (float)c) - row_v[column(e)]);
        }
      } else if (every_row_valid) {
        // a key past a row's limit lies past its diagonal: the mask zeroes
        // P there; rows past t get P = 0
#pragma unroll
        for (int e = 0; e < Q / 2; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + (e & 1);
          const int qi = q0 + c + 2 * t4;
          float s = x[0][e] - slope * fabsf(kq[i] - (float)c);
          s = (key_ok[i] && (!causal || key[i] <= qi)) ? s : kMaskValue;
          const float p = expf(s - row_v[column(e)]);
          x[0][e] = qi < tq ? p : 0.f;
        }
      } else {
        // rows with no valid key: P = 1 up to their key limit
#pragma unroll
        for (int e = 0; e < Q / 2; ++e) {
          const int i = (e >> 1) & 1;
          const int c = 8 * (e >> 2) + (e & 1);
          const int qi = q0 + c + 2 * t4;
          float s = x[0][e] - slope * fabsf(kq[i] - (float)c);
          s = (key_ok[i] && (!causal || key[i] <= qi)) ? s : kMaskValue;
          const float p = expf(s - row_v[column(e)]);
          x[0][e] = key[i] < key_limit(qi, tq, tk, causal) ? p : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < Q / 2; ++e) xchg[e * kWG + wtid] = x[0][e];
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
#pragma unroll
      for (int e = 0; e < Q / 2; ++e) x[0][e] = xchg[e * kWG + wtid] * (x[0][e] - row_v[column(e)]);
    }

    // dV += P^T.dO (warpgroup 0) or dK += dS^T.(q*scale) (warpgroup 1): A
    // from the accumulator, B the transposed tile, the item's products from
    // zero
    {
      uint32_t a[Q / 8][2][4];
      wg::acc_a<Q / 8>(x[0], a);
      const uint32_t bt = base + (role == 0 ? S::kOT : S::kQT);
      float tile_sum[D / 2];
      wg::hold(a);
      wg::hold(tile_sum);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < Q / 8; ++kk) split_rs<D, TT>(tile_sum, a[kk], bt, kk, kk == 0);
      wg::commit();
      wg::wait_all();
      wg::hold(tile_sum);
      wg::hold(a);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += tile_sum[i];
    }
    item = nxt;
  }

  // element 4j + 2i + c of acc: key row g + 8i of warp w, column 8j + 2t4 + c
  float* out = role == 0 ? dv : dk;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= tk) continue;
      float* op = out + ((size_t)bkv * tk + key[i]) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    return;
  }
  // the cluster's sums join in rank order through distributed shared
  // memory: each CTA puts its sums in K's and V's space ([role][element]
  // [thread]), then writes every gridDim.z-th pair of each thread's
  // elements, summed over the CTAs 0, 1, ...
  __syncthreads();  // every warp is done with the tiles
  float* part = reinterpret_cast<float*>(smem + S::kK);
  static_assert(2 * (D / 2) * kWG * 4 <= 4 * KT::kBytes, "no room");
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
    if (key[i] < tk) store2(out + ((size_t)bkv * tk + key[i]) * D + 8 * j + 2 * t4, x, y);
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory
}

// The CTA's shared memory, from a 1024-byte aligned base: kGroups
// warpgroups of 64 rows each (two share each key tile where both fit), and
// key tiles of kKeys.
template <int D>
struct DqSmem {
  static constexpr int kKeys = D == 128 ? 32 : 64;
  static constexpr int kGroups = D == 128 ? 1 : 2;
  using RT = F32Tile<kRows, D>;   // a warpgroup's rows of q*scale and dO
  using ST = F32Tile<kKeys, D>;   // a key tile of K and V
  using TT = F32Tile<D, kKeys>;   // K's transpose, the B of dQ
  // [group][q*scale hi, lo, dO hi, lo], then each streamed operand's hi and lo
  static constexpr int kK = kGroups * 4 * RT::kBytes, kV = kK + 2 * ST::kBytes, kKT = kV + 2 * ST::kBytes;
  static constexpr int kSlopeRows = kK;  // [group][64 rows][4 lanes] fp32, over the key tiles once they are done
  static_assert(kGroups * kRows * 4 * 4 <= 4 * ST::kBytes, "no room");
  static constexpr int kBars = kKT + 2 * TT::kBytes;  // mbarriers: rows, key tile, its natural tiles free
  static constexpr int kWarpFirst = kBars + 3 * 8;
  static constexpr int kBits = kWarpFirst + kGroups * 4 * 4;  // [32-key words]
  static int bytes(int tk) { return kBits + 4 * ((tk + 31) / 32) + 1024; }  // and the alignment's slack
};

// Grid: (CTAs of kGroups blocks of 64 / heads_per_block positions, b) when
// heads_per_block == h (one KV head), else (CTAs of kGroups blocks of 64
// positions, b * h). tm_q and tm_o take boxes of (positions,
// heads_per_block) rows, so a block's 64 rows come in one copy of each.
template <int D>
__global__ void __launch_bounds__(DqSmem<D>::kGroups * kWG, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const float* __restrict__ slopes, const uint8_t* __restrict__ mask,
                 const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ dslope_part, int h, int hk, int tq, int tk, int causal, float scale,
                 int heads_per_block) {
  using S = DqSmem<D>;
  using RT = typename S::RT;
  using ST = typename S::ST;
  using TT = typename S::TT;
  constexpr int Kt = S::kKeys;
  constexpr int kThreads = S::kGroups * kWG;
  constexpr uint64_t kAllKeys = Kt == 64 ? ~0ull : (1ull << Kt) - 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* slope_rows = reinterpret_cast<float*>(smem + S::kSlopeRows);
  int* warp_first = reinterpret_cast<int*>(smem + S::kWarpFirst);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + S::kBits);
  const uint32_t bar_rows = base + S::kBars, full = bar_rows + 8, nat_free = bar_rows + 16;

  const int tid = threadIdx.x;
  const int grp = tid / kWG;  // this warpgroup's block of the CTA
  const int wtid = tid % kWG;
  const int w = wtid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int positions = kRows / heads_per_block;
  const int blocks = (tq + positions - 1) / positions;
  const int b = heads_per_block == 1 ? blockIdx.y / h : blockIdx.y;
  const int head0 = heads_per_block == 1 ? blockIdx.y % h : 0;
  const int cta_q0 = blockIdx.x * S::kGroups * positions;
  const int q0 = cta_q0 + grp * positions;  // may lie past t in the last CTA
  const int kv_slab = b * hk + (hk == 1 ? 0 : head0);
  const uint8_t* mp = mask + (size_t)b * tk;
  const size_t row_base = (size_t)b * h;
  const uint32_t rows_tile = base + grp * 4 * RT::kBytes;  // q*scale hi, lo, dO hi, lo

  // the CTA's rows of q and dO, and key tile 0 before the mask is read: the
  // walk over the key tiles starts there whatever the mask (a tile whose
  // keys are all masked gives P = 0 on every row with a valid key)
  if (tid == 0) {
    wg::mbar_init(bar_rows, 1);
    wg::mbar_init(full, 1);
    wg::mbar_init(nat_free, kThreads / 32);  // every warp releases a tile's natural tiles
    wg::mbar_init_fence();
    wg::mbar_expect_tx(bar_rows, S::kGroups * 2 * RT::kBytes);
    for (int gg = 0; gg < S::kGroups; ++gg) {
      const uint32_t rt = base + gg * 4 * RT::kBytes;
      wg::tma_tile_f32<RT, D>(rt, &tm_q, cta_q0 + gg * positions, b * h + head0, bar_rows);
      wg::tma_tile_f32<RT, D>(rt + 2 * RT::kBytes, &tm_o, cta_q0 + gg * positions, b * h + head0, bar_rows);
    }
    wg::mbar_expect_tx(full, 2 * ST::kBytes);
    wg::tma_tile_f32<ST, D>(base + S::kK, &tm_k, 0, kv_slab, full);
    wg::tma_tile_f32<ST, D>(base + S::kV, &tm_v, 0, kv_slab, full);
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
  const int all_tiles = (tk + Kt - 1) / Kt;
  const int first_valid = first_valid_key(mp, tk, bits, warp_first);  // and the barriers' initialization
  // a row of this CTA has no valid key: its first row's, if any
  const bool has_empty_row = first_valid >= tk || (causal && first_valid > cta_q0);
  const int last_pos = min(tq, cta_q0 + S::kGroups * positions) - 1;
  int end = causal ? min(all_tiles, last_pos / Kt + 1) : all_tiles;
  if (causal && has_empty_row) end = max(end, (jax_masked_row_keys(last_pos, tq, tk) + Kt - 1) / Kt);
  auto word = [&](int i) { return i < words ? bits[i] : 0u; };
  // bit jj: key tile*Kt + jj is valid
  auto tile_bits = [&](int tile) -> uint64_t {
    if constexpr (Kt == 64) return (uint64_t)word(2 * tile) | (uint64_t)word(2 * tile + 1) << 32;
    else if constexpr (Kt == 32) return word(tile);
    else return (word(tile / 2) >> (16 * (tile & 1))) & kAllKeys;
  };
  auto next_tile = [&](int tile) {
    while (tile < end && !has_empty_row && tile_bits(tile) == 0) ++tile;
    return tile;
  };
  // the key tile's K and V over their natural hi (thread 0)
  auto issue = [&](int tile) {
    wg::mbar_expect_tx(full, 2 * ST::kBytes);
    wg::tma_tile_f32<ST, D>(base + S::kK, &tm_k, tile * Kt, kv_slab, full);
    wg::tma_tile_f32<ST, D>(base + S::kV, &tm_v, tile * Kt, kv_slab, full);
  };

  float acc[D / 2];  // dQ / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float dslope[2] = {0.f, 0.f};
  // full tiles below every row need no mask
  const bool rows_plain = !has_empty_row && min(tq, q0 + positions) == q0 + positions;
  // this warpgroup's rows, split once
  wg::mbar_wait(bar_rows, 0);
  uint8_t* rows = smem + (rows_tile - base);
  wg::split_tile<RT, kWG>(rows, rows + RT::kBytes, scale, wtid);
  wg::split_tile<RT, kWG>(rows + 2 * RT::kBytes, rows + 3 * RT::kBytes, 1.f, wtid);

  int tile = 0;  // end >= 1: every CTA has a key tile to walk
  for (int j = 0; tile < end; ++j) {
    const int nxt = next_tile(tile + 1);
    const int k0 = tile * Kt;
    __syncthreads();  // every warp is done with the last tile's transposed K
    wg::mbar_wait(full, j & 1);
    wg::split_transpose<ST, TT, kThreads>(smem + S::kK, smem + S::kK + ST::kBytes, smem + S::kKT,
                                          smem + S::kKT + TT::kBytes, 1.f, tid);
    wg::split_tile<ST, kThreads>(smem + S::kV, smem + S::kV + ST::kBytes, 1.f, tid);
    wg::fence_proxy_async();
    __syncthreads();

    // S = (q*scale).K^T (sd[0]) and dP = dO.V^T (sd[1])
    float sd[2][Kt / 2];
    {
      const uint32_t a[2] = {rows_tile, rows_tile + 2 * RT::kBytes};
      const uint32_t bt[2] = {base + S::kK, base + S::kV};
      split_ss_sum<Kt, RT, ST, D / 8, 2>(sd, a, bt);
    }
    float(&s)[Kt / 2] = sd[0];
    float(&dp)[Kt / 2] = sd[1];
    // the next key tile over the natural tiles, once every warp has read
    // them (thread 0)
    if (lane == 0) wg::mbar_arrive(nat_free);
    if (tid == 0 && nxt < end) {
      wg::mbar_wait(nat_free, j & 1);
      issue(nxt);
    }

    // dS in place of dP: element e is row g + 8*((e>>1)&1) of warp w, key
    // k0 + 8*(e>>2) + 2*t4 + (e&1); kd[i] + c is the key of column offset c
    // = 8*(e>>2) + (e&1) less row i's position
    const uint64_t valid_keys = tile_bits(tile);
    const float kd[2] = {(float)(k0 + 2 * t4 - row_pos[0]), (float)(k0 + 2 * t4 - row_pos[1])};
    if (rows_plain && valid_keys == kAllKeys && (!causal || k0 + Kt - 1 <= q0)) {
      // every (row, key) pair of the tile is valid and below every row's
      // key limit: no mask
#pragma unroll
      for (int e = 0; e < Kt / 2; ++e) {
        const int i = (e >> 1) & 1;
        const float dist = fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        const float p = expf(s[e] - row_slope[i] * dist - row_lse[i]);
        dp[e] = p * (dp[e] - row_delta[i]);
        dslope[i] = fmaf(dp[e], -dist, dslope[i]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < Kt / 2; ++e) {
        const int i = (e >> 1) & 1;
        const int jj = 8 * (e >> 2) + 2 * t4 + (e & 1);
        const int kj = k0 + jj;
        const bool valid = ((valid_keys >> jj) & 1u) != 0;
        const float dist = fabsf(kd[i] + (float)(8 * (e >> 2) + (e & 1)));
        float x = s[e] - row_slope[i] * dist;
        x = (valid && (!causal || kj <= row_pos[i])) ? x : kMaskValue;
        const float p = expf(x - row_lse[i]);
        dp[e] = (kj < row_limit[i] ? p : 0.f) * (dp[e] - row_delta[i]);
        dslope[i] = fmaf(dp[e], -dist, dslope[i]);
      }
    }

    // dQ += dS.K: A from the accumulator, B K's transposed tile, the tile's
    // products from zero
    uint32_t a[Kt / 8][2][4];
    wg::acc_a<Kt / 8>(dp, a);
    float tile_sum[D / 2];
    wg::hold(a);
    wg::hold(tile_sum);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < Kt / 8; ++kk) split_rs<D, TT>(tile_sum, a[kk], base + S::kKT, kk, kk == 0);
    wg::commit();
    wg::wait_all();
    wg::hold(tile_sum);
    wg::hold(a);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += tile_sum[i];
    tile = nxt;
  }

  // element 4j + 2i + c of acc: row g + 8i of warp w, column 8j + 2t4 + c
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row_pos[i] >= tq) continue;
    float* op = dq + ((row_base + row_head[i]) * tq + row_pos[i]) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(op + 8 * j, acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }

  // the slope gradient, with the padded keys' part (once a row): each
  // block's rows of each head in a fixed order
  __syncthreads();  // every warp is done with the key tiles
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (t4 == 0) dslope[i] += padded_keys_dslope(row_pos[i], row_lse[i], row_delta[i], tq, tk, causal);
    slope_rows[(grp * kRows + w * 16 + g + 8 * i) * 4 + t4] = dslope[i];
  }
  __syncthreads();
  for (int r = tid; r < S::kGroups * heads_per_block; r += kThreads) {
    const int gg = r / heads_per_block, hh = r % heads_per_block;
    const int blk = blockIdx.x * S::kGroups + gg;
    if (blk >= blocks) continue;
    float total = 0.f;
    for (int row = hh * positions; row < (hh + 1) * positions; ++row)
#pragma unroll
      for (int c = 0; c < 4; ++c) total += slope_rows[(gg * kRows + row) * 4 + c];
    dslope_part[(row_base + head0 + hh) * blocks + blk] = total;
  }
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
               const float* dout, const float* lse, const float* delta, float* dk, float* dv, int b, int h, int hk,
               int tq, int tk, int causal, float scale, cudaStream_t stream) {
  static const int granted = grant_smem(flash_bwd_dkv<D>);
  const int smem = DkvSmem<D>::kBytes;
  if (smem > granted) return (int)cudaErrorInvalidValue;
  constexpr int Q = DkvSmem<D>::Q;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!(tile_map_f32<D>(&tm_q, q, tq, b * h, Q, 1) && tile_map_f32<D>(&tm_o, dout, tq, b * h, Q, 1) &&
        tile_map_f32<D>(&tm_k, k, tk, b * hk, kRows, 1) && tile_map_f32<D>(&tm_v, v, tk, b * hk, kRows, 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (tk + kRows - 1) / kRows * b * hk;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // with one KV head a block walks every query head's tiles: at small
  // grids split the heads over a cluster until there are 4 CTAs an SM
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
  const cudaError_t err = cudaLaunchKernelEx(&config, flash_bwd_dkv<D>, tm_q, tm_k, tm_v, tm_o, slopes, mask, lse,
                                             delta, dk, dv, h, hk, tq, tk, causal, scale);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
              const float* dout, const float* lse, const float* delta, float* dq, float* dslope_part, int b, int h,
              int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  using S = DqSmem<D>;
  static const int granted = grant_smem(flash_bwd_dq<D>);
  const int smem = S::bytes(tk);
  if (smem > granted) return (int)cudaErrorInvalidValue;
  const bool mqa = hk == 1 && h > 1 && kRows % h == 0;
  const int heads_per_block = mqa ? h : 1;
  const int positions = kRows / heads_per_block;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!(tile_map_f32<D>(&tm_q, q, tq, b * h, positions, heads_per_block) &&
        tile_map_f32<D>(&tm_o, dout, tq, b * h, positions, heads_per_block) &&
        tile_map_f32<D>(&tm_k, k, tk, b * hk, S::kKeys, 1) && tile_map_f32<D>(&tm_v, v, tk, b * hk, S::kKeys, 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (tq + positions - 1) / positions;
  const dim3 grid((blocks + S::kGroups - 1) / S::kGroups, mqa ? b : b * h);
  flash_bwd_dq<D><<<grid, S::kGroups * kWG, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, slopes, mask, lse, delta, dq,
                                                             dslope_part, h, hk, tq, tk, causal, scale,
                                                             heads_per_block);
  return (int)cudaGetLastError();
}

// launch_dkv (kDkv) or launch_dq at head dim d; out0/out1: dk/dv or dq/dslope parts
template <bool kDkv, typename Out1>
int dispatch(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask,
             const float* dout, const float* lse, const float* delta, float* out0, Out1* out1, int b, int h, int hk,
             int tq, int tk, int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk != 1 && hk != h) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    if constexpr (kDkv)
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
extern "C" int sp_flash_attention_bwd_dkv(const float* q, const float* k, const float* v, const float* slopes,
                                          const uint8_t* mask, const float* dout, const float* lse,
                                          const float* delta, float* dk, float* dv, int b, int h, int hk, int tq,
                                          int tk, int d, int causal, float scale, void* stream) {
  return dispatch<true>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk, d, causal, scale, stream);
}

// As above; dq: (b, h, tq, d); dslope_part: (b, h, blocks), each block's
// part of sum dS * (-|i-j|) for each head it holds, the padded keys' part
// included, for the caller to sum over b and blocks. A block holds 64 (head,
// position) rows: with hk = 1 and h dividing 64, all h heads at 64/h
// positions (blocks = ceil(tq / (64/h))), else 64 positions of one head
// (blocks = ceil(tq / 64)).
extern "C" int sp_flash_attention_bwd_dq(const float* q, const float* k, const float* v, const float* slopes,
                                         const uint8_t* mask, const float* dout, const float* lse,
                                         const float* delta, float* dq, float* dslope_part, int b, int h, int hk,
                                         int tq, int tk, int d, int causal, float scale, void* stream) {
  return dispatch<false>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk, tq, tk, d, causal,
                         scale, stream);
}

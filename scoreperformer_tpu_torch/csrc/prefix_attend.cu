// Decode attention over the frozen prefix cache: one query row per (batch,
// head) against the prefix rows written so far, with an additive bias,
// giving o and the logsumexp for an outside combine with the fresh chunk's
// attention. The slots go through shared memory in tiles, split across the
// blocks of a thread-block cluster where the batch leaves SMs idle (flash
// decoding in one launch).
//
// Replaces: scripts/exp_pallas_decode_attend.py::_prefix_attend_kernel (via
// `pallas_prefix_attend`), the prefix half of
// scoreperformer_tpu/models/attention.py::Attention._chunked_cache_attend.
//
// The math, per (batch b, head h), over prefix slots j < n_valid:
//   s_j = (q . k_j) * k_s[j, b] + bias[h, j]     (q pre-scaled; k_s = 1
//                                                unless the cache is int8)
//   m = max(-1e9, max_j s_j),  l = sum_j exp(s_j - m),
//   o = sum_j exp(s_j - m) * v_s[j, b] * v_j / l,  lse = m + log(l);
// with l = 0 (no slot) o = 0 and lse = -1e9, as the Pallas kernel's running
// (m, l, acc) scratch, initialised at -1e9, gives. Slots at or past n_valid
// (the chunk base: stale) are not read; their weight in the JAX function is
// exactly 0 once the fresh chunk, which always holds a valid key, is joined.
//
// Bound on the H100: each prefix row is read once and used for a few
// multiply-adds per head (h = 4 query heads share one KV head on the
// flagship, 8 on the scale_1024 recipe's decoder), at most 4 * R / (2 *
// bytes of an element) operations a byte against a ridge of 20 at 67
// TFLOP/s, so the kernel is bound by the bytes of the cache it reads: 4 * d
// B a row in fp32, 2 * d in bf16, d in int8, for d = 16, 32, 64 or 128.
//
// Design. The first port walked each block's rows one at a time in lane
// groups (two in flight, a rescale and every head's exponentials a row, in
// every lane): about a microsecond a row, the latency of a serial walk. The
// TPU kernel worked in 64-slot blocks with one rescale a block; so does this
// one, in tiles:
// - A block takes one (batch row, KV head) "unit" and a run of whole tiles
//   of its slots; the R = h / kvh query heads of the unit share every row.
//   A tile is tile_slots slots (64-128; kTileKBytes of K rows where that
//   lies between). Thread 0 copies a tile's K and V into a ring of kStages
//   shared-memory stages with TMA: boxes of kBoxRows slots of a 3-d tensor
//   map over (d, units, cap), in column blocks of up to 128 bytes with
//   TMA's swizzle, so that the lanes of a warp, one slot each, read a chunk
//   in distinct banks. A tile's last box ends at its last valid slot (it
//   starts before the tile when the tile holds fewer rows: those land in
//   rows no one reads, or past the tensor's start as zeros; rows narrower
//   than 128 bytes whose box would not start on a 128-byte boundary come as
//   16-byte bulk copies instead), so no slot at or past n_valid is read
//   (the decode's n_valid, a chunk base, needs no tail at all). A block
//   has kStages - 1 tiles in flight ahead
//   of the one it works on. The maps are cached by (pointer, shape): the
//   decode calls the kernel on the same caches every layer and step. q is
//   loaded before the copies start, and the next tile's bias and int8 row
//   scales while this tile's math runs.
// - All threads on one tile, two block barriers a tile: the (head, slot)
//   dots from 16-byte chunks (lanes over slots, warps over chunks; q from
//   registers where a warp's share fits, else broadcast from shared
//   memory); then each warp's heads side by side: one max and one rescale
//   of (m, l) a head a tile, one exponential a (head, slot); then P.V with
//   each thread owning 4 columns of every head for a slot group, the
//   groups' sums at one scale and added once at the end. fp32 FMAs only:
//   the tensor cores would not help a kernel this far below its ridge.
// - A unit splits across the blocks of a cluster only while the grid has
//   at most one block an SM (ops/prefix_attend.py::split_plan); the splits
//   push their (m, l, acc) into block 0's shared memory by remote stores,
//   and block 0 merges them in split order. No atomics and no scratch in
//   device memory: repeated runs give the same bits.
//
// What holds it back now (clock64() counters, chip_probe_decode.py): a
// block's work is a chain: the first tile's copy latency, then each tile's
// dots, softmax and P.V behind two barriers, with 4-8 warps an SM to hide
// them, and the merge's cluster barriers when a unit splits. At scale_1024's
// d = 128 with 8 heads the math of a tile (about 2 x 8 x 128 x 64 FMAs)
// outlasts its copy, so it runs near 2x its byte bound in fp32 and 5x in
// int8; narrow rows (d = 16) pay the fixed costs of a block for little data.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKBytes = 16384;  // a tile's K bytes, which set its slots
constexpr int kStages = 3;          // tiles in the ring
constexpr int kBoxRows = 16;        // slots a TMA box
constexpr float kMaskValue = -1e9f;
constexpr int kMaxCluster = 16;
constexpr int kMaxPairs = 512;  // (head, slot) pairs a tile, at most

// slots a tile at `row_bytes` bytes a row and r query heads a KV head:
// kTileKBytes of K, 64 to 128 slots, at most kMaxPairs / r
__host__ __device__ constexpr int tile_slots(int row_bytes, int r) {
  const int want = kTileKBytes / row_bytes < 64 ? 64 : kTileKBytes / row_bytes > 128 ? 128 : kTileKBytes / row_bytes;
  return want < kMaxPairs / r ? want : kMaxPairs / r;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T, int D, int R>
struct Cfg {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;    // 16-byte chunks a row
  static constexpr int kEpc = 16 / (int)sizeof(T);  // elements a chunk
  // a row lies in column blocks of kSwz bytes, each block [kTile rows][kSwz
  // bytes] as TMA writes it with that swizzle (none at 16 bytes)
  static constexpr int kSwz = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBlocks = kRowBytes / kSwz;
  static constexpr int kTile = tile_slots(kRowBytes, R);
  static constexpr int kBlockBytes = kTile * kSwz;
  // a box that ends at the tile's last row may start before its first: the
  // rows before a stage's first block land in its pad (tile 0's, past the
  // tensor's start, as zeros), those before any other block in the unused
  // rows of the block before it. TMA writes a box only to a 128-byte
  // boundary, so narrower rows end a tile that way only where the box
  // starts on one; else their last rows come as 16-byte bulk copies.
  static constexpr int kPad = round_up(kBoxRows * kSwz, 1024);
  static constexpr int kStageBytes = kPad + 2 * kBlocks * kBlockBytes;
  // scores: warps split a row's chunks, lanes (and warps, past the chunks,
  // as far as the tile has slots) its slots
  static constexpr int kChunkWarps = kChunks < kWarps ? kChunks : kWarps;
  static constexpr int kSlotWarps = kWarps / kChunkWarps < kTile / 32 ? kWarps / kChunkWarps : kTile / 32;
  static constexpr int kScoreWarps = kChunkWarps * kSlotWarps;
  static constexpr int kChunksPerWarp = kChunks / kChunkWarps;
  static constexpr int kSlotsPerLane = kTile / (32 * kSlotWarps);
  static constexpr bool kQInRegisters = kChunksPerWarp * kEpc * R <= 64;
  // softmax: warp w takes heads w, w + kWarps, ..., each lane kTile / 32 slots
  static constexpr int kHeadsPerWarp = (R + kWarps - 1) / kWarps;
  static constexpr int kLaneSlots = kTile / 32;
  // P.V: a group of D / 4 threads, 4 columns each, takes every kGroups-th slot
  static constexpr int kGroupLanes = D / 4;
  static constexpr int kGroups = kThreads / kGroupLanes;
  static constexpr int kOutPerThread = (R * D + kThreads - 1) / kThreads;
  // shared memory, bytes from a 1024-byte aligned base: q, the partial
  // scores, P, the heads' rescales, this split's (m, l), the mbarriers,
  // then the ring (after the loop: the groups' sums, and in block 0 every
  // split's state), whose size the launch sets (`smem_bytes`)
  static constexpr int kPart = R * D * 4;
  static constexpr int kP = kPart + kChunkWarps * R * kTile * 4;
  static constexpr int kAlpha = kP + kTile * R * 4;
  static constexpr int kML = kAlpha + R * 4;
  static constexpr int kBar = round_up(kML + 2 * R * 4, 8);
  static constexpr int kRing = round_up(kBar + kStages * 8, 1024);
  static constexpr int kSplitState = R * D + 2 * R;  // floats: acc, m, l
  static constexpr int kRingBytes = kStages * kStageBytes > kGroups * R * D * 4 ? kStages * kStageBytes
                                                                                  : kGroups * R * D * 4;
  // with n_splits splits, and the alignment's slack
  static constexpr int smem_bytes(int n_splits) {
    return kRing + (kRingBytes > n_splits * kSplitState * 4 ? kRingBytes : n_splits * kSplitState * 4) + 1024;
  }
  static_assert(kTile % (32 * kSlotWarps) == 0 && kChunks % kChunkWarps == 0, "tile and chunk split");
  static_assert(kThreads % kGroupLanes == 0 && kTile % kBoxRows == 0 && kBlockBytes % 1024 == 0, "layout");
  static_assert(R < kWarps || R % kWarps == 0, "a warp's heads");
};

// the byte of 16-byte chunk c of row t in a tile: TMA's swizzle XORs a
// chunk's index within its kSwz-byte row with address bits 7 and up
template <int kSwz, int kBlockBytes>
__device__ __forceinline__ int chunk_offset(int t, int c) {
  constexpr int kPer = kSwz / 16;
  const int o = t * kSwz + (c % kPer) * 16;
  return (c / kPer) * kBlockBytes + (o ^ (((o >> 7) & (kPer - 1)) << 4));
}

// one `cp.async.bulk` of 16 bytes from `src` into shared memory at `dst`,
// completing on `bar`
__device__ __forceinline__ void bulk16(uint32_t dst, const void* src, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], 16, [%2];\n" ::"r"(dst),
               "l"(src), "r"(bar)
               : "memory");
}

// the box (kSwz bytes, one unit, kBoxRows slots) of `map` at (col, unit,
// slot) into shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int col, int unit, int slot,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(unit), "r"(slot), "r"(bar)
      : "memory");
}

// the float at `value` into shared address `addr` of the cluster's CTA `rank`
__device__ __forceinline__ void st_cluster(uint32_t addr, int rank, float value) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(value) : "memory");
}

// a 32-bit word of elements as floats: 1 fp32, 2 bf16 or 4 int8
__device__ __forceinline__ void unpack(uint32_t w, float* out, const float*) { out[0] = __uint_as_float(w); }
__device__ __forceinline__ void unpack(uint32_t w, float* out, const __nv_bfloat16*) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out, const int8_t*) {
  // each byte b as 2^23 + (b ^ 0x80), less 2^23 + 128: the signed value, exact
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = __uint_as_float(__byte_perm(x, 0x4Bu, 0x4550u | e)) - 8388736.f;
}

// 4 elements from sizeof(T) 32-bit words as floats
template <typename T>
__device__ __forceinline__ void unpack4(const uint32_t* w, float* out) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i) unpack(w[i], out + i * (4 / (int)sizeof(T)), static_cast<const T*>(nullptr));
}

// 4 elements at shared address `p` (4 * sizeof(T) bytes, so aligned) as floats
template <typename T>
__device__ __forceinline__ void load4(const uint8_t* p, float* out) {
  uint32_t w[sizeof(T)];
  if constexpr (sizeof(T) == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (sizeof(T) == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  unpack4<T>(w, out);
}

// R floats at shared address `p`, 16-byte aligned when R >= 4
template <int R>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x, out[i + 1] = x.y, out[i + 2] = x.z, out[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = p[i];
  }
}

// every lane's N values reduced over the warp, the N shuffle chains side by side
template <int N>
__device__ __forceinline__ void warp_max(float (&x)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], off));
}

template <int N>
__device__ __forceinline__ void warp_sum(float (&x)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], off);
}

// One (batch row, KV head) a grid row, one split of its tiles a block; the
// splits of a grid row form one cluster, whose block 0 merges them into o
// and lse. tm_k, tm_v: the cache as (d, units, cap) with boxes of (kSwz
// bytes, 1, kBoxRows).
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
    prefix_attend_tiles(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                        const T* __restrict__ pk, const T* __restrict__ pv, const float* __restrict__ q,
                        const float* __restrict__ bias,
                        const float* __restrict__ k_s, const float* __restrict__ v_s, float* __restrict__ o,
                        float* __restrict__ lse, int batch, int kvh, int cap, int n_valid, int tiles_per_split) {
  using C = Cfg<T, D, R>;
  constexpr int kTile = C::kTile, kSwz = C::kSwz;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* q_s = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + C::kPart);
  float* p_s = reinterpret_cast<float*>(smem + C::kP);
  float* alpha_s = reinterpret_cast<float*>(smem + C::kAlpha);
  float* ml_s = reinterpret_cast<float*>(smem + C::kML);  // [m of each head, l of each head]
  const uint32_t bars = base + C::kBar, ring = base + C::kRing;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, n_splits = gridDim.x;  // the cluster spans grid x
  const int unit = blockIdx.y, units = batch * kvh;    // (batch row, KV head)
  const int bi = unit / kvh, head0 = (unit % kvh) * R, h = kvh * R;
  const int first = split * tiles_per_split;
  const int n_tiles = (n_valid + kTile - 1) / kTile;
  const int count = max(0, min(n_tiles, first + tiles_per_split) - first);

  // q's loads first, ahead of the copies' bytes
  float qv[C::kOutPerThread];
#pragma unroll
  for (int k = 0; k < C::kOutPerThread; ++k) {
    const int x = tid + k * kThreads;
    qv[k] = x < R * D ? q[((size_t)bi * h + head0) * D + x] : 0.f;
  }
  // this warp's heads' bias and each lane's slots' row scales of a tile,
  // one tile ahead: slot lane + 32 u of head warp + kWarps hw
  float nb[C::kHeadsPerWarp][C::kLaneSlots], nks[C::kLaneSlots], nvs[C::kLaneSlots];
  auto prefetch = [&](int i) {
    const int j0 = (first + i) * kTile;
#pragma unroll
    for (int u = 0; u < C::kLaneSlots; ++u) {
      const int j = j0 + lane + 32 * u;
      const bool live = i < count && j < n_valid;
      nks[u] = live && k_s != nullptr ? k_s[(size_t)j * batch + bi] : 1.f;
      nvs[u] = live && v_s != nullptr ? v_s[(size_t)j * batch + bi] : 1.f;
#pragma unroll
      for (int hw = 0; hw < C::kHeadsPerWarp; ++hw) {
        const int r = warp + hw * kWarps;
        nb[hw][u] = live && r < R ? bias[(size_t)(head0 + r) * cap + j] : 0.f;
      }
    }
  };
  prefetch(0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) wg::mbar_init(bars + 8 * s, 1);
    wg::mbar_init_fence();
    wg::prefetch_map(&tm_k);
    wg::prefetch_map(&tm_v);
  }
  __syncthreads();

  // tile `i` of this split into stage i % kStages, by thread 0: boxes of
  // kBoxRows slots, then the rest of the tile by a box that ends at its
  // last valid slot, or by 16-byte copies of those rows' chunks, so that no
  // slot at or past n_valid is read
  auto load_tile = [&](int i) {
    const int j0 = (first + i) * kTile, rows = min(kTile, n_valid - j0);
    const int boxes = rows / kBoxRows, rest = rows % kBoxRows, tail = rows - kBoxRows;  // tail may be negative
    const bool tail_box = rest != 0 && ((tail * kSwz) & 127) == 0;
    const uint32_t bar = bars + 8 * (i % kStages);
    const uint32_t k_dst = ring + (i % kStages) * C::kStageBytes + C::kPad;
    const uint32_t v_dst = k_dst + C::kBlocks * C::kBlockBytes;
    wg::mbar_expect_tx(bar, 2 * C::kRowBytes * (tail_box ? (boxes + 1) * kBoxRows : rows));
    for (int x = 0; x < boxes + (tail_box ? 1 : 0); ++x) {
      const int t = x < boxes ? x * kBoxRows : tail;
#pragma unroll
      for (int blk = 0; blk < C::kBlocks; ++blk) {
        const int off = blk * C::kBlockBytes + t * kSwz;
        tma_box(k_dst + off, &tm_k, blk * kSwz / (int)sizeof(T), unit, j0 + t, bar);
        tma_box(v_dst + off, &tm_v, blk * kSwz / (int)sizeof(T), unit, j0 + t, bar);
      }
    }
    if (!tail_box)
      for (int t = boxes * kBoxRows; t < rows; ++t) {
        const size_t row = ((size_t)(j0 + t) * units + unit) * D;
        for (int c = 0; c < C::kChunks; ++c) {
          const int off = chunk_offset<kSwz, C::kBlockBytes>(t, c);
          bulk16(k_dst + off, reinterpret_cast<const uint8_t*>(pk + row) + 16 * c, bar);
          bulk16(v_dst + off, reinterpret_cast<const uint8_t*>(pv + row) + 16 * c, bar);
        }
      }
  };
  if (tid == 0)
    for (int i = 0; i < min(count, kStages); ++i) load_tile(i);

#pragma unroll
  for (int k = 0; k < C::kOutPerThread; ++k)
    if (tid + k * kThreads < R * D) q_s[tid + k * kThreads] = qv[k];
  __syncthreads();  // q_s

  // scores: this warp's chunks of q, in registers where they fit
  const int cw = warp % C::kChunkWarps, sw = warp / C::kChunkWarps;
  float4 qr[C::kQInRegisters ? C::kChunksPerWarp * C::kEpc / 4 * R : 1];
  if constexpr (C::kQInRegisters) {
#pragma unroll
    for (int cc = 0; cc < C::kChunksPerWarp; ++cc)
#pragma unroll
      for (int e4 = 0; e4 < C::kEpc / 4; ++e4)
#pragma unroll
        for (int r = 0; r < R; ++r)
          qr[(cc * (C::kEpc / 4) + e4) * R + r] =
              *reinterpret_cast<const float4*>(q_s + r * D + (cw * C::kChunksPerWarp + cc) * C::kEpc + 4 * e4);
  }

  // this warp's heads' running max and sum (every lane the same), every
  // head's 4 columns of this thread's group
  float hm[C::kHeadsPerWarp], hl[C::kHeadsPerWarp], acc[R][4];
#pragma unroll
  for (int hw = 0; hw < C::kHeadsPerWarp; ++hw) hm[hw] = kMaskValue, hl[hw] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int grp = tid / C::kGroupLanes, c0 = (tid % C::kGroupLanes) * 4;

  for (int i = 0; i < count; ++i) {
    const int st = i % kStages;
    const int rows = min(kTile, n_valid - (first + i) * kTile);
    const uint8_t* k_t = smem + C::kRing + st * C::kStageBytes + C::kPad;
    const uint8_t* v_t = k_t + C::kBlocks * C::kBlockBytes;
    float cb[C::kHeadsPerWarp][C::kLaneSlots], cks[C::kLaneSlots], cvs[C::kLaneSlots];
#pragma unroll
    for (int u = 0; u < C::kLaneSlots; ++u) {
      cks[u] = nks[u], cvs[u] = nvs[u];
#pragma unroll
      for (int hw = 0; hw < C::kHeadsPerWarp; ++hw) cb[hw][u] = nb[hw][u];
    }
    prefetch(i + 1);  // in flight during this tile
    wg::mbar_wait(bars + 8 * st, (i / kStages) & 1);

    // 1. partial scores: each lane's slots over this warp's chunks
    if (warp < C::kScoreWarps) {
      float dot[C::kSlotsPerLane][R];
#pragma unroll
      for (int sl = 0; sl < C::kSlotsPerLane; ++sl)
#pragma unroll
        for (int r = 0; r < R; ++r) dot[sl][r] = 0.f;
#pragma unroll
      for (int cc = 0; cc < C::kChunksPerWarp; ++cc) {
        const int chunk = cw * C::kChunksPerWarp + cc;
        uint4 kw[C::kSlotsPerLane];
#pragma unroll
        for (int sl = 0; sl < C::kSlotsPerLane; ++sl)
          kw[sl] = *reinterpret_cast<const uint4*>(
              k_t + chunk_offset<kSwz, C::kBlockBytes>(sl * 32 * C::kSlotWarps + sw * 32 + lane, chunk));
#pragma unroll
        for (int e4 = 0; e4 < C::kEpc / 4; ++e4) {
          float kf[C::kSlotsPerLane][4];  // elements 4 e4 to 4 e4 + 3 of each slot's chunk
#pragma unroll
          for (int sl = 0; sl < C::kSlotsPerLane; ++sl) {
            const uint32_t w[4] = {kw[sl].x, kw[sl].y, kw[sl].z, kw[sl].w};
            unpack4<T>(w + e4 * (int)sizeof(T), kf[sl]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float4 qq;
            if constexpr (C::kQInRegisters)
              qq = qr[(cc * (C::kEpc / 4) + e4) * R + r];
            else
              qq = *reinterpret_cast<const float4*>(q_s + r * D + chunk * C::kEpc + 4 * e4);
#pragma unroll
            for (int sl = 0; sl < C::kSlotsPerLane; ++sl) {
              float d = dot[sl][r];
              d = fmaf(qq.x, kf[sl][0], d);
              d = fmaf(qq.y, kf[sl][1], d);
              d = fmaf(qq.z, kf[sl][2], d);
              dot[sl][r] = fmaf(qq.w, kf[sl][3], d);
            }
          }
        }
      }
#pragma unroll
      for (int sl = 0; sl < C::kSlotsPerLane; ++sl)
#pragma unroll
        for (int r = 0; r < R; ++r) part[(cw * R + r) * kTile + sl * 32 * C::kSlotWarps + sw * 32 + lane] = dot[sl][r];
    }
    __syncthreads();  // every thread is past tile i - 1: its stage is free
    if (tid == 0 && i >= 1 && i - 1 + kStages < count) load_tile(i - 1 + kStages);

    // 2. this warp's heads (all of them past R, which is a multiple of
    // kWarps there), side by side: the scores, one max, one exponential a
    // slot, P = p * v_s, one rescale of (m, l)
    if (warp < R) {  // warp-uniform
      constexpr int H = C::kHeadsPerWarp;
      float sc[H][C::kLaneSlots], mx[H], sum[H];
#pragma unroll
      for (int hw = 0; hw < H; ++hw) {
        const int r = warp + hw * kWarps;
        mx[hw] = -INFINITY;
#pragma unroll
        for (int u = 0; u < C::kLaneSlots; ++u) {
          const int t = lane + 32 * u;
          float dsum = 0.f;
#pragma unroll
          for (int w = 0; w < C::kChunkWarps; ++w) dsum += part[(w * R + r) * kTile + t];
          sc[hw][u] = t < rows ? dsum * cks[u] + cb[hw][u] : -INFINITY;
          mx[hw] = fmaxf(mx[hw], sc[hw][u]);
        }
      }
      warp_max<H>(mx);
#pragma unroll
      for (int hw = 0; hw < H; ++hw) {
        const int r = warp + hw * kWarps;
        const float m_new = fmaxf(hm[hw], mx[hw]);
        mx[hw] = expf(hm[hw] - m_new);  // the rescale
        hm[hw] = m_new;
        sum[hw] = 0.f;
#pragma unroll
        for (int u = 0; u < C::kLaneSlots; ++u) {
          const int t = lane + 32 * u;
          const float e = t < rows ? expf(sc[hw][u] - m_new) : 0.f;
          p_s[t * R + r] = e * cvs[u];
          sum[hw] += e;
        }
        if (lane == 0) alpha_s[r] = mx[hw];
      }
      warp_sum<H>(sum);
#pragma unroll
      for (int hw = 0; hw < H; ++hw) hl[hw] = fmaf(hl[hw], mx[hw], sum[hw]);
    }
    __syncthreads();

    // 3. one rescale a head; this group's slots into its 4 columns of every
    // head (the next tile's first barrier frees P, alpha and this stage)
    float alpha[R];
    load_row<R>(alpha_s, alpha);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha[r];
    const int vbyte = c0 * (int)sizeof(T);
    for (int t = grp; t < rows; t += C::kGroups) {
      float vf[4], pr[R];
      load4<T>(v_t + chunk_offset<kSwz, C::kBlockBytes>(t, vbyte / 16) + vbyte % 16, vf);
      load_row<R>(p_s + t * R, pr);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pr[r], vf[c], acc[r][c]);
    }
  }

  // this split's state: the groups' sums (one scale: every group took the
  // same rescales), each head's (m, l) from the warp that kept it
  __syncthreads();  // the ring is free: every copy was waited for, every tile read
  float* group_sums = reinterpret_cast<float*>(smem + C::kRing);
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(group_sums + (grp * R + r) * D + c0) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  if (lane == 0 && warp < R)
#pragma unroll
    for (int hw = 0; hw < C::kHeadsPerWarp; ++hw) ml_s[warp + hw * kWarps] = hm[hw], ml_s[R + warp + hw * kWarps] = hl[hw];
  __syncthreads();
  float sums[C::kOutPerThread];
#pragma unroll
  for (int k = 0; k < C::kOutPerThread; ++k) {
    const int x = tid + k * kThreads;
    sums[k] = 0.f;
    if (x < R * D)
      for (int gi = 0; gi < C::kGroups; ++gi) sums[k] += group_sums[gi * R * D + x];
  }

  float* out = o + ((size_t)bi * h + head0) * D;
  if (n_splits == 1) {  // o and lse from this block's state
#pragma unroll
    for (int k = 0; k < C::kOutPerThread; ++k) {
      const int x = tid + k * kThreads;
      if (x < R * D) {
        const float l = ml_s[R + x / D];
        out[x] = sums[k] / (l == 0.f ? 1.f : l);
      }
    }
    if (tid < R) {
      const float l = ml_s[R + tid];
      lse[(size_t)bi * h + head0 + tid] = ml_s[tid] + logf(l == 0.f ? 1.f : l);
    }
    return;
  }

  // every split's state into block 0's shared memory, in place of its ring,
  // by remote stores; then block 0 merges them in split order (no atomics)
  float* inbox = reinterpret_cast<float*>(smem + C::kRing);  // [split][acc, m, l]
  wg::cluster_sync();  // block 0 is past its tiles and its groups' sums
  const uint32_t mine = ring + split * C::kSplitState * 4;
#pragma unroll
  for (int k = 0; k < C::kOutPerThread; ++k)
    if (tid + k * kThreads < R * D) st_cluster(mine + 4 * (tid + k * kThreads), 0, sums[k]);
  if (tid < 2 * R) st_cluster(mine + 4 * (R * D + tid), 0, ml_s[tid]);
  wg::cluster_sync();
  if (split != 0) return;
  float* weight = p_s;       // [head][split]
  float* head_sum = alpha_s;  // [head]
  if (tid < R) {
    float mx = kMaskValue, lsum = 0.f;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, inbox[s * C::kSplitState + R * D + tid]);
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(inbox[s * C::kSplitState + R * D + tid] - mx);
      weight[tid * kMaxCluster + s] = w;
      lsum = fmaf(inbox[s * C::kSplitState + R * D + R + tid], w, lsum);
    }
    const float safe_l = lsum == 0.f ? 1.f : lsum;
    head_sum[tid] = safe_l;
    lse[(size_t)bi * h + head0 + tid] = mx + logf(safe_l);
  }
  __syncthreads();
  for (int x = tid; x < R * D; x += kThreads) {
    const int r = x / D;
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) a = fmaf(inbox[s * C::kSplitState + x], weight[r * kMaxCluster + s], a);
    out[x] = a / head_sum[r];
  }
}

// ---- host: tensor maps, launch ----

// `map` over a (cap, units, d) cache of `dtype` (0 fp32, 1 bf16, 2 int8) at
// `ptr`, as the kernel reads it: boxes of (kSwz bytes, 1 unit, kBoxRows
// slots), swizzled as chunk_offset reads them
CUresult encode_map(CUtensorMap* map, const void* ptr, int dtype, int d, int units, int cap) {
  const wg::EncodeTiled encode = wg::encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const int elt = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  const int row = d * elt, swz = row < 128 ? row : 128;
  const CUtensorMapDataType type = dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)units, (cuuint64_t)cap};
  const cuuint64_t strides[2] = {(cuuint64_t)row, (cuuint64_t)row * units};
  const cuuint32_t box[3] = {(cuuint32_t)(swz / elt), 1, (cuuint32_t)kBoxRows};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = swz == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : swz == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The maps of the caches seen last, by (pointer, dtype, shape): a decode
// calls the kernel on the same caches every layer and step, and an encode
// costs the host microseconds. Calls may come from several host threads.
class MapCache {
 public:
  CUresult get(CUtensorMap* map, const void* ptr, int dtype, int d, int units, int cap) {
    std::lock_guard<std::mutex> lock(mutex_);
    for (const Entry& e : entries_)
      if (e.ptr == ptr && e.dtype == dtype && e.d == d && e.units == units && e.cap == cap) {
        *map = e.map;
        return CUDA_SUCCESS;
      }
    Entry& e = entries_[next_];
    e.ptr = nullptr;
    const CUresult err = encode_map(&e.map, ptr, dtype, d, units, cap);
    if (err != CUDA_SUCCESS) return err;
    e.ptr = ptr, e.dtype = dtype, e.d = d, e.units = units, e.cap = cap;
    next_ = (next_ + 1) % kSize;
    *map = e.map;
    return CUDA_SUCCESS;
  }

 private:
  struct Entry {
    const void* ptr = nullptr;
    int dtype = 0, d = 0, units = 0, cap = 0;
    CUtensorMap map;
  };
  static constexpr int kSize = 64;
  std::mutex mutex_;
  Entry entries_[kSize];
  int next_ = 0;
};

MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// the kernel's attributes, once: its shared memory and clusters past 8
template <typename T, int D, int R>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    auto* kernel = prefix_attend_tiles<T, D, R>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<T, D, R>::smem_bytes(kMaxCluster));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

constexpr int kNotTheTile = -1;    // returned for a tile that is not the kernel's
constexpr int kMapError = -1000;   // less the CUresult of a tensor map not encoded

struct Args {
  const float* q;
  const void *pk, *pv;
  const float *bias, *k_s, *v_s;
  float *o, *lse;
  int b, kvh, cap, n_valid, n_splits, tiles_per_split, tile, dtype;
  cudaStream_t stream;
};

template <typename T, int D, int R>
int run(const Args& a) {
  using C = Cfg<T, D, R>;
  auto* kernel = prefix_attend_tiles<T, D, R>;
  const cudaError_t ready = prepare<T, D, R>();
  if (ready != cudaSuccess) return (int)ready;
  if (a.tile != C::kTile) return kNotTheTile;
  CUtensorMap tm_k, tm_v;
  CUresult err = map_cache().get(&tm_k, a.pk, a.dtype, D, a.b * a.kvh, a.cap);
  if (err == CUDA_SUCCESS) err = map_cache().get(&tm_v, a.pv, a.dtype, D, a.b * a.kvh, a.cap);
  if (err != CUDA_SUCCESS) return kMapError - (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.n_splits, a.b * a.kvh, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = C::smem_bytes(a.n_splits);
  config.stream = a.stream;
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.n_splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, tm_k, tm_v, static_cast<const T*>(a.pk), static_cast<const T*>(a.pv),
                                 a.q, a.bias, a.k_s, a.v_s, a.o, a.lse, a.b, a.kvh, a.cap, a.n_valid,
                                 a.tiles_per_split);
}

template <typename T, int D>
int run_heads(int r, const Args& a) {
  switch (r) {
    case 1: return run<T, D, 1>(a);
    case 2: return run<T, D, 2>(a);
    case 4: return run<T, D, 4>(a);
    case 8: return run<T, D, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run_dims(int d, int r, const Args& a) {
  switch (d) {
    case 16: return run_heads<T, 16>(r, a);
    case 32: return run_heads<T, 32>(r, a);
    case 64: return run_heads<T, 64>(r, a);
    case 128: return run_heads<T, 128>(r, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int d, int r, const Args& a) {
  switch (a.dtype) {
    case 0: return run_dims<float>(d, r, a);
    case 1: return run_dims<__nv_bfloat16>(d, r, a);
    case 2: return run_dims<int8_t>(d, r, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, h, d) fp32, scale folded in, d in {16, 32, 64, 128}, h in {1, 2, 4,
// 8}; pk, pv: (cap, b, kvh * d) of `dtype` (0 fp32, 1 bf16, 2 int8), kvh in
// {1, h}; bias: (h, cap) fp32; k_s, v_s: (cap, b) fp32 row scales or null;
// o: (b, h, d), lse: (b, h). Slot j < n_valid lies in tile j / tile (`tile`
// must be the kernel's own tile_slots for d, dtype and h / kvh), tile i in
// split i / tiles_per_split; n_splits <= 16 blocks form one cluster a
// (batch row, KV head). All contiguous, the cache 16-byte aligned. Returns
// the CUDA error code of the launch, -1 for a tile that is not the
// kernel's, or -1000 less the CUresult of a tensor map it could not encode.
extern "C" int sp_prefix_attend(const float* q, const void* pk, const void* pv, const float* bias,
                                const float* k_s, const float* v_s, float* o, float* lse, int b, int h, int kvh, int d,
                                int cap, int n_valid, int n_splits, int tiles_per_split, int tile, int dtype,
                                void* stream) {
  if ((kvh != 1 && kvh != h) || n_splits < 1 || n_splits > kMaxCluster || tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid, n_splits, tiles_per_split, tile, dtype,
               static_cast<cudaStream_t>(stream)};
  return dispatch(d, h / kvh, a);
}

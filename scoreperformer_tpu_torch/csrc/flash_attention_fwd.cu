// Flash-attention forward with ALiBi generated in the kernel, fp32 in and
// out, its products on the tensor cores in split TF32.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_kernel, the
// Pallas forward that `_flash_forward` launches for `flash_attention_alibi`,
// on fp32 operands; the bf16 instances are csrc/flash_attention_fwd_bf16.cu's
// (bf16 `wgmma`).
//
// Bounds on the H100. The work is 4*d fp32 operations per (query row, key)
// pair and head (q.k and p.v, a multiply and an add each) over a few MB of
// q/k/v, far above the bytes: on the CUDA cores it is bound by fp32's 67
// TFLOP/s (b=128, t=384 at the served lengths: 0.166 ms). TF32 tensor cores
// run 495 TFLOP/s, but one TF32 product keeps 11 bits, and the port's checks
// need fp32 accuracy (o and lse to 1e-4, greedy tokens equal to the CPU's,
// gradients to 1e-3), as the JAX kernel's "highest" precision gives on the
// CPU. So each product is split: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (`tf32::rna`; the split and
// MMA helpers are in tf32_mma.cuh, shared with the backward), and
// a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b, summed in fp32; the dropped
// lo.lo term and lo's rounding leave an error near 2^-21 relative. The
// tensor cores truncate the fp32 sums they accumulate, which biases a long
// chain of products in one accumulator toward zero: enough to move
// gradients that are sums of cancelling terms (with such chains a batch-4
// train step's ALiBi-slope gradients are 8.4e-3 off the CPU's, against a
// 1e-3 gate). So each k-step's three products start from zero and join the
// running sums by rounded fp32 adds (2.8e-4 there). Three tensor-core
// products where fp32 needs one: the floor is 3 * operations / 495 TFLOP/s
// (`bound_tc_ms` in chip_smoke.py), 0.067 ms at the shape above.
//
// Design.
// - One block of 4 warps owns 64 query rows, 16 per warp: one m16 row tile
//   of `mma.sync.m16n8k8.tf32`. With one KV head (MQA) the 64 rows are the
//   h heads x 64/h positions of one batch element, so each K/V tile is read
//   once for all heads; otherwise 64 positions of one head. The slope and
//   the causal test are per row. 64/h divides 256, so a block never
//   straddles the JAX wrapper's query blocks (bq = 256 when t_q >= 256).
// - q is scaled and split into hi/lo TF32 A fragments once; each lane keeps
//   its own in shared memory (16 bytes a load), which holds the kernel to
//   143 registers at d=64 (with them in registers beside the rounded joins
//   it ran out of registers and spilled), so three blocks fit an SM. Keys and values stream through shared memory in tiles
//   of 32 rows, copied with `cp.async` 16 bytes a lane and double-buffered:
//   the next tile is in flight while this one is computed. Rows are padded
//   to d+4 floats, so the B-fragment loads of K (key = lane/4, dim = lane%4)
//   and of V (key = 2*(lane%4), dim = lane/4) hit 32 distinct banks.
// - S = Q.K^T lands in the m16n8 accumulator layout (row lane/4 or +8,
//   keys 2*(lane%4) and +1). The online softmax runs there in fp32
//   registers: the bias -slope*|i-j|, the mask, the row max over the 4
//   lanes of a row (two shuffles), exp. P feeds the P.V product without a
//   trip through shared memory: the contraction over a tile's 8 keys may
//   take them in any order, so A-fragment column c holds key 2c (c < 4) or
//   2(c-4)+1, and V's B fragment reads its rows in the same order.
// - Key tiles whose keys are all masked are skipped, unless the block holds
//   a query row with no valid key. The skip is exact: for a row with a valid
//   key, a masked key's weight exp(-1e30 - m) is 0, or is wiped by the
//   rescale exp(-1e30 - m_new) = 0 once the valid key arrives. The block
//   reads the key mask once into shared memory as bits (one ballot per
//   32-key tile), which also give the first valid key, and with it whether a
//   row lacks one: every row when the element has none, rows before it with
//   `causal`.
// As in the TPU kernel: q is scaled before the dot, the bias is
// -slope*|i-j|, masked scores are -1e30, l is clamped at 1e-30, causal
// tiles past the block's last row are skipped. Keys past t take no part (no
// padding by the caller), and with one KV head every query head reads KV
// head 0.
//
// Head dims 16, 32, 64 and 128, one template. The staged rows of d+4 floats
// keep both B-fragment reads on 32 distinct banks at every one of them
// (d = 16: 80-byte rows, each still a whole number of 16-byte cp.async
// pieces). At d = 128 a block's shared memory is 133,120 bytes (four K/V
// tiles of 16,896 and q's split fragments, 65,536) plus the key bits, so
// one block an SM, and its accumulator is 64 registers a thread.
//
// A query row with no valid key gets what the JAX wrapper gives it: that
// wrapper pads keys to whole blocks of bk = max(128, min(256, t_k)) with
// mask 0, so such a row averages v (zero past t_k) over every key of the
// key blocks its query block visits: ceil(t_k / bk) * bk of them, or with
// `causal` the blocks up to the end of its query block of
// bq = max(8, min(256, t_q)) rows (`jax_masked_row_keys`). A block that
// holds such a row visits every key tile, and with `causal` runs on to that
// row's last key.
//
// Left for later work: `wgmma` (it takes TF32 operands K-major only, so V
// would have to be transposed in shared memory), TMA copies and warp
// specialisation, more than one block an SM at d = 128 (q's fragments in
// registers, or a narrower tile).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;                    // one m16 tile
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // (head, position) rows a block
constexpr int kBlockK = 32;                        // keys a tile
constexpr float kMaskValue = -1e30f;

template <int D>
struct Layout {
  static constexpr int kStride = D + 4;  // floats a staged K or V row
  static constexpr int kTileFloats = kBlockK * kStride;
  static constexpr int kQFrags = kWarps * (D / 8) * 2 * 32;  // uint4 q fragments, hi and lo
  // K and V, two buffers each; q's fragments; the key-validity bits follow
  static constexpr int kTileBytes = 4 * kTileFloats * (int)sizeof(float) + kQFrags * 16;
};

using tf32::cp_async_commit;
using tf32::cp_async_wait_prev;
using tf32::mma_split;
using tf32::split;

// Keys that the JAX wrapper averages over for a query row with no valid key.
__device__ __forceinline__ int jax_masked_row_keys(int qi, int tq, int tk, int causal) {
  const int bk = max(128, min(256, tk));
  const int n_kb = (tk + bk - 1) / bk;
  if (!causal) return n_kb * bk;
  const int bq = max(8, min(256, tq));
  const int q_end = (qi / bq + 1) * bq;
  return min(n_kb, (q_end + bk - 1) / bk) * bk;
}

// Grid: (query tiles of 64 / heads_per_block positions, b) when
// heads_per_block == h (one KV head), else (query tiles of 64, b * h).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ slopes,
              const uint8_t* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ lse, int h, int hk, int tq, int tk, int causal, float scale,
              int heads_per_block) {
  using L = Layout<D>;
  constexpr int kStride = L::kStride;
  constexpr int kSteps = D / 8;          // k-steps of Q.K^T, n-tiles of P.V
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of Q.K^T, k-steps of P.V
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [2][kBlockK][kStride]
  float* vs = smem + 2 * L::kTileFloats;     // [2][kBlockK][kStride]
  uint4* q_frag = reinterpret_cast<uint4*>(smem + 4 * L::kTileFloats);  // [warp][kk][hi, lo][lane]
  uint32_t* bits = reinterpret_cast<uint32_t*>(q_frag + L::kQFrags);  // [tiles]
  __shared__ int first_valid;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row (and +8)
  const int t4 = lane % 4;  // fragment column
  const int positions = kBlockRows / heads_per_block;
  const int b = heads_per_block == 1 ? blockIdx.y / h : blockIdx.y;
  const int head0 = heads_per_block == 1 ? blockIdx.y % h : 0;
  const int q0 = blockIdx.x * positions;
  const size_t kv_off = ((size_t)b * hk + (hk == 1 ? 0 : head0)) * tk * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;
  const uint8_t* mp = mask + (size_t)b * tk;

  // this thread's two rows: g and g + 8 of the warp's 16
  int row_head[2], row_pos[2];
  float row_slope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * kRowsPerWarp + g + 8 * i;
    row_head[i] = head0 + r / positions;
    row_pos[i] = q0 + r % positions;
    row_slope[i] = slopes[row_head[i]];
  }

  // key validity as bits, and the first valid key
  const int all_tiles = (tk + kBlockK - 1) / kBlockK;
  if (tid == 0) first_valid = INT_MAX;
  __syncthreads();
  int first = INT_MAX;
  for (int w = warp; w < all_tiles; w += kWarps) {
    const int j = w * 32 + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, j < tk && mp[j] != 0);
    if (lane == 0) bits[w] = word;
    if (word != 0 && first == INT_MAX) first = w * 32 + __ffs(word) - 1;
  }
  if (lane == 0 && first != INT_MAX) atomicMin(&first_valid, first);
  __syncthreads();
  // a row of this block has no valid key: its first row's, if any
  const bool has_empty_row = first_valid >= tk || (causal && first_valid > q0);
  const int last_pos = min(tq, q0 + positions) - 1;
  int end = causal ? min(all_tiles, last_pos / kBlockK + 1) : all_tiles;
  if (causal && has_empty_row) {
    const int keys = min(tk, jax_masked_row_keys(q0, tq, tk, causal));
    end = max(end, (keys + kBlockK - 1) / kBlockK);
  }
  auto next_tile = [&](int tile) {
    while (tile < end && !has_empty_row && bits[tile] == 0) ++tile;
    return tile;
  };
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kBlockK;
    float* kd = ks + buf * L::kTileFloats;
    float* vd = vs + buf * L::kTileFloats;
    constexpr int kChunks = kBlockK * D / 4;  // 16-byte pieces of a tile
#pragma unroll
    for (int c = tid; c < kChunks; c += kThreads) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      const bool in = k0 + r < tk;
      const size_t src = (size_t)(in ? k0 + r : 0) * D + col;
      tf32::load4(kd + r * kStride + col, kp + src, in);
      tf32::load4(vd + r * kStride + col, vp + src, in);
    }
  };

  int tile = next_tile(0);
  if (tile < end) load_tile(tile, 0);
  cp_async_commit();

  // q, scaled, as split A fragments (row g or g+8, column t4 or t4+4), kept
  // in shared memory where only this lane reads them
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e & 1;
      const int col = kk * 8 + t4 + 4 * (e >> 1);
      const float x = row_pos[i] < tq
                          ? q[(((size_t)b * h + row_head[i]) * tq + row_pos[i]) * D + col] * scale
                          : 0.f;
      split(x, hi[e], lo[e]);
    }
    q_frag[((warp * kSteps + kk) * 2 + 0) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    q_frag[((warp * kSteps + kk) * 2 + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  float acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  int buf = 0;
  while (tile < end) {
    const int nxt = next_tile(tile + 1);
    if (nxt < end) load_tile(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* kt = ks + buf * L::kTileFloats;
    const float* vt = vs + buf * L::kTileFloats;
    const int k0 = tile * kBlockK;

    // S = Q.K^T: B fragment (dim t4 or t4+4, key g) of each 8-key n-tile
    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint4 qh = q_frag[((warp * kSteps + kk) * 2 + 0) * 32 + lane];
      const uint4 ql = q_frag[((warp * kSteps + kk) * 2 + 1) * 32 + lane];
      const uint32_t q_hi[4] = {qh.x, qh.y, qh.z, qh.w};
      const uint32_t q_lo[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const float* kr = kt + (n * 8 + g) * kStride + kk * 8 + t4;
        uint32_t b_hi[2], b_lo[2];
        split(kr[0], b_hi[0], b_lo[0]);
        split(kr[4], b_hi[1], b_lo[1]);
        mma_split(s[n], q_hi, q_lo, b_hi, b_lo);
      }
    }

    // online softmax on the accumulator: s[n][e] is row g + 8*(e>>1), key
    // k0 + 8n + 2*t4 + (e&1)
    const uint32_t w0 = bits[tile];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int jj = n * 8 + 2 * t4 + (e & 1);
        const int j = k0 + jj;
        const bool valid = ((w0 >> jj) & 1u) != 0;
        float x = s[n][e] - row_slope[i] * fabsf((float)(j - row_pos[i]));
        x = (valid && (!causal || j <= row_pos[i])) ? x : kMaskValue;
        x = j < tk ? x : -INFINITY;  // keys past t take no part at all
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P.V: the k-step over keys 8kk.. takes them in the order
    // 0, 2, 4, 6, 1, 3, 5, 7, so A comes straight from the accumulator
#pragma unroll
    for (int kk = 0; kk < kKeyTiles; ++kk) {
      uint32_t p_hi[4], p_lo[4];
      split(s[kk][0], p_hi[0], p_lo[0]);  // (g, key 2*t4)
      split(s[kk][2], p_hi[1], p_lo[1]);  // (g + 8, key 2*t4)
      split(s[kk][1], p_hi[2], p_lo[2]);  // (g, key 2*t4 + 1)
      split(s[kk][3], p_hi[3], p_lo[3]);  // (g + 8, key 2*t4 + 1)
      const float* vr = vt + (kk * 8 + 2 * t4) * kStride + g;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t b_hi[2], b_lo[2];
        split(vr[n * 8], b_hi[0], b_lo[0]);
        split(vr[kStride + n * 8], b_hi[1], b_lo[1]);
        mma_split(acc[n], p_hi, p_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // this buffer is refilled next iteration
    tile = nxt;
    buf ^= 1;
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
    const float lc = m[i] == kMaskValue ? (float)jax_masked_row_keys(qi, tq, tk, causal)
                                        : fmaxf(l[i], 1e-30f);
    const size_t row = ((size_t)b * h + row_head[i]) * tq + qi;
    float* op = out + row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) tf32::store2(op + n * 8, acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    if (lse != nullptr && t4 == 0) lse[row] = m[i] + logf(lc);
  }
}

template <int D>
int max_dynamic_smem() {
  // the device's opt-in limit less the static part, granted to the kernel once
  static const int bytes = [] {
    int dev = 0, limit = 0;
    cudaFuncAttributes attr = {};
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncGetAttributes(&attr, flash_fwd<D>);
    const int dynamic = limit - (int)attr.sharedSizeBytes;
    cudaFuncSetAttribute(flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    return dynamic;
  }();
  return bytes;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask, float* out,
           float* lse, int b, int h, int hk, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  const int all_tiles = (tk + kBlockK - 1) / kBlockK;
  const size_t smem = Layout<D>::kTileBytes + sizeof(uint32_t) * all_tiles;
  if (smem > (size_t)max_dynamic_smem<D>()) return (int)cudaErrorInvalidValue;
  const bool mqa = hk == 1 && h > 1 && kBlockRows % h == 0;
  const int heads_per_block = mqa ? h : 1;
  const int positions = kBlockRows / heads_per_block;
  const dim3 grid((tq + positions - 1) / positions, mqa ? b : b * h);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(q, k, v, slopes, mask, out, lse, h, hk, tq, tk, causal, scale,
                                                 heads_per_block);
  return (int)cudaGetLastError();
}

int dispatch(const float* q, const float* k, const float* v, const float* slopes, const uint8_t* mask, float* out,
             float* lse, int b, int h, int hk, int tq, int tk, int d, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hk != 1 && hk != h) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch<16>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
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


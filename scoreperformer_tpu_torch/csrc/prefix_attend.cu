// Decode attention over the frozen prefix cache, split across the blocks of
// one thread-block cluster (flash decoding in one launch): one query row per
// (batch, head) against the prefix rows written so far, with an additive
// bias, giving o and the logsumexp for an outside combine with the fresh
// chunk's attention.
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
// flagship, 8 on the scale_1024 recipe's decoder), so the kernel is bound by
// the bytes of the cache it reads: 4 * d B a row in fp32, 2 * d in bf16, d in
// int8, for d = 16, 32, 64 or 128 (the recipes' decoder head dims).
//
// Design. The TPU kernel put the batch on the 128 lanes and needed the cache
// relaid as (cap, d, b); here the time-major cache is read as it lies. A row
// (slot j, batch b, KV head g) is d contiguous elements, loaded by a group of
// d/4 lanes, 4 elements (16 B in fp32, 8 in bf16, 4 in int8) a lane, so one
// warp reads 8 (d = 16), 4 (d = 32), 2 (d = 64) or 1 (d = 128) rows at a
// time, converting bf16 or int8 to fp32 in registers; a row's dot product
// is summed by log2(d/4) shuffles within its lane group. Each lane group
// keeps two rows in flight: the next row's loads (k, v, scales, bias) are
// requested before this row's dot, shuffles and exponentials. All H query heads of the batch row live in the same block,
// H a template parameter (1, 2, 4 or 8): each lane keeps q, the running max,
// sum and its 4 columns of the output for every head, so with one KV head
// each row is read once for all heads. The slots are split across the
// blocks of one cluster (grid: splits x b, cluster: splits x 1), so that the
// grid fills the 132 SMs even at b = 1, in one wave of blocks: a block has a
// fixed cost of several us, more with larger clusters, so a second wave
// costs more than its shorter loops save (ops/prefix_attend.py::split_plan;
// the split sweep in chip_smoke.py).
// Each block merges its lane groups' states in its shared memory; after a
// cluster barrier, block 0 reads every split's (m, l, acc) from distributed
// shared memory, merges them in split order and writes o and lse; a second
// barrier keeps the other blocks' shared memory alive until it has. No
// atomics and no scratch in device memory: repeated runs give the same bits.
//
// What holds it back: each row costs a lane group about a microsecond,
// whether the cache lies in L2 or in device memory (chip_smoke.py's split
// sweep), and neither four rows in flight nor two rows a step was faster.
// At d = 128 with 8 heads it is 9x its byte bound and twice its plain
// version: a warp takes each row alone and every lane repeats the 8 heads'
// exponentials. The cause is not found yet (open question in PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 4;  // elements a lane loads from a row
constexpr float kMaskValue = -1e9f;
constexpr int kMaxPortableCluster = 8;
constexpr int kMaxCluster = 16;

// Threads a block at head dim D: four warps, so that a block keeps 32 (d =
// 16) to 8 (d = 64) lane groups, each with two rows in flight; eight at d =
// 128, where a row takes a whole warp (chip_probe_decode.py: 256 threads are
// 15% faster at d = 128 and 40-60% slower at d = 16 and 64).
__host__ __device__ constexpr int threads_for(int D) { return D == 128 ? 256 : 128; }

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  out[0] = __low2float(lo), out[1] = __high2float(lo);
  out[2] = __low2float(hi), out[3] = __high2float(hi);
}

__device__ __forceinline__ void load4(const int8_t* p, float* out) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  out[0] = (float)x.x, out[1] = (float)x.y, out[2] = (float)x.z, out[3] = (float)x.w;
}

// What a lane needs of one (slot, KV head) row.
template <int H>
struct Row {
  float k[kVec], v[kVec], bias[H], k_s, v_s;
};

// One split of the slots of one batch row per block; the splits of a batch
// row form one cluster, whose block 0 merges them into o and lse.
template <typename T, int D, int H>
__global__ void __launch_bounds__(threads_for(D))
    prefix_attend_cluster(const float* __restrict__ q, const T* __restrict__ pk,
                          const T* __restrict__ pv, const float* __restrict__ bias,
                          const float* __restrict__ k_s, const float* __restrict__ v_s,
                          float* __restrict__ o, float* __restrict__ lse, int batch, int kvh,
                          int cap, int n_valid, int slots_per_split) {
  constexpr int kThreads = threads_for(D);
  constexpr int kLanesPerRow = D / kVec;            // 4 at d = 16 ... 32 at d = 128
  constexpr int kGroups = kThreads / kLanesPerRow;  // lane groups a block
  __shared__ float group_m[kGroups][H];
  __shared__ float group_l[kGroups][H];
  __shared__ float group_acc[kGroups][H][D];
  __shared__ float split_m[H];  // this split's state, read by block 0
  __shared__ float split_l[H];
  __shared__ float split_acc[H * D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_splits = gridDim.x;  // the cluster spans grid x
  const int bi = blockIdx.y;
  const int group = threadIdx.x / kLanesPerRow;
  const int c0 = (threadIdx.x % kLanesPerRow) * kVec;
  const int heads_per_kv = H / kvh;
  const int row_len = kvh * D;

  float qr[H][kVec], acc[H][kVec], m[H], l[H];
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    m[hh] = kMaskValue;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      acc[hh][c] = 0.f;
      qr[hh][c] = q[((size_t)bi * H + hh) * D + c0 + c];
    }
  }

  const int j0 = split * slots_per_split;
  const int j1 = min(n_valid, j0 + slots_per_split);
  const int n_units = max(0, j1 - j0) * kvh;  // (slot, KV head) rows
  auto fetch = [&](int u, Row<H>& r) {
    const bool live = u < n_units;
    const int j = j0 + (live ? u / kvh : 0);
    const int g = live ? u % kvh : 0;
    const size_t row = (size_t)j * batch + bi;
    if (live) {
      load4(pk + row * row_len + g * D + c0, r.k);
      load4(pv + row * row_len + g * D + c0, r.v);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) r.k[c] = r.v[c] = 0.f;
    }
    r.k_s = (live && k_s != nullptr) ? k_s[row] : 1.f;
    r.v_s = (live && v_s != nullptr) ? v_s[row] : 1.f;
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
      r.bias[hh] = (live && hh / heads_per_kv == g) ? bias[(size_t)hh * cap + j] : 0.f;
  };

  // every group of a warp runs the same number of iterations, so the
  // shuffles below always see all 32 lanes
  Row<H> cur, nxt;
  fetch(group, cur);
  for (int u0 = 0; u0 < n_units; u0 += kGroups) {
    const int u = u0 + group;
    fetch(u + kGroups, nxt);  // in flight during this row's math
    const bool live = u < n_units;
    const int g = live ? u % kvh : 0;
#pragma unroll
    for (int hh = 0; hh < H; ++hh) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) dot = fmaf(qr[hh][c], cur.k[c], dot);
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (!live || hh / heads_per_kv != g) continue;
      const float s = dot * cur.k_s + cur.bias[hh];
      const float m_new = fmaxf(m[hh], s);
      const float alpha = expf(m[hh] - m_new);
      const float p = expf(s - m_new);
      l[hh] = l[hh] * alpha + p;
      const float pw = p * cur.v_s;
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[hh][c] = fmaf(pw, cur.v[c], acc[hh][c] * alpha);
      m[hh] = m_new;
    }
    cur = nxt;
  }

  // merge the lane groups of this block into its split's state
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    if (c0 == 0) {
      group_m[group][hh] = m[hh];
      group_l[group][hh] = l[hh];
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) group_acc[group][hh][c0 + c] = acc[hh][c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < H * D; t += kThreads) {
    const int hh = t / D, c = t % D;
    float mx = kMaskValue;
    for (int gi = 0; gi < kGroups; ++gi) mx = fmaxf(mx, group_m[gi][hh]);
    float lsum = 0.f, a = 0.f;
    for (int gi = 0; gi < kGroups; ++gi) {
      const float w = expf(group_m[gi][hh] - mx);
      lsum = fmaf(group_l[gi][hh], w, lsum);
      a = fmaf(group_acc[gi][hh][c], w, a);
    }
    split_acc[t] = a;
    if (c == 0) {
      split_m[hh] = mx;
      split_l[hh] = lsum;
    }
  }

  // block 0 merges the splits, in split order, from distributed shared memory
  cluster.sync();
  if (split == 0) {
    for (int t = threadIdx.x; t < H * D; t += kThreads) {
      const int hh = t / D, c = t % D;
      float mx = kMaskValue;
      for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, cluster.map_shared_rank(split_m, s)[hh]);
      float lsum = 0.f, a = 0.f;
      for (int s = 0; s < n_splits; ++s) {
        const float w = expf(cluster.map_shared_rank(split_m, s)[hh] - mx);
        lsum = fmaf(cluster.map_shared_rank(split_l, s)[hh], w, lsum);
        a = fmaf(cluster.map_shared_rank(split_acc, s)[t], w, a);
      }
      const float safe_l = lsum == 0.f ? 1.f : lsum;
      o[((size_t)bi * H + hh) * D + c] = a / safe_l;
      if (c == 0) lse[(size_t)bi * H + hh] = mx + logf(safe_l);
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

template <typename T, int D, int H>
int launch(const float* q, const void* pk, const void* pv, const float* bias, const float* k_s,
           const float* v_s, float* o, float* lse, int b, int kvh, int cap, int n_valid,
           int n_splits, int slots_per_split, cudaStream_t stream) {
  auto* kernel = prefix_attend_cluster<T, D, H>;
  if (n_splits > kMaxPortableCluster) {
    static const cudaError_t allowed =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_splits, b, 1);
  config.blockDim = dim3(threads_for(D), 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, q, static_cast<const T*>(pk),
                                 static_cast<const T*>(pv), bias, k_s, v_s, o, lse, b, kvh, cap,
                                 n_valid, slots_per_split);
}

template <typename T, int D>
int launch_heads(int h, const float* q, const void* pk, const void* pv, const float* bias,
                 const float* k_s, const float* v_s, float* o, float* lse, int b, int kvh,
                 int cap, int n_valid, int n_splits, int slots_per_split, cudaStream_t stream) {
  switch (h) {
    case 1:
      return launch<T, D, 1>(q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid, n_splits,
                             slots_per_split, stream);
    case 2:
      return launch<T, D, 2>(q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid, n_splits,
                             slots_per_split, stream);
    case 4:
      return launch<T, D, 4>(q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid, n_splits,
                             slots_per_split, stream);
    case 8:
      return launch<T, D, 8>(q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid, n_splits,
                             slots_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_dtype(int dtype, int h, const float* q, const void* pk, const void* pv,
                 const float* bias, const float* k_s, const float* v_s, float* o, float* lse,
                 int b, int kvh, int cap, int n_valid, int n_splits, int slots_per_split,
                 cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_heads<float, D>(h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid,
                                    n_splits, slots_per_split, stream);
    case 1:
      return launch_heads<__nv_bfloat16, D>(h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap,
                                            n_valid, n_splits, slots_per_split, stream);
    case 2:
      return launch_heads<int8_t, D>(h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid,
                                     n_splits, slots_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, h, d) fp32, scale folded in, d in {16, 32, 64, 128}, h in {1, 2, 4,
// 8}; pk, pv:
// (cap, b, kvh * d) of `dtype` (0 fp32, 1 bf16, 2 int8), kvh in {1, h};
// bias: (h, cap) fp32; k_s, v_s: (cap, b) fp32 row scales or null; o:
// (b, h, d), lse: (b, h). Slot j < n_valid goes to split j / slots_per_split;
// n_splits <= 16 blocks form one cluster per batch row. All contiguous, rows
// 16-byte aligned. Returns the CUDA error code of the launch.
extern "C" int sp_prefix_attend(const float* q, const void* pk, const void* pv,
                                const float* bias, const float* k_s, const float* v_s, float* o,
                                float* lse, int b, int h, int kvh, int d, int cap, int n_valid,
                                int n_splits, int slots_per_split, int dtype, void* stream) {
  if ((kvh != 1 && kvh != h) || n_splits < 1 || n_splits > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_dtype<16>(dtype, h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid,
                              n_splits, slots_per_split, s);
    case 32:
      return launch_dtype<32>(dtype, h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid,
                              n_splits, slots_per_split, s);
    case 64:
      return launch_dtype<64>(dtype, h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid,
                              n_splits, slots_per_split, s);
    case 128:
      return launch_dtype<128>(dtype, h, q, pk, pv, bias, k_s, v_s, o, lse, b, kvh, cap, n_valid,
                               n_splits, slots_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

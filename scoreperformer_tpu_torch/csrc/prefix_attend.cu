// Decode attention over the frozen prefix cache, split across blocks (flash
// decoding): one query row per (batch, head) against the prefix rows written
// so far, with an additive bias, giving o and the logsumexp for an outside
// combine with the fresh chunk's attention.
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
// flagship), so the kernel is bound by the bytes of the cache it reads:
// 256 B a row in fp32 at d = 64, 128 B in bf16, 64 B in int8.
//
// Design. The TPU kernel put the batch on the 128 lanes and needed the cache
// relaid as (cap, d, b); here the time-major cache is read as it lies. A row
// (slot j, batch b, KV head g) is d contiguous elements, loaded by a group of
// d/4 lanes, 4 elements (16 B in fp32) a lane, so one warp reads 2 (d = 64)
// or 4 (d = 32) rows at a time, converting bf16 or int8 to fp32 in
// registers. All h query heads of the batch row live in the same block: each
// lane keeps q, the running max, sum and its 4 columns of the output for
// every head, so with one KV head each row is read once for all heads. The
// slots are split across blocks (grid: splits x b) so that the grid fills
// the 132 SMs even at b = 1; each block merges its lane groups' states in
// shared memory and writes one (m, l, acc) per head, and a second small
// kernel merges the splits into o and lse. No atomics: repeated runs give
// the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeads = 8;
constexpr int kVec = 4;  // elements a lane loads from a row
constexpr float kMaskValue = -1e9f;
constexpr int kMergeThreads = 256;

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

// One split of the slots of one batch row: (m, l, acc) per head.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    prefix_attend_split(const float* __restrict__ q, const T* __restrict__ pk,
                        const T* __restrict__ pv, const float* __restrict__ bias,
                        const float* __restrict__ k_s, const float* __restrict__ v_s,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int batch, int h, int kvh, int cap,
                        int n_valid, int slots_per_split) {
  constexpr int kLanesPerRow = D / kVec;            // 16 at d = 64, 8 at d = 32
  constexpr int kGroups = kThreads / kLanesPerRow;  // rows in flight per block
  __shared__ float sm_m[kGroups][kMaxHeads];
  __shared__ float sm_l[kGroups][kMaxHeads];
  __shared__ float sm_acc[kGroups][kMaxHeads][D];

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int bi = blockIdx.y;
  const int group = threadIdx.x / kLanesPerRow;
  const int c0 = (threadIdx.x % kLanesPerRow) * kVec;
  const int heads_per_kv = h / kvh;
  const int row_len = kvh * D;

  float qr[kMaxHeads][kVec], acc[kMaxHeads][kVec], m[kMaxHeads], l[kMaxHeads];
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    m[hh] = kMaskValue;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      acc[hh][c] = 0.f;
      qr[hh][c] = hh < h ? q[((size_t)bi * h + hh) * D + c0 + c] : 0.f;
    }
  }

  const int j0 = split * slots_per_split;
  const int j1 = min(n_valid, j0 + slots_per_split);
  const int n_units = max(0, j1 - j0) * kvh;  // (slot, KV head) rows
  // every group of a warp runs the same number of iterations, so the
  // shuffles below always see all 32 lanes
  for (int u0 = 0; u0 < n_units; u0 += kGroups) {
    const int u = u0 + group;
    const bool live = u < n_units;
    const int j = j0 + (live ? u / kvh : 0);
    const int g = live ? u % kvh : 0;
    const size_t row = (size_t)j * batch + bi;
    float kr[kVec], vr[kVec];
    if (live) {
      load4(pk + row * row_len + g * D + c0, kr);
      load4(pv + row * row_len + g * D + c0, vr);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) kr[c] = vr[c] = 0.f;
    }
    const float ks = (live && k_s != nullptr) ? k_s[row] : 1.f;
    const float vs = (live && v_s != nullptr) ? v_s[row] : 1.f;
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      if (hh >= h) break;  // uniform across the block
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) dot = fmaf(qr[hh][c], kr[c], dot);
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (!live || hh / heads_per_kv != g) continue;
      const float s = dot * ks + bias[(size_t)hh * cap + j];
      const float m_new = fmaxf(m[hh], s);
      const float alpha = expf(m[hh] - m_new);
      const float p = expf(s - m_new);
      l[hh] = l[hh] * alpha + p;
      const float pw = p * vs;
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[hh][c] = fmaf(pw, vr[c], acc[hh][c] * alpha);
      m[hh] = m_new;
    }
  }

  // merge the lane groups of this block
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (hh >= h) break;
    if (c0 == 0) {
      sm_m[group][hh] = m[hh];
      sm_l[group][hh] = l[hh];
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) sm_acc[group][hh][c0 + c] = acc[hh][c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < h * D; t += kThreads) {
    const int hh = t / D, c = t % D;
    float mx = kMaskValue;
    for (int gi = 0; gi < kGroups; ++gi) mx = fmaxf(mx, sm_m[gi][hh]);
    float lsum = 0.f, a = 0.f;
    for (int gi = 0; gi < kGroups; ++gi) {
      const float w = expf(sm_m[gi][hh] - mx);
      lsum = fmaf(sm_l[gi][hh], w, lsum);
      a = fmaf(sm_acc[gi][hh][c], w, a);
    }
    const size_t part = ((size_t)bi * n_splits + split) * h + hh;
    part_acc[part * D + c] = a;
    if (c == 0) {
      part_m[part] = mx;
      part_l[part] = lsum;
    }
  }
}

// Merge the splits of each (batch, head) into o and lse.
__global__ void __launch_bounds__(kMergeThreads)
    prefix_attend_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
                        const float* __restrict__ part_acc, float* __restrict__ o,
                        float* __restrict__ lse, int h, int d, int n_splits) {
  const int bi = blockIdx.x;
  for (int t = threadIdx.x; t < h * d; t += kMergeThreads) {
    const int hh = t / d, c = t % d;
    float mx = kMaskValue;
    for (int s = 0; s < n_splits; ++s)
      mx = fmaxf(mx, part_m[((size_t)bi * n_splits + s) * h + hh]);
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t part = ((size_t)bi * n_splits + s) * h + hh;
      const float w = expf(part_m[part] - mx);
      lsum = fmaf(part_l[part], w, lsum);
      a = fmaf(part_acc[part * d + c], w, a);
    }
    const float safe_l = lsum == 0.f ? 1.f : lsum;
    o[((size_t)bi * h + hh) * d + c] = a / safe_l;
    if (c == 0) lse[(size_t)bi * h + hh] = mx + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const float* q, const void* pk, const void* pv, const float* bias, const float* k_s,
           const float* v_s, float* o, float* lse, float* part_m, float* part_l,
           float* part_acc, int b, int h, int kvh, int cap, int n_valid, int n_splits,
           int slots_per_split, cudaStream_t stream) {
  prefix_attend_split<T, D><<<dim3(n_splits, b), kThreads, 0, stream>>>(
      q, static_cast<const T*>(pk), static_cast<const T*>(pv), bias, k_s, v_s, part_m, part_l,
      part_acc, b, h, kvh, cap, n_valid, slots_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prefix_attend_merge<<<b, kMergeThreads, 0, stream>>>(part_m, part_l, part_acc, o, lse, h, D,
                                                       n_splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dtype(int dtype, const float* q, const void* pk, const void* pv, const float* bias,
                 const float* k_s, const float* v_s, float* o, float* lse, float* part_m,
                 float* part_l, float* part_acc, int b, int h, int kvh, int cap, int n_valid,
                 int n_splits, int slots_per_split, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<float, D>(q, pk, pv, bias, k_s, v_s, o, lse, part_m, part_l, part_acc, b,
                              h, kvh, cap, n_valid, n_splits, slots_per_split, stream);
    case 1:
      return launch<__nv_bfloat16, D>(q, pk, pv, bias, k_s, v_s, o, lse, part_m, part_l,
                                      part_acc, b, h, kvh, cap, n_valid, n_splits,
                                      slots_per_split, stream);
    case 2:
      return launch<int8_t, D>(q, pk, pv, bias, k_s, v_s, o, lse, part_m, part_l, part_acc, b,
                               h, kvh, cap, n_valid, n_splits, slots_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, h, d) fp32, scale folded in; pk, pv: (cap, b, kvh * d) of `dtype`
// (0 fp32, 1 bf16, 2 int8), kvh in {1, h}, h <= 8; bias: (h, cap) fp32;
// k_s, v_s: (cap, b) fp32 row scales or null; o: (b, h, d), lse: (b, h);
// part_m, part_l: (b, n_splits, h) and part_acc: (b, n_splits, h, d) scratch.
// Slot j < n_valid goes to split j / slots_per_split. All contiguous, rows
// 16-byte aligned. Returns the CUDA error code of the launches.
extern "C" int sp_prefix_attend(const float* q, const void* pk, const void* pv,
                                const float* bias, const float* k_s, const float* v_s, float* o,
                                float* lse, float* part_m, float* part_l, float* part_acc, int b,
                                int h, int kvh, int d, int cap, int n_valid, int n_splits,
                                int slots_per_split, int dtype, void* stream) {
  if (h > kMaxHeads || h % kvh != 0 || n_splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dtype<32>(dtype, q, pk, pv, bias, k_s, v_s, o, lse, part_m, part_l,
                              part_acc, b, h, kvh, cap, n_valid, n_splits, slots_per_split, s);
    case 64:
      return launch_dtype<64>(dtype, q, pk, pv, bias, k_s, v_s, o, lse, part_m, part_l,
                              part_acc, b, h, kvh, cap, n_valid, n_splits, slots_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// In-place KV-cache row writes for the decode loop: one (cache, rows) write,
// or a layer's K and V writes at the same start in one launch.
//
// Replaces: scoreperformer_tpu/ops/kv_cache.py::_make_update_kernel.kernel, the
// Pallas DMA that `write_kv` launches on the TPU (twice per layer and decode
// step, at scoreperformer_tpu/models/attention.py:186-187 and :333-334).
//
// Bound on the H100: bytes. A write reads n*b*kv elements of its rows once
// and writes them once into the cache; it does no arithmetic. At the decode
// step's shapes (one row of b*kv elements a layer: 256 B at the render, 32 KB
// in a served batch of 128) the launch itself, not the bytes, is what the
// card spends, so a layer's K and V go in one launch.
//
// Design (rebuilt for Hopper): the grid is sized to the work, one block row
// (grid y) a write, 512 units a block (chip_probe_decode.py: 1, 4 or 8
// units a thread were no faster at the decode step's shapes or at 2 MB).
// Each thread first issues the loads of its kUnits 16-byte units of the
// source rows, which do not depend on the start row, then reads
// the start from device memory (so the launch needs no host sync and a CUDA
// graph can capture it), then stores: the start's latency overlaps the
// source loads'. As in jax.lax.dynamic_update_slice, a negative start counts
// from the end (adds cap), and the start is then clamped to [0, cap - n]. A
// unit is 16 bytes of the wider of the two types, so rows cast from fp32 to
// bf16 (or back) move 4 elements a unit: 16 B read and 8 written. Rows whose
// length is not a multiple of a unit, or that are not aligned to one, move
// one element a unit. Any b*kv is accepted: the TPU kernel's 2048-element
// tiling rule has no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kThreads = 256;
constexpr int kUnits = 2;  // units a thread has in flight

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// the type of one load or store of `Bytes` bytes
template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};
template <>
struct Raw<2> {
  using type = uint16_t;
};

struct RowWrite {
  void* cache;      // (cap, row) of the cache's type
  const void* src;  // (n, row) of the source's type
};

__device__ __forceinline__ int64_t clamped_start(const int64_t* index, int64_t cap, int64_t n) {
  int64_t start = *index;
  start = start < 0 ? start + cap : start;  // negative starts count from the end
  start = start < 0 ? 0 : start;
  return start > cap - n ? cap - n : start;
}

// rows [start, start + n) of write blockIdx.y's cache = its source rows; a
// row is `row_units` units of E elements
template <typename Tin, typename Tout, int E>
__global__ void __launch_bounds__(kThreads)
    write_rows(RowWrite w0, RowWrite w1, const int64_t* __restrict__ index, int64_t cap, int64_t n,
               int64_t row_units) {
  using In = typename Raw<sizeof(Tin) * E>::type;
  using Out = typename Raw<sizeof(Tout) * E>::type;
  const RowWrite w = blockIdx.y == 0 ? w0 : w1;
  const In* __restrict__ src = static_cast<const In*>(w.src);
  const int64_t total = n * row_units;
  const int64_t first = (int64_t)blockIdx.x * kUnits * kThreads + threadIdx.x;
  In v[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int64_t i = first + (int64_t)u * kThreads;
    if (i < total) v[u] = src[i];
  }
  Out* __restrict__ dst = static_cast<Out*>(w.cache) + clamped_start(index, cap, n) * row_units;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int64_t i = first + (int64_t)u * kThreads;
    if (i >= total) continue;
    if constexpr (std::is_same<Tin, Tout>::value) {
      dst[i] = v[u];
    } else {
      Out out;
      const Tin* x = reinterpret_cast<const Tin*>(&v[u]);
      Tout* y = reinterpret_cast<Tout*>(&out);
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = from_float<Tout>(to_float(x[e]));
      dst[i] = out;
    }
  }
}

template <typename Tin, typename Tout, int E>
int launch_units(RowWrite w0, RowWrite w1, int writes, const int64_t* index, int64_t cap,
                 int64_t n, int64_t row_units, cudaStream_t stream) {
  const int64_t per_block = (int64_t)kThreads * kUnits;
  const int64_t blocks = (n * row_units + per_block - 1) / per_block;
  write_rows<Tin, Tout, E><<<dim3((unsigned)blocks, writes, 1), kThreads, 0, stream>>>(
      w0, w1, index, cap, n, row_units);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch(RowWrite w0, RowWrite w1, int writes, const int64_t* index, int64_t cap, int64_t n,
           int64_t row, cudaStream_t stream) {
  constexpr int kWide = 16 / (sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  bool wide = row % kWide == 0;
  for (int k = 0; k < writes; ++k) {
    const RowWrite& w = k == 0 ? w0 : w1;
    wide = wide && (uintptr_t)w.src % (kWide * sizeof(Tin)) == 0 &&
           (uintptr_t)w.cache % (kWide * sizeof(Tout)) == 0;
  }
  if (wide) return launch_units<Tin, Tout, kWide>(w0, w1, writes, index, cap, n, row / kWide, stream);
  return launch_units<Tin, Tout, 1>(w0, w1, writes, index, cap, n, row, stream);
}

}  // namespace

// `writes` (1 or 2) row writes at one start: cache0/cache1: (cap, row) of
// cache_dtype; src0/src1: (n, row) of src_dtype (cache1 and src1 are unused
// when writes is 1); index: one int64 on the device. Returns the CUDA error
// code of the launch (0 = ok).
extern "C" int sp_write_kv(void* cache0, const void* src0, void* cache1, const void* src1,
                           int writes, const void* index, int64_t cap, int64_t n, int64_t row,
                           int cache_dtype, int src_dtype, void* stream) {
  if (writes < 1 || writes > 2 || n < 0 || n > cap || row < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;  // nothing to write
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* idx = static_cast<const int64_t*>(index);
  const RowWrite w0 = {cache0, src0}, w1 = {writes == 2 ? cache1 : cache0, writes == 2 ? src1 : src0};
  if (cache_dtype == kFloat32 && src_dtype == kFloat32)
    return launch<float, float>(w0, w1, writes, idx, cap, n, row, s);
  if (cache_dtype == kFloat32 && src_dtype == kBFloat16)
    return launch<__nv_bfloat16, float>(w0, w1, writes, idx, cap, n, row, s);
  if (cache_dtype == kBFloat16 && src_dtype == kFloat32)
    return launch<float, __nv_bfloat16>(w0, w1, writes, idx, cap, n, row, s);
  if (cache_dtype == kBFloat16 && src_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(w0, w1, writes, idx, cap, n, row, s);
  return (int)cudaErrorInvalidValue;
}

// In-place KV-cache row write for the decode loop.
//
// Replaces: scoreperformer_tpu/ops/kv_cache.py::_make_update_kernel.kernel, the
// Pallas DMA that `write_kv` launches on the TPU.
//
// Bound on the H100: bytes. The write reads n*b*kv elements of `new` once and
// writes them once into the cache; it does no arithmetic. At the render's
// shape (one row of 64 floats per layer and step) the launch itself, not the
// 512 bytes, is what the card spends.
//
// Design: the start row is read from device memory by every thread, so the
// launch needs no host sync and a CUDA graph can capture it. As in
// jax.lax.dynamic_update_slice, a negative start counts from the end (adds
// cap), and the start is then clamped to [0, cap - n]. Rows of the same
// type whose payload is a multiple of 16 bytes move as 16-byte vectors (every
// start row is then 16-byte aligned); other rows, and rows cast from fp32 to
// bf16 or back, move one element per thread. Any b*kv is accepted: the TPU
// kernel's 2048-element tiling rule has no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

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

__device__ __forceinline__ int64_t clamped_start(const int64_t* index, int64_t cap, int64_t n) {
  int64_t start = *index;
  start = start < 0 ? start + cap : start;  // negative starts count from the end
  start = start < 0 ? 0 : start;
  return start > cap - n ? cap - n : start;
}

template <typename Tin, typename Tout>
__global__ void write_rows(Tout* __restrict__ cache, const Tin* __restrict__ src,
                           const int64_t* __restrict__ index, int64_t cap, int64_t n,
                           int64_t row) {
  Tout* dst = cache + clamped_start(index, cap, n) * row;
  const int64_t total = n * row;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = from_float<Tout>(to_float(src[i]));
  }
}

// Same type, row bytes a multiple of 16: copy 16-byte vectors.
__global__ void write_rows_vec16(uint4* __restrict__ cache, const uint4* __restrict__ src,
                                 const int64_t* __restrict__ index, int64_t cap, int64_t n,
                                 int64_t row_vecs) {
  uint4* dst = cache + clamped_start(index, cap, n) * row_vecs;
  const int64_t total = n * row_vecs;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = src[i];
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

int blocks_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

}  // namespace

// cache: (cap, row) of cache_dtype; src: (n, row) of src_dtype; index: one
// int64 on the device. Returns the CUDA error code of the launch (0 = ok).
extern "C" int sp_write_kv(void* cache, const void* src, const void* index, int64_t cap,
                           int64_t n, int64_t row, int cache_dtype, int src_dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* idx = static_cast<const int64_t*>(index);
  const int64_t elem = cache_dtype == kFloat32 ? 4 : 2;
  const bool aligned = ((uintptr_t)cache % 16 == 0) && ((uintptr_t)src % 16 == 0);
  if (cache_dtype == src_dtype && (row * elem) % 16 == 0 && aligned) {
    const int64_t row_vecs = row * elem / 16;
    write_rows_vec16<<<blocks_for(n * row_vecs), kThreads, 0, s>>>(
        static_cast<uint4*>(cache), static_cast<const uint4*>(src), idx, cap, n, row_vecs);
  } else if (cache_dtype == kFloat32 && src_dtype == kFloat32) {
    write_rows<float, float><<<blocks_for(n * row), kThreads, 0, s>>>(
        static_cast<float*>(cache), static_cast<const float*>(src), idx, cap, n, row);
  } else if (cache_dtype == kFloat32 && src_dtype == kBFloat16) {
    write_rows<__nv_bfloat16, float><<<blocks_for(n * row), kThreads, 0, s>>>(
        static_cast<float*>(cache), static_cast<const __nv_bfloat16*>(src), idx, cap, n, row);
  } else if (cache_dtype == kBFloat16 && src_dtype == kFloat32) {
    write_rows<float, __nv_bfloat16><<<blocks_for(n * row), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(cache), static_cast<const float*>(src), idx, cap, n, row);
  } else if (cache_dtype == kBFloat16 && src_dtype == kBFloat16) {
    write_rows<__nv_bfloat16, __nv_bfloat16><<<blocks_for(n * row), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(cache), static_cast<const __nv_bfloat16*>(src), idx, cap,
        n, row);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

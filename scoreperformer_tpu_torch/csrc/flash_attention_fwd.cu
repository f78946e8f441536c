// Flash-attention forward with ALiBi generated in the kernel (fp32).
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_kernel, the
// Pallas forward that `_flash_forward` launches for `flash_attention_alibi`.
//
// Bound on the H100: at the render's encoder shapes (h=4, d=64, one KV head,
// t = notes) the work is 4*h*t*t*d fp32 operations over a few MB of q/k/v,
// so it sits on the fp32 (non-tensor-core) side of the roofline; at batch 1
// it is too small to fill 132 SMs, and the launch and the tile loop's
// latency dominate. The kernel computes in full fp32, as the JAX package's
// "highest" precision does; bf16 tensor-core math is later work.
//
// Head dims 32 and 64 are built; 128 would need more than the 48 KB of static
// shared memory this layout takes.
//
// Design: one block of 4 warps per (batch*head, tile of 32 query rows); each
// warp owns 8 rows and keeps their running max, sum and 64-wide (d/32 per
// lane) accumulators in registers. Keys and values stream through shared
// memory in tiles of 32, one key per lane: a lane dots its key against the 8
// query rows (queries are broadcast from shared memory), the warp reduces the
// row max and sum with shuffles, and the probabilities go through shared
// memory to the P.V product, where each lane owns d/32 output columns. The
// (h, t, t) bias and score tensors never reach device memory. As in the TPU
// kernel: q is scaled before the dot, the bias is -slope*|i-j|, masked scores
// are -1e30, l is clamped at 1e-30, causal tiles past the diagonal are
// skipped. Keys past t are excluded in the kernel (no padding by the caller),
// and with one KV head every query head reads KV head 0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ slopes,
              const uint8_t* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ lse, int h, int hk, int tq, int tk, int causal,
              float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  __shared__ float qs[kBlockQ][D];
  __shared__ float ks[kBlockK][D + 1];  // +1: lanes read distinct rows at one column
  __shared__ float vs[kBlockK][D];
  __shared__ float ps[kWarps][kRowsPerWarp][kBlockK];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int head = bh % h;
  const size_t kv_off = ((size_t)b * hk + (hk == 1 ? 0 : head)) * tk * D;
  const float* qp = q + (size_t)bh * tq * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;
  const uint8_t* mp = mask + (size_t)b * tk;
  const float slope = slopes[head];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int row0 = warp * kRowsPerWarp;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r][c] = (q0 + r < tq) ? qp[(size_t)(q0 + r) * D + c] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  int num_tiles = (tk + kBlockK - 1) / kBlockK;
  if (causal) num_tiles = min(num_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // the previous tile's reads (and the q load) are done
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < tk;
      ks[r][c] = in ? kp[(size_t)(k0 + r) * D + c] : 0.f;
      vs[r][c] = in ? vp[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool in_range = kj < tk;
    const bool key_ok = in_range && mp[kj] != 0;

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qs[row0 + r][c], kc, s[r]);
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      float sr = s[r] - slope * fabsf((float)(kj - qi));
      sr = (key_ok && (!causal || kj <= qi)) ? sr : kMaskValue;
      sr = in_range ? sr : -INFINITY;  // keys past t take no part at all
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      ps[warp][r][lane] = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = ps[warp][r][j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* op = out + ((size_t)bh * tq + qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) op[lane + 32 * c] = acc[r][c] / lc;
    if (lse != nullptr && lane == 0) lse[(size_t)bh * tq + qi] = m[r] + logf(lc);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* slopes,
           const uint8_t* mask, float* out, float* lse, int b, int h, int hk, int tq, int tk,
           int causal, float scale, cudaStream_t stream) {
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  flash_fwd<D><<<grid, kWarps * 32, 0, stream>>>(q, k, v, slopes, mask, out, lse, h, hk, tq,
                                                 tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (b, h, tq, d); k, v: (b, hk, tk, d) with hk in {1, h}; slopes: (h,);
// mask: (b, tk) bytes, nonzero = valid key; out: (b, h, tq, d); lse: (b, h, tq)
// or null. All fp32 and contiguous. Returns the CUDA error code of the launch.
extern "C" int sp_flash_attention_fwd(const float* q, const float* k, const float* v,
                                      const float* slopes, const uint8_t* mask, float* out,
                                      float* lse, int b, int h, int hk, int tq, int tk, int d,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, slopes, mask, out, lse, b, h, hk, tq, tk, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention backward with ALiBi generated in the kernel (fp32): dK/dV
// and dQ/dslope, P recomputed from the forward's logsumexp.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// and ::_flash_bwd_dq_kernel, the two Pallas kernels that
// `_flash_attention_bwd` launches inside the `jax.custom_vjp` of
// `flash_attention_alibi`.
//
// The math, per (batch, head), with s = (q*scale).k - slope*|i-j| masked to
// -1e30 and P = exp(s - lse):
//   dP = dO.V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (computed
//   outside, as the JAX code does);
//   dV = P^T.dO,  dK = dS^T.(q*scale),  dQ = scale * dS.K,
//   dslope = sum dS * (-|i-j|).
//
// Bound on the H100: at the flagship's training shapes (b=128, h=4, t=258,
// d=64, one KV head) each kernel does 4-8 d-long products per (query, key)
// pair in fp32 over a few tens of MB, so both sit on the fp32
// (non-tensor-core) side of the roofline. This first version computes in
// full fp32 on the CUDA cores, as the forward does; wgmma, TMA and bf16 are
// later work.
//
// Design. The Pallas kernels carry their sums across a sequential grid
// (`pl.when(qb == 0)` init, `+=` per step). Hopper blocks run in parallel, so
// each sum is a loop inside one block, and no block writes what another
// block writes: no atomics, and the results do not change from run to run.
// - dK/dV: one block of 4 warps per (batch, KV head, tile of 32 keys). It
//   keeps its keys' K and V in shared memory and loops over every query head
//   that reads that KV head (all h heads with one KV head, so the MQA head
//   sum happens in registers) and over the query tiles of 32 rows; with
//   `causal`, query tiles wholly above the diagonal are skipped. Warp w owns
//   keys 8w..8w+7 of the tile and lane l owns columns l, l+32, so each thread
//   keeps 8 x d/32 sums of dK and of dV in registers.
// - dQ/dslope: one block per (batch, head, tile of 32 query rows), looping
//   over key tiles (up to the diagonal with `causal`). Warp w owns rows
//   8w..8w+7, lane l owns columns l, l+32 of dQ. Each block writes its part
//   of the slope gradient to a (b, h, query tiles) scratch tensor that the
//   caller sums, as the JAX code sums over the batch outside the kernel.
// In both, the (query row, key) scores are computed one key per lane, eight
// rows per warp, in the forward kernel's order of operations, so P matches
// the forward's. Keys past t and query rows past t take no part (no padding
// by the caller); masked keys are -1e30 as in the forward.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per tile
constexpr int kBlockK = 32;                      // keys per tile, one per lane
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The tiles both kernels keep in shared memory (41.7 KB at d=64).
template <int D>
struct Tiles {
  float q[kBlockQ][D];  // q * scale
  float dout[kBlockQ][D];
  float k[kBlockK][D + 1];  // +1: lanes read distinct rows at one column
  float v[kBlockK][D + 1];
  float p[kBlockQ][kBlockK + 1];
  float ds[kBlockQ][kBlockK + 1];
  float lse[kBlockQ];
  float delta[kBlockQ];
};

// rows [row0, row0 + 32) of a (rows, D) matrix into a shared tile with row
// stride LD, times `mul`; rows past `nrows` are zero
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int nrows,
                                          float mul) {
  for (int i = threadIdx.x; i < 32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = (row0 + r < nrows) ? src[(size_t)(row0 + r) * D + c] * mul : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_query_tile(Tiles<D>& sm, const float* q, const float* dout,
                                                const float* lse, const float* delta, int q0,
                                                int tq, float scale) {
  load_tile<D, D>(&sm.q[0][0], q, q0, tq, scale);
  load_tile<D, D>(&sm.dout[0][0], dout, q0, tq, 1.f);
  if (threadIdx.x < kBlockQ) {
    const int qi = q0 + threadIdx.x;
    sm.lse[threadIdx.x] = qi < tq ? lse[qi] : 0.f;
    sm.delta[threadIdx.x] = qi < tq ? delta[qi] : 0.f;
  }
}

// P and dS of this warp's 8 query rows against the lane's key of the tile at
// k0, into sm.p / sm.ds; returns the lane's part of sum dS * (-|i-j|).
template <int D>
__device__ __forceinline__ float scores(Tiles<D>& sm, const uint8_t* mask, float slope, int q0,
                                        int k0, int tq, int tk, int causal) {
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRowsPerWarp;
  const int kj = k0 + lane;
  const bool in_range = kj < tk;
  const bool key_ok = in_range && mask[kj] != 0;

  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float kc = sm.k[lane][c];
    const float vc = sm.v[lane][c];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(sm.q[row0 + r][c], kc, s[r]);
      dp[r] = fmaf(sm.dout[row0 + r][c], vc, dp[r]);
    }
  }

  float dslope = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    const float dist = fabsf((float)(kj - qi));
    float sr = s[r] - slope * dist;
    sr = (key_ok && (!causal || kj <= qi)) ? sr : kMaskValue;
    const float p = (in_range && qi < tq) ? expf(sr - sm.lse[row]) : 0.f;
    const float ds = p * (dp[r] - sm.delta[row]);
    sm.p[row][lane] = p;
    sm.ds[row][lane] = ds;
    dslope = fmaf(ds, -dist, dslope);
  }
  return dslope;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ slopes,
                  const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int tq, int tk,
                  int causal, float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  __shared__ Tiles<D> sm;

  const int bkv = blockIdx.y;  // batch * hk + KV head
  const int b = bkv / hk;
  const int kv_head = bkv % hk;
  const int k0 = blockIdx.x * kBlockK;
  const int lane = threadIdx.x % 32;
  const int key0 = (threadIdx.x / 32) * kRowsPerWarp;  // this warp's first key in the tile

  load_tile<D, D + 1>(&sm.k[0][0], k + (size_t)bkv * tk * D, k0, tk, 1.f);
  load_tile<D, D + 1>(&sm.v[0][0], v + (size_t)bkv * tk * D, k0, tk, 1.f);

  float acc_dk[kRowsPerWarp][kCols], acc_dv[kRowsPerWarp][kCols];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[j][c] = acc_dv[j][c] = 0.f;

  const int n_q_tiles = (tq + kBlockQ - 1) / kBlockQ;
  // causal: a query tile that ends before k0 sees none of these keys
  const int first_q_tile = causal ? k0 / kBlockQ : 0;
  const int head_begin = hk == 1 ? 0 : kv_head;
  const int head_end = hk == 1 ? h : kv_head + 1;
  const uint8_t* mp = mask + (size_t)b * tk;

  for (int head = head_begin; head < head_end; ++head) {
    const size_t bh = (size_t)b * h + head;
    const float slope = slopes[head];
    for (int qt = first_q_tile; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous tile's reads are done
      load_query_tile<D>(sm, q + bh * tq * D, dout + bh * tq * D, lse + bh * tq,
                         delta + bh * tq, q0, tq, scale);
      __syncthreads();
      scores<D>(sm, mp, slope, q0, k0, tq, tk, causal);
      __syncthreads();
      // dV[key] += P[row, key] dO[row];  dK[key] += dS[row, key] (q*scale)[row]
#pragma unroll 4
      for (int row = 0; row < kBlockQ; ++row) {
        float o[kCols], qv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          o[c] = sm.dout[row][lane + 32 * c];
          qv[c] = sm.q[row][lane + 32 * c];
        }
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float pj = sm.p[row][key0 + j];
          const float dsj = sm.ds[row][key0 + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_dv[j][c] = fmaf(pj, o[c], acc_dv[j][c]);
            acc_dk[j][c] = fmaf(dsj, qv[c], acc_dk[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int kj = k0 + key0 + j;
    if (kj >= tk) continue;
    const size_t off = ((size_t)bkv * tk + kj) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[off + lane + 32 * c] = acc_dk[j][c];
      dv[off + lane + 32 * c] = acc_dv[j][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ slopes,
                 const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, float* __restrict__ dslope_part, int h, int hk, int tq,
                 int tk, int causal, float scale) {
  constexpr int kCols = D / 32;
  __shared__ Tiles<D> sm;
  __shared__ float warp_dslope[kWarps];

  const int bh = blockIdx.y;  // batch * h + head
  const int b = bh / h;
  const int head = bh % h;
  const size_t kv_off = ((size_t)b * hk + (hk == 1 ? 0 : head)) * tk * D;
  const int q0 = blockIdx.x * kBlockQ;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = warp * kRowsPerWarp;
  const float slope = slopes[head];
  const uint8_t* mp = mask + (size_t)b * tk;

  load_query_tile<D>(sm, q + (size_t)bh * tq * D, dout + (size_t)bh * tq * D,
                     lse + (size_t)bh * tq, delta + (size_t)bh * tq, q0, tq, scale);

  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  float dslope = 0.f;

  int n_k_tiles = (tk + kBlockK - 1) / kBlockK;
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's reads (and the query tile's load) are done
    load_tile<D, D + 1>(&sm.k[0][0], k + kv_off, k0, tk, 1.f);
    load_tile<D, D + 1>(&sm.v[0][0], v + kv_off, k0, tk, 1.f);
    __syncthreads();
    dslope += scores<D>(sm, mp, slope, q0, k0, tq, tk, causal);
    __syncwarp();  // each warp reads back only its own rows of dS
    // dQ[row] += dS[row, key] K[key]
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float kc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kc[c] = sm.k[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = sm.ds[row0 + r][j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsj, kc[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= tq) continue;
    float* dp = dq + ((size_t)bh * tq + qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dp[lane + 32 * c] = acc[r][c] * scale;
  }

  dslope = warp_sum(dslope);
  if (lane == 0) warp_dslope[warp] = dslope;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_dslope[w];
    dslope_part[(size_t)bh * gridDim.x + blockIdx.x] = total;
  }
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* slopes,
               const uint8_t* mask, const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int b, int h, int hk, int tq, int tk, int causal,
               float scale, cudaStream_t stream) {
  const dim3 grid((tk + kBlockK - 1) / kBlockK, b * hk);
  flash_bwd_dkv<D><<<grid, kThreads, 0, stream>>>(q, k, v, slopes, mask, dout, lse, delta, dk,
                                                  dv, h, hk, tq, tk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* slopes,
              const uint8_t* mask, const float* dout, const float* lse, const float* delta,
              float* dq, float* dslope_part, int b, int h, int hk, int tq, int tk, int causal,
              float scale, cudaStream_t stream) {
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  flash_bwd_dq<D><<<grid, kThreads, 0, stream>>>(q, k, v, slopes, mask, dout, lse, delta, dq,
                                                 dslope_part, h, hk, tq, tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout: (b, h, tq, d); k, v: (b, hk, tk, d) with hk in {1, h}; slopes: (h,);
// mask: (b, tk) bytes, nonzero = valid key; lse, delta: (b, h, tq); dk, dv:
// (b, hk, tk, d), written whole (with hk = 1, summed over the h query heads).
// All fp32 and contiguous. Returns the CUDA error code of the launch.
extern "C" int sp_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                          const float* slopes, const uint8_t* mask,
                                          const float* dout, const float* lse,
                                          const float* delta, float* dk, float* dv, int b, int h,
                                          int hk, int tq, int tk, int d, int causal, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dkv<32>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk,
                            causal, scale, s);
    case 64:
      return launch_dkv<64>(q, k, v, slopes, mask, dout, lse, delta, dk, dv, b, h, hk, tq, tk,
                            causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As above; dq: (b, h, tq, d); dslope_part: (b, h, ceil(tq / 32)), each
// block's part of sum dS * (-|i-j|), for the caller to sum over b and tiles.
extern "C" int sp_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                         const float* slopes, const uint8_t* mask,
                                         const float* dout, const float* lse, const float* delta,
                                         float* dq, float* dslope_part, int b, int h, int hk,
                                         int tq, int tk, int d, int causal, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk,
                           tq, tk, causal, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, slopes, mask, dout, lse, delta, dq, dslope_part, b, h, hk,
                           tq, tk, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

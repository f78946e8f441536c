// The one-pass flash-attention backward: csrc/flash_attention_bwd_bf16.cu's
// dK/dV and dQ/dslope kernels with P^T, dS^T and dS in one bf16 term
// (kTerms = 1), on bf16 operands with bf16 gradients, or on fp32 operands
// with fp32 gradients, built as a library of its own so that its instances
// compile beside the others.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (:135) and ::_flash_bwd_dq_kernel (:192) at their "default" precision, the
// one JAX's model runs: on the TPU every dot's operands are rounded to bf16
// and the products summed in fp32 (one MXU pass). S = (bf16(q).bf16(k)) *
// scale (`_recompute_p`), dV = bf16(P)^T.bf16(dO), dP = bf16(dO).bf16(v)^T,
// dS = P * (dP - delta) in fp32, dK = (bf16(dS)^T.bf16(q)) * scale, dQ =
// (bf16(dS).bf16(k)) * scale, dslope = sum dS * (-|i-j|) from the unrounded
// dS; P and dS rounded to nearest even from the fp32 accumulator.
//
// fp32 operands are read in fp32 and rounded to bf16 in the kernel, to
// nearest even, the bits of torch's `.to(torch.bfloat16)`: TMA lands each
// tile's fp32 rows in a staging area and the threads round them into the
// swizzled bf16 tile that wgmma reads (the bf16 backward's header, "fp32
// operands", gives the shared-memory plan).
//
// Bound on the H100: dK/dV 4 bf16 passes over the (query, key) pairs (S,
// dP, dV, dK), dQ/dslope 3 (S, dP, dQ), at 989 TFLOP/s, against the bytes:
// q, k, v and dO read once in their dtype, lse and delta, the gradients
// written once in theirs (3.35 TB/s). On fp32 operands at the flagship's
// shapes the bytes bound both: 0.030 and 0.035 ms at b 128, h 4, one KV
// head, d 64, t 258.
//
// Entry points: sp_flash_attention_bwd_dkv_one_pass and
// sp_flash_attention_bwd_dq_one_pass (bf16 operands and gradients), and
// their `_f32` twins (fp32 operands and gradients), the arguments of the
// `_bf16` entries.
#define SP_FLASH_ONE_PASS
#include "flash_attention_bwd_bf16.cu"

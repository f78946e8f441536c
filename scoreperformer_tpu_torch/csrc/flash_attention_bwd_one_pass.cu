// The one-pass flash-attention backward: csrc/flash_attention_bwd_bf16.cu's
// dK/dV and dQ/dslope kernels with P^T, dS^T and dS in one bf16 term
// (kTerms = 1), the gradients in bf16 or fp32, built as a library of its
// own so that its instances compile beside the others.
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
// Bound on the H100: dK/dV 4 bf16 passes over the (query, key) pairs (S,
// dP, dV, dK), dQ/dslope 3 (S, dP, dQ), at 989 TFLOP/s; the design is the
// bf16 backward's (its header).
//
// Entry points: sp_flash_attention_bwd_dkv_one_pass and
// sp_flash_attention_bwd_dq_one_pass (gradients bf16), and their `_f32`
// twins (fp32), the arguments of the `_bf16` entries.
#define SP_FLASH_ONE_PASS
#include "flash_attention_bwd_bf16.cu"

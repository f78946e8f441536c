// The one-pass flash-attention forward: csrc/flash_attention_fwd_bf16.cu's
// kernel with P in one bf16 term (kTerms = 1), o in bf16 or fp32, built as
// a library of its own so that its instances compile beside the others.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_kernel (:49)
// at its "default" precision, the one JAX's model runs: on the TPU every
// dot's operands are rounded to bf16 and the products summed in fp32 (one
// MXU pass). S = bf16(q*scale).bf16(k) (the wrapper rounds the scaled q),
// P.V = bf16(P).bf16(v), with P rounded to nearest even from the fp32
// accumulator; the rest as the three-term instances.
//
// Bound on the H100: 2 bf16 passes over the valid (query, key) pairs (S and
// P.V) at 989 TFLOP/s; the design is the bf16 forward's (its header).
//
// Entry points: sp_flash_attention_fwd_one_pass (o bf16) and
// sp_flash_attention_fwd_one_pass_f32 (o fp32), the arguments of
// sp_flash_attention_fwd_bf16.
#define SP_FLASH_ONE_PASS
#include "flash_attention_fwd_bf16.cu"

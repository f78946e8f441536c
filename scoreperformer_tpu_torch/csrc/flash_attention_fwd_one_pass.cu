// The one-pass flash-attention forward: csrc/flash_attention_fwd_bf16.cu's
// kernel with P in one bf16 term (kTerms = 1), on bf16 or fp32 operands
// (`In`) with o in their dtype, built as a library of its own so that its
// instances compile beside the others.
//
// Replaces: scoreperformer_tpu/ops/flash_attention.py::_flash_kernel (:49)
// at its "default" precision, the one JAX's model runs: on the TPU every
// dot's operands are rounded to bf16 and the products summed in fp32 (one
// MXU pass). S = bf16(q*scale).bf16(k), P.V = bf16(P).bf16(v), with P
// rounded to nearest even from the fp32 accumulator; the rest as the
// three-term instances. The kernel takes q, k and v as the caller holds
// them and rounds them itself, q after the scale (no wrapper copy).
//
// Bound on the H100: 2 bf16 passes over the valid (query, key) pairs (S and
// P.V) at 989 TFLOP/s, or on fp32 operands the bytes (q, k, v and o in
// fp32); the design is the bf16 forward's (its header, "Operands rounded
// here").
//
// Entry points: sp_flash_attention_fwd_one_pass (bf16 operands and o) and
// sp_flash_attention_fwd_one_pass_f32 (fp32 operands and o), the arguments
// of sp_flash_attention_fwd_bf16 with the real scale.
#define SP_FLASH_ONE_PASS
#include "flash_attention_fwd_bf16.cu"

#!/usr/bin/env python3
"""The one-pass flash kernels' times (the TPU's "default" precision), on one
CUDA card.

    python3 chip_probe_precision.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds the kernels, then holds the one-pass forward, dK/dV and dQ/dslope
kernels to their one-pass plain versions (`chip_smoke.check_flash_one_pass`)
and times them by CUDA-graph replay, beside the wrappers' rounding copies,
the plain versions and SDPA's bf16 forward and backward, at:
- the flagship's train step (b 128, 4 heads of 64 over one KV head): t 258
  padded (the encoders) and 257 causal (the decoder), fp32 and bf16;
- scale_1024's decoder (b 8, 8 heads of 128 over one KV head): t 1025
  causal and 1026 padded, fp32 and bf16;
and, at the flagship's shapes, the fp32-accurate kernels of the same
operands in the same process (`check_flash`, `check_flash_bwd`,
`check_flash_bf16`), so that the two precisions compare within one call.
Then the spread of the flagship's batch-4 train step on the card
(`step_spread`): the one-pass kernels against the plain versions, each
against itself, under "medium" and with the one-pass route alone (the
model's GEMMs at "highest"), and the fp32-accurate kernels against the
plain versions, each gradient's error over its largest value.
Prints the card's name and power limit first and one JSON line per record.
"""
import json
import os
import subprocess
import sys
import time

# (label, b, t, causal, padded, h, d)
SHAPES = (
    ("flagship encoders", 128, 258, False, True, 4, 64),
    ("flagship decoder", 128, 257, True, True, 4, 64),
    ("scale_1024 decoder", 8, 1025, True, True, 8, 128),
    ("d = 128, non-causal", 8, 1026, False, True, 8, 128),
)


def step_spread(torch, cs, fa, tokenizer):
    """(label, record) of batch-4 flagship steps on the card held to each
    other (`chip_smoke.compare_train_step`), on the train phase's data."""
    from scoreperformer_tpu_torch.data import build_synthetic_dataset
    from scoreperformer_tpu_torch.training import ExperimentComponents

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_probe_precision")
    root = os.path.join(work, "data")
    build_synthetic_dataset(root, n_scores=12, n_perfs_per_score=4, n_bars=64, seed=cs.SEED, splits=True,
                            with_directions=False)
    comp = ExperimentComponents(cs.train_config(tokenizer, root, os.path.join(work, "run"), cs.TRAIN_BATCH, 2),
                                device="cpu").init_components()
    batch = next(comp.trainer._iter_batches(comp.train_dataset, cs.TRAIN_BATCH, True, 0))
    config = comp.model_config
    del comp

    def step(**kw):
        gate = cs.compare_train_step(torch, config, batch, devices=("cuda", "cuda"), by_name=True, **kw)
        errs = gate.pop("grad_errs")
        return {**gate, "largest_grad_errs": dict(sorted(errs.items(), key=lambda x: -x[1])[:6])}

    saved = torch.get_float32_matmul_precision()
    try:
        for precision in ("medium", "highest"):
            torch.set_float32_matmul_precision(precision)
            yield f"{precision}: kernels against the plain versions", step(reference_plain_flash=True)
            yield f"{precision}: kernels against themselves", step()
            with cs.plain_flash(fa):
                yield f"{precision}: plain versions against themselves", step()
        # the one-pass route with the model's GEMMs at "highest"
        one_pass = fa.precision_is_one_pass
        fa.precision_is_one_pass = lambda precision="default": True
        try:
            yield "one-pass flash, fp32 GEMMs: kernels against the plain versions", step(reference_plain_flash=True)
        finally:
            fa.precision_is_one_pass = one_pass
    finally:
        torch.set_float32_matmul_precision(saved)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_precision: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for label, b, t, causal, padded, h, d in SHAPES:
        for dtype in ("fp32", "bf16"):
            recs = cs.check_flash_one_pass(torch, fa, b, t, causal, padded, timed=True, h=h, d=d, dtype=dtype)
            for name, rec in zip(cs.FLASH, recs):
                print(f"{name}_one_pass, {label}, {dtype}, timed", json.dumps({**rec, "card": smi}), flush=True)
        if d == 64:
            # the fp32-accurate kernels on the same shapes, in this call
            print(f"flash_attention_fwd, {label}, fp32, timed",
                  json.dumps({**cs.check_flash(torch, fa, b, t, causal, padded, True, h=h, d=d), "card": smi}),
                  flush=True)
            dkv, dq, pair = cs.check_flash_bwd(torch, fa, b, t, causal, padded, True, h=h, d=d)
            for name, rec in (("flash_attention_bwd_dkv", dkv), ("flash_attention_bwd_dq", dq),
                              ("flash_attention_bwd_pair", pair)):
                print(f"{name}, {label}, fp32, timed", json.dumps({**rec, "card": smi}), flush=True)
            for name, rec in zip(cs.FLASH, cs.check_flash_bf16(torch, fa, b, t, causal, padded, True, h=h, d=d)):
                print(f"{name}_bf16, {label}, timed", json.dumps({**rec, "card": smi}), flush=True)
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    for label, rec in step_spread(torch, cs, fa, tokenizer):
        print(f"batch-4 step, {label}", json.dumps({**rec, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

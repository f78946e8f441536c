#!/usr/bin/env python3
"""The one-pass flash kernels' times (the TPU's "default" precision), on one
CUDA card.

    python3 chip_probe_precision.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds the kernels, then holds the one-pass forward, dK/dV and dQ/dslope
kernels to their one-pass plain versions (`chip_smoke.check_flash_one_pass`)
and times them by CUDA-graph replay, beside the forward wrapper's rounding
copies (the backward kernels round fp32 operands themselves), the plain
versions and SDPA's bf16 forward and backward, at:
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
Then the flagship's batch-128 train step profiled under "medium" and under
"highest" (`profiled_steps`): device busy time, the flash kernels and the
dtype conversion launches (`chip_smoke.CONVERSION_KERNEL`), whose
difference is the one-pass route's rounding copies.

    python3 chip_probe_precision.py --parent DIR

also holds the one-pass backward route on fp32 operands to that of the tree
unpacked at DIR (`git archive` of an earlier commit, whose backward wrappers
rounded q, k, v and dO to bf16 in torch before launching its
bf16-operand, fp32-output entries): its library is built from DIR's
sources, and dk, dv, dq and the slope gradient must have the same bits
(`parent_route_bits`).
Prints the card's name and power limit first and one JSON line per record.
"""
import argparse
import ctypes
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


WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_probe_precision")


def dataset(cs):
    """The probe's synthetic dataset (the train phase's layout), built once."""
    from scoreperformer_tpu_torch.data import build_synthetic_dataset

    root = os.path.join(WORK, "data")
    if not os.path.isdir(root):
        build_synthetic_dataset(root, n_scores=12, n_perfs_per_score=4, n_bars=64, seed=cs.SEED, splits=True,
                                with_directions=False)
    return root


def profiled_steps(torch, cs, fa, tokenizer):
    """(label, record) of the flagship's batch-128 train step, two warm-up
    steps and one profiled, under "medium" (the one-pass route) and under
    "highest" (the fp32-accurate kernels): device busy time, the flash
    kernels' launches and the dtype conversion launches."""
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.training import ExperimentComponents

    saved = torch.get_float32_matmul_precision()
    try:
        for precision, dtype in (("medium", "one_pass"), ("highest", "fp32")):
            torch.set_float32_matmul_precision(precision)
            comp = ExperimentComponents(cs.train_config(tokenizer, dataset(cs), os.path.join(WORK, "run"),
                                                        cs.TRAIN_BATCH, 2), device="cuda").init_components()
            trainer = comp.trainer
            trainer._prepare()
            step_ms, _, batch, _, _ = cs.train_steps(torch, fa, kv, pa, trainer, comp.train_dataset, 2, 1,
                                                     dtype=dtype)
            cs.reset_counts(fa, kv, pa)
            prof = cs.profile_device(torch, lambda: trainer.train_step(batch, 3), ported=cs.PORTED_TRAIN, top=12,
                                     counted=(cs.CONVERSION_KERNEL,))
            yield f"{precision}: profiled batch-128 step", {
                "step_ms": step_ms, "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"], "device_ops": prof["device_ops"],
                "conversions": prof["counted"][cs.CONVERSION_KERNEL], "flash": prof["ported"],
                "launches": cs.all_counts(fa, kv, pa), "top": prof["top"]}
            del comp, trainer, batch
            torch.cuda.empty_cache()
    finally:
        torch.set_float32_matmul_precision(saved)


def parent_route_bits(torch, cs, fa, parent):
    """(label, record) per fp32 shape of SHAPES: the one-pass dK/dV and
    dQ/dslope wrappers on fp32 operands against the route of the tree at
    `parent` (q, k, v and dO rounded to bf16 by torch, its bf16-operand,
    fp32-output entries), built from `parent`'s sources, on the same
    inputs and forward; `same_bits` for dk, dv, dq and the slope gradient."""
    from scoreperformer_tpu_torch.ops import _build

    src = os.path.join(parent, "scoreperformer_tpu_torch", "csrc", "flash_attention_bwd_one_pass.cu")
    so = os.path.join(WORK, "parent_flash_attention_bwd_one_pass.so")
    os.makedirs(WORK, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    entries = {}
    for name in ("dkv", "dq"):
        fn = getattr(lib, f"sp_flash_attention_bwd_{name}_one_pass_f32")
        fn.argtypes, fn.restype = _build._FLASH_BWD_ARGS, ctypes.c_int
        entries[name] = fn
    for label, b, t, causal, padded, h, d in SHAPES:
        q, k, v, slopes, mask, dout = cs.flash_bwd_inputs(torch, b, t, causal, padded, h, d, 1)
        o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal, one_pass=True)
        delta = (dout * o).sum(-1).float()
        args = (q, k, v, slopes, mask, dout, lse, delta, causal)
        new = fa.flash_attention_bwd_dkv(*args, one_pass=True) + fa.flash_attention_bwd_dq(*args, one_pass=True)
        qb, kb, vb, db = (x.bfloat16() for x in (q, k, v, dout))
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
        parts = torch.empty(fa.dq_slope_parts(b, h, 1, t), device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        for name, outs in (("dkv", (dk, dv)), ("dq", (dq, parts))):
            err = entries[name](qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
                                db.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
                                b, h, 1, t, t, d, int(causal), float(d**-0.5), stream)
            if err:
                raise RuntimeError(f"the parent's {name} entry failed with CUDA error {err}")
        old = (dk, dv, dq, parts.sum(dim=(0, 2)))
        torch.cuda.synchronize()
        same = {n: torch.equal(x, y) for n, x, y in zip(("dk", "dv", "dq", "dslopes"), new, old)}
        yield f"{label}, fp32 operands", {"shape": [b, h, t, d], "causal": causal, "same_bits": same,
                                           "max_abs_diff": {n: (x - y).abs().max().item()
                                                            for n, x, y in zip(("dk", "dv", "dq", "dslopes"),
                                                                               new, old)}}


def step_spread(torch, cs, fa, tokenizer):
    """(label, record) of batch-4 flagship steps on the card held to each
    other (`chip_smoke.compare_train_step`), on the train phase's data."""
    from scoreperformer_tpu_torch.training import ExperimentComponents

    root = dataset(cs)
    comp = ExperimentComponents(cs.train_config(tokenizer, root, os.path.join(WORK, "run"), cs.TRAIN_BATCH, 2),
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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="an earlier tree to hold the one-pass backward route's bits to")
    opts = parser.parse_args()
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
    if opts.parent:
        for label, rec in parent_route_bits(torch, cs, fa, opts.parent):
            print(f"one-pass backward against {opts.parent}, {label}", json.dumps({**rec, "card": smi}), flush=True)
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    for label, rec in profiled_steps(torch, cs, fa, tokenizer):
        print(f"flagship step, {label}", json.dumps({**rec, "card": smi}), flush=True)
    for label, rec in step_spread(torch, cs, fa, tokenizer):
        print(f"batch-4 step, {label}", json.dumps({**rec, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

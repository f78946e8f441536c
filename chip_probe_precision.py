#!/usr/bin/env python3
"""The one-pass flash kernels' times (the TPU's "default" precision), on one
CUDA card.

    python3 chip_probe_precision.py

Run from the root of a checkout, on a machine with the CUDA toolkit. It
builds the kernels, then holds the one-pass forward, dK/dV and dQ/dslope
kernels to their one-pass plain versions (`chip_smoke.check_flash_one_pass`)
and times them by CUDA-graph replay on the operands as the wrappers
receive them (the kernels round fp32 operands, and the forward's scaled q,
themselves), beside the plain versions and SDPA's bf16 forward and
backward, at:
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

also holds the one-pass routes to those of the tree unpacked at DIR (`git
archive` of an earlier commit whose forward wrapper rounded the operands
to bf16 in torch, bf16(q*scale), k and v, and launched its bf16-operand
entries with scale 1, and whose backward kernels took fp32 operands as
they are): its two one-pass libraries are built from DIR's sources, and
the forward's o and lse, on fp32 and bf16 operands, and the backward's dk,
dv, dq and slope gradient, on fp32 operands, must have the same bits
(`parent_route_bits`); the forward kernel on the operands as received is
timed in turns against DIR's route and DIR's kernel alone on the copies.
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


def parent_library(torch, parent, name, symbols):
    """{symbol: entry} of one-pass library `name` built from the sources of
    the tree at `parent`, with the port's C signature."""
    from scoreperformer_tpu_torch.ops import _build

    src = os.path.join(parent, "scoreperformer_tpu_torch", "csrc", f"{name}.cu")
    so = os.path.join(WORK, f"parent_{name}.so")
    os.makedirs(WORK, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    entries = {}
    for symbol in symbols:
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = _build.ENTRY_POINTS[name][symbol], ctypes.c_int
        entries[symbol] = fn
    return entries


def parent_route_bits(torch, cs, fa, parent):
    """(label, record) per shape of SHAPES: the one-pass forward on fp32 and
    bf16 operands and the dK/dV and dQ/dslope wrappers on fp32 operands
    against the route of the tree at `parent`, built from `parent`'s
    sources, on the same inputs: its forward wrapper's bf16 copies,
    bf16(q*scale), k and v, through its bf16-operand entries with scale 1;
    its backward's fp32 entries on the fp32 operands. `same_bits` for o and
    lse, and for dk, dv, dq and the slope gradient; the forward's `ms` by
    CUDA-graph replay in turns: this tree's kernel, the parent's route and
    the parent's kernel alone on the copies."""
    fwd = parent_library(torch, parent, "flash_attention_fwd_one_pass",
                         ("sp_flash_attention_fwd_one_pass", "sp_flash_attention_fwd_one_pass_f32"))
    bwd = parent_library(torch, parent, "flash_attention_bwd_one_pass",
                         ("sp_flash_attention_bwd_dkv_one_pass_f32", "sp_flash_attention_bwd_dq_one_pass_f32"))
    stream = torch.cuda.current_stream().cuda_stream

    def compare(names, new, old):
        torch.cuda.synchronize()
        return {"same_bits": {n: torch.equal(x, y) for n, x, y in zip(names, new, old)},
                "max_abs_diff": {n: (x.float() - y.float()).abs().max().item() for n, x, y in zip(names, new, old)}}

    for label, b, t, causal, padded, h, d in SHAPES:
        q, k, v, slopes, mask, dout = cs.flash_bwd_inputs(torch, b, t, causal, padded, h, d, 1)
        for dtype in ("fp32", "bf16"):
            ops = (q, k, v) if dtype == "fp32" else tuple(x.bfloat16() for x in (q, k, v))
            entry = fwd["sp_flash_attention_fwd_one_pass" + ("_f32" if dtype == "fp32" else "")]

            def parent_kernel(qs, kb, vb):
                o, lse = torch.empty_like(qs, dtype=ops[0].dtype), torch.empty(b, h, t, device=qs.device)
                err = entry(qs.data_ptr(), kb.data_ptr(), vb.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), b, h, 1, t, t, d, int(causal), 1.0,
                            torch.cuda.current_stream().cuda_stream)  # a graph captures on its own stream
                if err:
                    raise RuntimeError(f"the parent's forward entry failed with CUDA error {err}")
                return o, lse

            def copies(qc, kc, vc):
                return (qc.float() * d**-0.5).bfloat16(), kc.bfloat16(), vc.bfloat16()

            new = fa.flash_attention_fwd(*ops, slopes, mask, causal, one_pass=True)
            rec = {"shape": [b, h, t, d], "causal": causal,
                   **compare(("o", "lse"), new, parent_kernel(*copies(*ops)))}
            # graph replay in turns (parent, new, new, parent): this tree's
            # kernel on the operands as received, the parent's route (its
            # wrapper's copies and its kernel) and its kernel alone on the
            # copies
            received = [tuple(x.clone() for x in ops) for _ in range(cs.n_copies(3 * ops[0].element_size()
                                                                                 * q.numel()))]
            copied = [copies(*x) for x in received]
            times = {"kernel": [], "parent_route": [], "parent_kernel": []}
            for turn in ("parent", "new", "new", "parent"):
                if turn == "new":
                    times["kernel"].append(cs.graph_ms(torch, lambda qc, kc, vc: fa._fwd_launch(
                        qc, kc, vc, slopes, mask, causal, d**-0.5, True), received, iters=50))
                else:
                    times["parent_route"].append(cs.graph_ms(
                        torch, lambda qc, kc, vc: parent_kernel(*copies(qc, kc, vc)), received, iters=50))
                    times["parent_kernel"].append(cs.graph_ms(torch, parent_kernel, copied, iters=50))
            del received, copied
            yield f"forward, {label}, {dtype} operands", {**rec, "ms": times}
        o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal, one_pass=True)
        delta = (dout * o).sum(-1).float()
        args = (q, k, v, slopes, mask, dout, lse, delta, causal)
        new = fa.flash_attention_bwd_dkv(*args, one_pass=True) + fa.flash_attention_bwd_dq(*args, one_pass=True)
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
        parts = torch.empty(fa.dq_slope_parts(b, h, 1, t), device=q.device)
        for name, outs in (("dkv", (dk, dv)), ("dq", (dq, parts))):
            err = bwd[f"sp_flash_attention_bwd_{name}_one_pass_f32"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), mask.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs), b, h, 1, t, t, d, int(causal),
                float(d**-0.5), stream)
            if err:
                raise RuntimeError(f"the parent's {name} entry failed with CUDA error {err}")
        yield f"backward, {label}, fp32 operands", {"shape": [b, h, t, d], "causal": causal, **compare(
            ("dk", "dv", "dq", "dslopes"), new, (dk, dv, dq, parts.sum(dim=(0, 2))))}


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
    parser.add_argument("--parent", help="an earlier tree to hold the one-pass routes' bits to")
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
            print(f"one-pass route against {opts.parent}, {label}", json.dumps({**rec, "card": smi}), flush=True)
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    for label, rec in profiled_steps(torch, cs, fa, tokenizer):
        print(f"flagship step, {label}", json.dumps({**rec, "card": smi}), flush=True)
    for label, rec in step_spread(torch, cs, fa, tokenizer):
        print(f"batch-4 step, {label}", json.dumps({**rec, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What head dims the kernels are not built for cost, on one CUDA card.

    python3 chip_probe_head_shapes.py

Run from the root of a checkout, on a machine with the CUDA toolkit. A head
dim the flash kernels are not built for runs at the next built width with
zero columns (`scoreperformer_tpu_torch/ops/head_layout.py`). At the
flagship's training shapes (batch 128, t 258 with padded keys, t 257 causal)
it times, by CUDA-graph replay (`chip_smoke.check_flash`,
`check_flash_bwd`, `check_flash_bf16`, each first held to the plain version
on the unpadded inputs):
- the forward and the backward pair, fp32 and bf16, at 6 heads of 48 over
  one KV head (padded to 64) and at 3 heads of 96 (padded to 128), each
  with SDPA on the same bias at the real head dim and the bound at the real
  head dim beside;
- the same launches at the built widths (6 heads of 64, 3 of 128): the
  kernels' own time at the padded width;
- the pad copies alone (q, k, v and the output cut back in the forward; q,
  k, v and dout in the backward), fp32 and bf16.
It times `prefix_attend` at the served batch's shape with 6 query heads of
48 over one KV head (8 rows a launch on caches 64 wide) beside 8 heads of
64, in fp32, bf16 and int8. It renders the 32-bar score with the flagship at 4 heads of 64, 6 of 64 and 6
of 48, in turns. Then it profiles one train step of the flagship at 6 heads of 48 (batch 128
x 258, through `Trainer.train_step`) and reports the device time of the pad
copies and of the output cuts against the step's device time. Prints the
card's name and power limit first and one JSON line per record.
"""
import json
import os
import subprocess
import sys
import time

# (name, heads, head dim): the padded head shapes, each before the launch at
# its built width that it is set beside
SHAPES = [("h6_d48", 6, 48), ("h6_d64", 6, 64), ("h3_d96", 3, 96), ("h3_d128", 3, 128)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_head_shapes: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from scoreperformer_tpu_torch.data import build_synthetic_dataset
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import head_layout
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig
    from scoreperformer_tpu_torch.training import ExperimentComponents

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    b, keep = cs.TRAIN_BATCH, ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_tc_ms", "max_abs_err")
    for name, h, d in SHAPES:
        for t, causal in ((cs.TRAIN_SEQ + 2, False), (cs.TRAIN_SEQ + 1, True)):
            fwd = cs.check_flash(torch, fa, b, t, causal=causal, padded=True, timed=True, h=h, d=d)
            _, _, pair = cs.check_flash_bwd(torch, fa, b, t, causal=causal, padded=True, timed=True, h=h, d=d)
            bf16 = cs.check_flash_bf16(torch, fa, b, t, causal=causal, padded=True, timed=True, h=h, d=d)
            rec = {"shape": name, "b": b, "t": t, "causal": causal, "card": smi,
                   "fp32_fwd": {k: fwd[k] for k in keep if k in fwd},
                   "fp32_pair": {k: pair[k] for k in ("pair_ms", "library_ms", "bound_ms", "bound_tc_ms")},
                   "bf16_fwd": {k: bf16[0][k] for k in keep if k in bf16[0]},
                   "bf16_pair": {"pair_ms": bf16[1]["ms"] + bf16[2]["ms"], "library_ms": bf16[1]["library_ms"],
                                 "bound_ms": bf16[1]["bound_ms"] + bf16[2]["bound_ms"]}}
            width = head_layout.kernel_head_dim(d)
            if width != d:  # the copies alone, at this shape
                rec["pad_copies_ms"] = {str(dt).removeprefix("torch."): pad_copies_ms(
                    torch, cs, fa, head_layout, b, h, t, d, width, dt) for dt in (torch.float32, torch.bfloat16)}
            print("head shape timing", json.dumps(rec), flush=True)

    # prefix_attend at the served batch's shape (b 128, cap 384, halfway):
    # 6 query heads of 48 over one KV head (8 rows a launch on caches 64
    # wide) beside 8 heads of 64, the same launch on real columns
    for h, d in ((6, 48), (8, 64)):
        for dt in ("fp32", "bf16", "int8"):
            rec = cs.check_prefix_attend(torch, pa, cs.SERVE_REQUESTS, cs.SERVE_BUCKET, cs.SERVE_BUCKET // 2,
                                         timed=True, dtype=dt, h=h, d=d)
            print("prefix_attend head shape timing", json.dumps({**rec, "card": smi}), flush=True)

    # the 32-bar render's wall with 4 heads of 64 (the flagship), 6 heads of
    # 64 (prefix_attend's rows padded to 8) and 6 heads of 48 (columns too),
    # each warm, in turns: the decode is host-bound, so the padded layout's
    # extra host operations show here
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    print("head shapes render walls", json.dumps({"card": smi, **render_walls(torch, cs, tokenizer)}), flush=True)

    # the pad copies' share of a train step of the flagship at 6 heads of 48
    work = os.path.join(root, "build", "chip_probe_head_shapes")
    data = os.path.join(work, "data")
    build_synthetic_dataset(data, n_scores=12, n_perfs_per_score=4, n_bars=64, seed=cs.SEED, splits=True,
                            with_directions=False)
    config = cs.train_config(tokenizer, data, os.path.join(work, "run"), cs.TRAIN_BATCH, 2)
    config["model"] = cs.with_heads(config["model"], *cs.HEAD_SHAPES_MODEL)
    comp = ExperimentComponents(config, device="cuda").init_components()
    trainer = comp.trainer
    trainer._prepare()
    batch = trainer._put_batch(next(trainer._iter_batches(comp.train_dataset, cs.TRAIN_BATCH, True, 0)))
    for step in range(3):
        trainer.train_step(batch, step)
    torch.cuda.synchronize()
    rec = profile_copies(torch, trainer, batch, fa)
    rec.update(card=smi, model={"heads": cs.HEAD_SHAPES_MODEL[0], "dim_head": cs.HEAD_SHAPES_MODEL[1]},
               batch=[cs.TRAIN_BATCH, cs.TRAIN_SEQ + 2])
    print("head shapes train step profile", json.dumps(rec), flush=True)
    return 0


def render_walls(torch, cs, tokenizer):
    """Seconds of a greedy 32-bar render on the card for each head shape,
    each shape rendered once to warm up, then twice in turns (A B C C B A)."""
    import numpy as np
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer

    score = synthetic_score(np.random.RandomState(cs.SEED), n_bars=cs.N_BARS)
    n_notes = len(prepare_render_inputs(tokenizer, score)["deadpan_ids"])
    shapes = {"h4_d64": (4, 64), "h6_d64": (6, 64), "h6_d48": (6, 48)}
    models = {name: build_scoreperformer(cs.flagship_config(tokenizer, n_notes, heads=h, dim_head=d), device="cuda",
                                         seed=cs.SEED)[0].eval() for name, (h, d) in shapes.items()}

    def render(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_performance(models[name], tokenizer, score, seed=cs.SEED, device="cuda", greedy=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in shapes:
        render(name)
    walls = {name: [] for name in shapes}
    for name in list(shapes) + list(reversed(shapes)):
        walls[name].append(render(name))
    return {"render_wall_s": walls}


def pad_copies_ms(torch, cs, fa, head_layout, b, h, t, d, width, dtype):
    """Device ms of the forward's copies (q, k, v padded over one KV head, o
    cut back) and of the backward's (q, k, v and dout padded) in `dtype`, by
    graph replay."""
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, dout = (torch.randn(b, h, t, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, 1, t, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    o = torch.randn(b, h, t, width, device="cuda", generator=g).to(dtype)
    fwd = cs.graph_ms(torch, lambda: [head_layout.pad_head_dim(x, width) for x in (q, k, v)] + [fa._cut(o, d)],
                      [()], iters=20)
    bwd = cs.graph_ms(torch, lambda: [head_layout.pad_head_dim(x, width) for x in (q, k, v, dout)], [()], iters=20)
    return {"fwd": fwd, "bwd": bwd}


def profile_copies(torch, trainer, batch, fa):
    """One profiled train step: the device time of the pad copies and of the
    forward's output cuts (each under a profiler range), and the step's
    device time (the device events' durations summed, as
    `chip_smoke.profile_device` sums them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    pad, cut = fa.pad_head_dim, fa._cut

    def ranged(label, fn):
        def call(*a):
            with record_function(label):
                return fn(*a)
        return call

    fa.pad_head_dim, fa._cut = ranged("head_pad", pad), ranged("head_cut", cut)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(batch, 3)
            torch.cuda.synchronize()
    finally:
        fa.pad_head_dim, fa._cut = pad, cut
    events = prof.key_averages()
    ranges = {e.key: (e.device_time_total / 1e3, e.count) for e in events if e.key in ("head_pad", "head_cut")}
    step_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()) / 1e6
    copies_ms = sum(ms for ms, _ in ranges.values())
    return {"step_device_ms": step_ms, "ranges_ms_and_calls": ranges, "copies_ms": copies_ms,
            "copies_share": copies_ms / step_ms if step_ms else "not measured"}


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The kernels' times at the recipes' other head dims, on one CUDA card.

    python3 chip_probe_recipe_shapes.py

Run from the root of a checkout, on a machine with the CUDA toolkit. This is
timing work that `chip_smoke.py` did before and now leaves to this script to
keep its clock; `chip_smoke.py` still holds every one of these shapes to the
plain versions. It builds the kernels, then:
- the three flash kernels (fp32 and bf16) at the scale regime's and the
  smoke-shaped paths' shapes (`chip_smoke.FLASH_TIMED_SHAPES`: scale_1024's
  decoder at d = 128 over 1024 and 2048 notes, its encoders at d = 64 with 8
  KV heads, recipes/smoke.yaml's d = 16), each held to its plain version
  and timed by CUDA-graph replay beside SDPA (`check_flash_head_dims`);
- `prefix_attend` at recipes/smoke.yaml's served shape (2 heads of 16) and
  scale_1024's (8 heads of 128 over a cache of 1024, fp32 and int8);
- `prefix_attend`'s split count swept (in whole tiles) at the served shape
  and at scale_1024's, fp32 and int8 (`prefix_split_sweep`);
- the other paths' shapes that `chip_smoke.py` holds to the plain versions
  untimed (`path_shapes`): the row writes at the served, scale_1024,
  streaming, Performer and MoE steps; the flash kernels at the train step's
  causal decoder, a 32 x 258 batch, the served encoders, the model axis's 2
  heads and a pipeline microbatch; `prefix_attend` in bf16 and int8 at the
  served shape, at the TPU script's, the render's, moe.yaml's served batch
  and the Performer's chunked generation. Shapes whose valid lengths come
  from a phase's data (the streaming chunks, `mlm_unmask`, the MoE
  variants' caps) are not repeated here.
Prints the card's name and power limit first and one JSON line per record.
"""
import json
import os
import subprocess
import sys
import time


def path_shapes(torch, cs, fa, pa):
    """(label, record) of each kernel timed at a path's shape other than the
    main path's, as `chip_smoke.py` checks it."""
    import numpy as np
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig

    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    _, serve_inputs = cs.served_inputs(tokenizer)
    serve_lens = [len(x["deadpan_ids"]) for x in serve_inputs]
    score = synthetic_score(np.random.RandomState(cs.SEED), n_bars=cs.N_BARS)
    t = len(prepare_render_inputs(tokenizer, score)["deadpan_ids"])
    cap_render = max(-(-(t - 1) // cs.CHUNK) * cs.CHUNK, t)
    f32 = torch.float32
    for cap, n, b, dim, idx in ((cs.CHUNK, 1, cs.SERVE_REQUESTS, 64, 5), (cs.CHUNK, 1, cs.SCALE_REQUESTS, 128, 7),
                                (272, 16, 512, 64, 100), (cs.CHUNK, 1, cs.GEN_BATCH, 64, 5),
                                (cs.CHUNK, 1, cs.MOE_REQUESTS, 64, 5), (258, 1, 1, 64, cs.RING_SEQ % 258)):
        for pair in (False, True):
            yield "write_kv" + "_pair" * pair, cs.check_write_kv(torch, kv, cap, n, b, dim, idx, f32, True, pair)
    for d in (64, 128):
        for n, idx in ((128, 0), (64, 128), (8, 192), (1, 250)):
            yield "write_kv_pair, streaming", cs.check_write_kv(torch, kv, cs.STREAM_CTX, n, 1, d, idx, f32, True,
                                                                pair=True)
    rows = cs.TRAIN_BATCH // 2 // cs.PIPE_MICROBATCHES
    for what, args, kw in (
            ("32 x 258", (32, 258, False, True), {}),
            ("train step, causal", (cs.TRAIN_BATCH, cs.TRAIN_SEQ + 1, True, True), {}),
            ("served encoders", (cs.SERVE_REQUESTS, cs.SERVE_BUCKET, False, "served"), {"lengths": serve_lens}),
            ("model axis, 2 heads", (cs.TRAIN_BATCH, cs.TRAIN_SEQ + 2, False, True), {"h": 2}),
            ("pipeline microbatch, 4 heads", (rows, cs.TRAIN_SEQ + 1, True, False), {"h": 4}),
            ("pipeline microbatch, 2 heads", (rows, cs.TRAIN_SEQ + 1, True, False), {"h": 2})):
        yield f"flash_attention_fwd, {what}", cs.check_flash(torch, fa, *args, True, **kw)
        if what != "served encoders":
            dkv, dq, pair = cs.check_flash_bwd(torch, fa, *args, True, **kw)
            yield f"flash_attention_bwd_dkv, {what}", dkv
            yield f"flash_attention_bwd_dq, {what}", dq
            yield f"flash_attention_bwd_pair, {what}", pair
    for name, rec in zip(cs.FLASH, cs.check_flash_bf16(torch, fa, cs.TRAIN_BATCH, cs.TRAIN_SEQ + 1, causal=True,
                                                       padded=True, timed=True)):
        yield f"{name}_bf16, train step, causal", rec
    gen_cap = max(cs.GEN_SEQ + 1, cs.GEN_T0 - 2 + -(-(cs.GEN_SEQ + 1 - cs.GEN_T0) // cs.CHUNK) * cs.CHUNK)
    for what, args, kw in (
            ("served, bf16", (cs.SERVE_REQUESTS, cs.SERVE_BUCKET, cs.SERVE_BUCKET // 2), {"dtype": "bf16"}),
            ("served, int8", (cs.SERVE_REQUESTS, cs.SERVE_BUCKET, cs.SERVE_BUCKET // 2), {"dtype": "int8"}),
            ("the TPU script's shape", (512, 256, 256 - cs.CHUNK), {}),
            ("render", (1, cap_render, cap_render // 2), {}),
            ("moe.yaml's served batch", (cs.SMOKE_REQUESTS, cs.SERVE_BUCKET, cs.SERVE_BUCKET // 2), {}),
            ("Performer chunked generation", (cs.GEN_BATCH, gen_cap, cs.GEN_T0 - 2 + 128), {})):
        yield f"prefix_attend, {what}", cs.check_prefix_attend(torch, pa, *args, timed=True, **kw)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_recipe_shapes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for rec in cs.check_flash_head_dims(torch, fa, timed=True)["timed"]:
        print("flash kernels at a recipe path's shape", json.dumps({**rec, "card": smi}), flush=True)
    print(f"flash kernels at the recipes' other head dims: {time.perf_counter() - t0:.1f} s", flush=True)
    for b, cap, base, h, d, dtype in ((cs.SERVE_REQUESTS, cs.SERVE_BUCKET, cs.SERVE_BUCKET // 2, 2, 16, "fp32"),
                                      (64, 1024, 512, 8, 128, "fp32"), (64, 1024, 512, 8, 128, "int8")):
        rec = cs.check_prefix_attend(torch, pa, b, cap, base, timed=True, dtype=dtype, h=h, d=d)
        print("prefix_attend at a recipe's head dim", json.dumps({**rec, "card": smi}), flush=True)
    t0 = time.perf_counter()
    for what, rec in path_shapes(torch, cs, fa, pa):
        print(f"{what}, timed", json.dumps({**rec, "card": smi}), flush=True)
    print(f"the other paths' shapes: {time.perf_counter() - t0:.1f} s", flush=True)
    print("prefix_attend split sweep", json.dumps({**cs.prefix_split_sweep(torch, pa), "card": smi}), flush=True)
    for dtype in ("fp32", "int8"):
        sweep = cs.prefix_split_sweep(torch, pa, b=64, cap=1024, base=512, d=128, h=8, dtype=dtype)
        print("prefix_attend split sweep, scale_1024's shape", json.dumps({**sweep, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

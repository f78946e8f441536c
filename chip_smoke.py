#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (scoreperformer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (`nvcc`); run it from the root of a
checkout. It
1. prints the card's name and power limit;
2. builds every CUDA kernel from `scoreperformer_tpu_torch/csrc/`;
3. holds each kernel against its plain PyTorch version on the card, at the
   render's shapes and at the flagship batch shapes, and times the kernel,
   the plain version and one PyTorch call of the same function (the
   yardstick; the port never calls it);
4. builds the flagship ScorePerformer at full width (random weights from a
   seed, use_flash=True) and renders a 32-bar synthetic score through
   `render_performance`, greedy and top-k sampled, counting the kernel
   launches of each render;
5. profiles one more greedy render (device time by kernel, idle share);
6. checks the output: notes with the score's pitches and finite times, and,
   on a 4-bar score, the same greedy tokens as the port's CPU path.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, ...}, printed only when every phase passed. Any failure exits
non-zero.
"""
import json
import os
import subprocess
import sys
import time

SEED = 0
N_BARS = 32
BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores


def flagship_config(tokenizer, n_notes, use_flash=True):
    """bench.py::build_flagship's model at full width; vocab sizes and token
    values come from the tokenizer, as training injects them."""
    num_tokens = tokenizer.performance_sizes
    score_tokens = tokenizer.score_sizes
    token_values = {k: v.tolist() for k, v in tokenizer.token_values(normalize=True).items()}
    emb = {"_target_": "simple", "emb_dims": 128, "mode": "cat", "emb_norm": True,
           "discrete": False, "continuous": True, "continuous_dense": True,
           "discrete_ids": [0, 1, 2, 3], "token_values": token_values}
    attn = {"dim_head": 64, "one_kv_head": True, "alibi_pos_bias": True, "alibi_learned": True,
            "use_flash": use_flash}
    ff = {"mult": 4, "glu": True, "swish": True}

    def stack(target, depth):
        return {"_target_": target, "depth": depth, "heads": 4, "attention": attn, "feed_forward": ff}

    seq = n_notes
    return {
        "num_tokens": num_tokens, "num_score_tokens": score_tokens,
        "dim": 256, "tie_token_emb": True, "mode": "mixlm",
        "score_encoder": {"token_embeddings": dict(emb), "emb_norm": True, "use_abs_pos_emb": False,
                          "max_seq_len": seq + 2, "transformer": stack("encoder", 2)},
        "perf_encoder": {"token_embeddings": dict(emb), "emb_norm": True, "use_abs_pos_emb": False,
                         "max_seq_len": seq + 2, "latent_dim": [32, 20, 8, 4],
                         "aggregate_mode": ["mean", "bar_mean", "beat_mean", "onset_mean"],
                         "hierarchical": True, "max_segments": max(260, seq + 4),
                         "transformer": stack("encoder", 4)},
        "perf_decoder": {"token_embeddings": {**emb, "_target_": "multi-seq", "multiseq_mode": "post-cat"},
                         "emb_norm": True, "use_abs_pos_emb": False, "max_seq_len": seq + 2,
                         "context_emb_mode": "cat", "style_emb_mode": "adanorm",
                         "transformer": stack("decoder", 4), "lm_head": {"_target_": "lm-tied"}},
    }


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean device time of one call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_write_kv(torch, kv, cap, n, b, dim, index, cache_dtype, timed):
    """Kernel vs plain on two copies of one cache; bit-exact. Returns the
    record of this shape (times only when `timed`)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    cache = torch.randn(cap, b, dim, device=dev, generator=g).to(cache_dtype)
    new = torch.randn(n, b, dim, device=dev, generator=g)
    idx = torch.tensor([index], dtype=torch.int64, device=dev)
    got = kv.write_kv(cache.clone(), new, idx)
    want = kv.write_kv_plain(cache.clone(), new, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"write_kv differs from its plain version at {(cap, n, b, dim, index, cache_dtype)}")
    rec = {"shape": [n, b, dim], "cap": cap, "index": index, "dtype": str(cache_dtype), "max_abs_err": 0.0}
    if timed:
        start = max(0, min(index, cap - n))
        rec["ms"] = time_ms(torch, lambda: kv.write_kv(cache, new, idx), iters=200)
        rec["plain_ms"] = time_ms(torch, lambda: kv.write_kv_plain(cache, new, idx), iters=200)
        rec["library_ms"] = time_ms(torch, lambda: cache[start : start + n].copy_(new), iters=200)
        nbytes = 2 * new.numel() * cache.element_size() + idx.element_size()
        rec["bound_ms"] = nbytes / BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
    return rec


def check_flash(torch, fa, b, t, causal, padded, timed, h=4, d=64):
    """Kernel vs plain at fp32, max abs error of o and lse <= 1e-4. Returns
    the record of this shape (times only when `timed`)."""
    import torch.nn.functional as F

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, h, t, d, device=dev, generator=g)
    k = torch.randn(b, 1, t, d, device=dev, generator=g)
    v = torch.randn(b, 1, t, d, device=dev, generator=g)
    slopes = torch.rand(h, device=dev, generator=g) * 0.5
    lengths = torch.randint(1, t + 1, (b,), device=dev, generator=g) if padded else torch.full((b,), t, device=dev)
    mask = torch.arange(t, device=dev)[None] < lengths[:, None]
    o, lse = fa.flash_attention_alibi(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    err = max((o - po).abs().max().item(), (lse - plse).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"flash attention differs from its plain version by {err} at {(b, t, causal, padded)}")
    rec = {"shape": [b, h, t, d], "kv_heads": 1, "causal": causal, "padded": padded, "max_abs_err": err}
    if timed:
        rec["ms"] = time_ms(torch, lambda: fa.flash_attention_alibi(q, k, v, slopes, mask=mask, causal=causal))
        rec["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal))
        # yardstick: SDPA with the bias and masks materialized outside the timing
        i, j = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None]
        bias = -slopes[None, :, None, None] * (j - i).abs().float()
        ok = mask[:, None, None, :] & ((j <= i) if causal else True)
        bias = torch.where(ok, bias, torch.full((), -1e30, device=dev)).contiguous()
        ke, ve = k.expand(b, h, t, d), v.expand(b, h, t, d)
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=bias))
        pairs = (ok.expand(b, 1, t, t)).sum().item()  # (query, key) pairs this data needs
        ops = 4 * d * h * pairs  # q.k and p.v, a multiply and an add each
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + h) + mask.numel()
        rec["bound_by"] = "operations" if ops / FP32_OPS_PER_S > nbytes / BYTES_PER_S else "bytes"
        rec["bound_ms"] = max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3
    return rec


def profile_render(torch, render, ported=("write_rows", "flash_fwd"), top=10):
    """Device time by kernel over one render (torch.profiler, CUPTI), the
    device's busy time, its idle share of the profiled wall time, and the
    totals of the ported kernels (by kernel-name substring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    by_time = sorted(device, key=lambda e: -e.self_device_time_total)[:top]
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if device else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if device else "not measured",
        "device_ops": sum(e.count for e in device),
        "top": [{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in by_time],
        "ported": {
            name: {"ms": sum(e.self_device_time_total for e in hits) / 1e3, "count": sum(e.count for e in hits)}
            for name in ported
            for hits in [[e for e in device if name in e.key]]
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.models.wrappers import mixedlm_unmask
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- build ----
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {sorted(str(p) for p in libs.values())}")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {path.stem}: {line.strip()}")

    # ---- the score and the render's shapes ----
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    score = synthetic_score(np.random.RandomState(SEED), n_bars=N_BARS)
    inputs = prepare_render_inputs(tokenizer, score)
    T = len(inputs["deadpan_ids"])
    chunk = 16
    n_steps = -(-(T - 1) // chunk) * chunk
    print(f"score: {N_BARS} bars, T={T} notes, {n_steps} decode steps")

    # ---- kernels against their plain versions ----
    kv_main = check_write_kv(torch, kv, chunk, 1, 1, 64, 5, torch.float32, timed=True)
    kv_recs = [
        check_write_kv(torch, kv, chunk, 1, 1, 64, idx, dt, timed=False)
        for idx in (0, chunk - 1, chunk + 3, -1) for dt in (torch.float32, torch.bfloat16)
    ] + [
        check_write_kv(torch, kv, 272, 16, 512, 64, 100, torch.float32, timed=True),
        check_write_kv(torch, kv, 272, 16, 512, 64, 300, torch.float32, timed=False),
        check_write_kv(torch, kv, 272, 16, 512, 64, 40, torch.bfloat16, timed=False),
        check_write_kv(torch, kv, T, 1, 1, 64, T + 7, torch.float32, timed=False),
    ]
    fa_main = check_flash(torch, fa, 1, T, causal=False, padded=False, timed=True)
    fa_recs = [
        check_flash(torch, fa, 32, 258, causal=c, padded=p, timed=(not c and p))
        for c in (False, True) for p in (False, True)
    ] + [check_flash(torch, fa, 2, 77, causal=True, padded=True, timed=False, d=32)]
    for rec in [kv_main] + kv_recs:
        print("write_kv", json.dumps(rec))
    for rec in [fa_main] + fa_recs:
        print("flash_attention_fwd", json.dumps(rec))

    # ---- the main path: the flagship renders the score on the card ----
    cfg = flagship_config(tokenizer, T)
    model, _ = build_scoreperformer(cfg, device="cuda", seed=SEED)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flagship: {n_params} parameters, use_flash=True")

    renders = {}
    for mode, kwargs in (("greedy", {"greedy": True}), ("top-k", {"filter_kwargs": {"thres": 0.9}})):
        kv.write_kv.launches = 0
        fa.flash_attention_alibi.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perf = render_performance(model, tokenizer, score, seed=SEED, device="cuda", **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"write_kv": kv.write_kv.launches, "flash_attention_fwd": fa.flash_attention_alibi.launches}
        renders[mode] = (perf, launches, wall)
        print(f"render {mode}: {wall:.3f} s wall, {perf.num_notes} notes, launches {launches}")
        expected = {"write_kv": 2 * 4 * n_steps, "flash_attention_fwd": 2 + 4}
        if launches != expected:
            raise AssertionError(f"{mode} render launched {launches}, expected {expected}")

    # ---- where a render's time goes: one more greedy render under the profiler ----
    prof = profile_render(torch, lambda: render_performance(model, tokenizer, score, seed=SEED,
                                                            device="cuda", greedy=True))
    print("profile greedy render", json.dumps(prof))

    # ---- the output is right ----
    pitch_ids = inputs["score_ids"][:, tokenizer.types_idx["Pitch"]]
    src_pitches = sorted((pitch_ids - tokenizer.zero_token + tokenizer.config.pitch_range[0]).tolist())
    for mode, (perf, _, _) in renders.items():
        notes = perf.all_notes()
        if sorted(notes.pitch.tolist()) != src_pitches:
            raise AssertionError(f"{mode} render: {perf.num_notes} notes, pitches differ from the score's")
        if not (np.isfinite(notes.start).all() and np.isfinite(notes.end).all() and (notes.end >= notes.start).all()):
            raise AssertionError(f"{mode} render: note times are not finite and ordered")

    # the kernel path against the port's CPU path (plain versions) on the same weights
    cpu_model, _ = build_scoreperformer(cfg, device="cpu", seed=SEED)
    cpu_model.eval()
    with torch.inference_mode():
        args = [inputs[k] for k in ("deadpan_ids", "score_ids", "bars", "beats", "onsets")]
        def enc(m, dev):
            x = [torch.as_tensor(np.asarray(a)[None], dtype=torch.int64, device=dev) for a in args]
            mask = torch.ones(1, T, dtype=torch.bool, device=dev)
            return m.encode_embeddings(x[0], mask, x[1], mask, *x[2:])
        gpu_emb, cpu_emb = enc(model, "cuda"), enc(cpu_model, "cpu")
        emb_err = max((g.cpu() - c).abs().max().item() for g, c in zip(gpu_emb[:2], cpu_emb[:2]))
    print(f"encoders, GPU kernels vs CPU plain: max abs err {emb_err:.3g}")
    if not emb_err <= 1e-3:
        raise AssertionError(f"encoder embeddings differ between GPU and CPU by {emb_err}")
    small = synthetic_score(np.random.RandomState(SEED + 1), n_bars=4)
    small_inputs = prepare_render_inputs(tokenizer, small)

    def small_tokens(m, dev):
        with torch.inference_mode():
            x = {k: torch.as_tensor(np.asarray(small_inputs[k])[None], dtype=torch.int64, device=dev)
                 for k in ("deadpan_ids", "score_ids", "bars", "beats", "onsets", "tokens_in", "masked_all")}
            mask = torch.ones_like(x["bars"], dtype=torch.bool)
            score_emb, style_emb, _ = m.encode_embeddings(x["deadpan_ids"], mask, x["score_ids"], mask,
                                                          x["bars"], x["beats"], x["onsets"])
            return mixedlm_unmask(m, x["tokens_in"], x["masked_all"], style_embeddings=style_emb,
                                  context=score_emb, greedy=True).cpu()
    same = torch.equal(small_tokens(model, "cuda"), small_tokens(cpu_model, "cpu"))
    print(f"4-bar greedy render tokens, GPU kernels vs CPU plain: identical={same}")
    if not same:
        raise AssertionError("greedy tokens on the GPU differ from the port's CPU path")

    launches = renders["greedy"][1]
    kernels = [
        {"name": "write_kv", "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/kv_cache.cu",
         "replaces": "scoreperformer_tpu/ops/kv_cache.py:34", "launches": launches["write_kv"],
         **{k: kv_main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "scoreperformer_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "scoreperformer_tpu/ops/flash_attention.py:49",
         "launches": launches["flash_attention_fwd"],
         **{k: fa_main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (scoreperformer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (`nvcc`); run it from the root of a
checkout. It
1. prints the card's name and power limit;
2. builds every CUDA kernel from `scoreperformer_tpu_torch/csrc/`;
3. holds each kernel against its plain PyTorch version on the card, at the
   render's and the training step's shapes, and times the kernel, the plain
   version and one PyTorch call of the same function (the yardstick; the port
   never calls it);
4. render path: builds the flagship ScorePerformer at full width (random
   weights from a seed, use_flash=True) and renders a 32-bar synthetic score
   through `render_performance`, greedy and top-k sampled, counting the
   kernel launches of each render, and profiles one more greedy render;
5. training path: writes a synthetic dataset, builds the same flagship
   through `ExperimentComponents` from a config dict (the flagship recipe's
   data, collator and optimizer settings, batch 128, sequences of 258) and
   takes train steps through the `Trainer`, counting the flash forward and
   backward launches of each step; profiles one step; then one step at
   batch 4 on the card against the port's CPU path on the same weights;
6. checks the output: notes with the score's pitches and finite times, and,
   on a 4-bar score, the same greedy tokens as the port's CPU path; finite
   losses, and loss and gradients of the card's step equal to the CPU's.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, ...}, printed only when every phase passed. Any failure exits
non-zero.
"""
import json
import os
import subprocess
import shutil
import sys
import time

import numpy as np

SEED = 0
N_BARS = 32
TRAIN_BATCH = 128  # bench.py::measure_tpu_train's batch and sequence
TRAIN_SEQ = 256  # max_seq_len: sequences of 258 with SOS/EOS
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
# recipes/scoreperformer/base.yaml's dataset settings with no_classifiers.yaml's
# choices (no direction labels); written out because the card's machine may
# have no PyYAML
DATASET = dict(
    _name_="LocalScorePerformanceDataset", _splits_={"train": "train", "eval": "eval"},
    use_alignments=False, auxiliary_data_keys=["bars", "initial_tempos"],
    performance_directions=None, score_directions_dict=None,
    max_seq_len=TRAIN_SEQ, max_bar=256, bar_sliding_window=16, sample_bars=True, sample_note_shift=0.5,
    force_max_seq_len=0.5, fit_to_max_bar=False, fit_to_zero_bar=True, sample_bar_offset=False,
    add_sos_eos=True, sample=True, seed=23, augment_performance=True, pitch_shift_range=[-3, 3],
    velocity_shift_range=[-12, 12], tempo_shift_range=[0, 0], noisy_performance=False, noise_strength=0.5,
    noisy_random_bars=0.5, deadpan_performance=0.25, zero_out_silent_durations=True,
    delete_silent_notes=True, preload=True, cache=True,
)
COLLATOR = dict(_name_="MixedLMScorePerformanceCollator", mask_ignore_token_ids=[0, 1, 2, 3],
                mask_ignore_token_dims=[0, 1, 2, 4, 6, 7, 8, 9])
# recipes/default.yaml's optimizer
OPTIMIZATION = dict(lr=2e-4, optimizer="adamw", optimizer_params={"weight_decay": 1e-6},
                    lr_scheduler="exponential", lr_scheduler_params={"gamma": 0.995}, grad_clip=2.0)
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


def sdpa_bias(torch, slopes, mask, causal):
    """The (b, h, t, t) ALiBi bias with masked keys at -1e30, for the SDPA
    yardstick, and the (b, 1, t, t) validity."""
    t = mask.shape[1]
    pos = torch.arange(t, device=mask.device)
    i, j = pos[:, None], pos[None]
    ok = mask[:, None, None, :] & ((j <= i) if causal else True)
    bias = torch.where(ok, -slopes[None, :, None, None] * (j - i).abs().float(),
                       torch.full((), -1e30, device=mask.device))
    return bias.contiguous(), ok


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
    if padded == "empty":  # batch element 0 has no valid key
        lengths[0] = 0
    mask = torch.arange(t, device=dev)[None] < lengths[:, None]
    o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask=mask, causal=causal)
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
        bias, ok = sdpa_bias(torch, slopes, mask, causal)
        # SDPA reads outside expanded (stride-0) keys at odd t: copy them
        ke, ve = k.expand(b, h, t, d).contiguous(), v.expand(b, h, t, d).contiguous()
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=bias))
        pairs = (ok.expand(b, 1, t, t)).sum().item()  # (query, key) pairs this data needs
        ops = 4 * d * h * pairs  # q.k and p.v, a multiply and an add each
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + h) + mask.numel()
        rec["bound_by"] = "operations" if ops / FP32_OPS_PER_S > nbytes / BYTES_PER_S else "bytes"
        rec["bound_ms"] = max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3
    return rec


def flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk):
    """Inputs of one backward call on the card, with dout zero on rows whose
    keys are all masked (the attention module zeroes them; see ROADMAP.md)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, h, t, d, device=dev, generator=g)
    k = torch.randn(b, hk, t, d, device=dev, generator=g)
    v = torch.randn(b, hk, t, d, device=dev, generator=g)
    slopes = torch.rand(h, device=dev, generator=g) * 0.5
    dout = torch.randn(b, h, t, d, device=dev, generator=g)
    lengths = torch.full((b,), t, device=dev)
    if padded:
        lengths = torch.randint(1, t + 1, (b,), device=dev, generator=g)
        if padded == "empty":
            lengths[0] = 0
    mask = torch.arange(t, device=dev)[None] < lengths[:, None]
    has_key = (mask.cumsum(-1) > 0) if causal else mask.any(-1, keepdim=True).expand(b, t)
    dout = dout * has_key[:, None, :, None]
    return q, k, v, slopes, mask, dout


def check_flash_bwd(torch, fa, b, t, causal, padded, timed, h=4, d=64, hk=1):
    """Both backward kernels vs their plain versions on the kernel forward's
    lse: dq, dk, dv to 1e-4 and dslopes to 1e-3 of the plain version's largest
    value (the slope sum runs over b*h*t*t terms in another order). Returns
    the records of the dK/dV and the dQ/dslope kernel at this shape."""
    import torch.nn.functional as F

    q, k, v, slopes, mask, dout = flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk)
    out, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal)
    delta = (dout * out).sum(-1)
    args = (q, k, v, slopes, mask, dout, lse, delta, causal)
    got = fa.flash_attention_bwd_dkv(*args) + fa.flash_attention_bwd_dq(*args)
    want = fa.flash_attention_bwd_dkv_plain(*args) + fa.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    err = {name: ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
           for name, x, y in zip(("dk", "dv", "dq", "dslopes"), got, want)}
    limits = {"dk": 1e-4, "dv": 1e-4, "dq": 1e-4, "dslopes": 1e-3}
    bad = {n: e for n, e in err.items() if not e <= limits[n]}
    if bad:
        raise AssertionError(f"flash backward differs from its plain version at {(b, t, causal, padded, d, hk)}: {bad}")
    shape = {"shape": [b, h, t, d], "kv_heads": hk, "causal": causal, "padded": padded}
    dkv = {**shape, "max_abs_err": max(err["dk"], err["dv"]), "errors": err}
    dq = {**shape, "max_abs_err": max(err["dq"], err["dslopes"]), "errors": err}
    if timed:
        dkv["ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(*args), iters=20)
        dq["ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq(*args), iters=20)
        dkv["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_plain(*args), iters=10, warmup=2)
        dq["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq_plain(*args), iters=10, warmup=2)
        # yardstick: the backward alone of SDPA with the bias and masks
        # materialized; it computes both kernels' outputs in one call
        bias, ok = sdpa_bias(torch, slopes, mask, causal)
        leaves = [x.detach().expand(b, h, t, d).contiguous().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        library = time_ms(torch, lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True),
                          iters=10, warmup=2)
        dkv["library_ms"] = dq["library_ms"] = library
        pairs = ok.expand(b, 1, t, t).sum().item()  # (query, key) pairs this data needs
        f32 = 4
        reads = f32 * (2 * q.numel() + k.numel() + v.numel() + 2 * lse.numel() + h) + mask.numel()
        for rec, ops, writes in ((dkv, 8 * d * h * pairs, f32 * (k.numel() + v.numel())),
                                 (dq, 6 * d * h * pairs, f32 * (q.numel() + b * h * -(-t // 32)))):
            t_ops, t_bytes = ops / FP32_OPS_PER_S, (reads + writes) / BYTES_PER_S
            rec["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
            rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
    return dkv, dq


def train_config(tokenizer, root, out_dir, batch_size, max_steps):
    """The experiment config of the training phase: the flagship at full width
    (bench.py::build_flagship's model, use_flash=True) on the dataset at
    `root`, with the flagship recipe's data and optimizer settings."""
    return {
        "data": {"dataset": {**DATASET, "root": root}, "collator": dict(COLLATOR)},
        "model": {"_name_": "ScorePerformer", **flagship_config(tokenizer, TRAIN_SEQ)},
        "evaluator": {"_name_": "ScorePerformerEvaluator", "weighted_distance": True,
                      "ignore_keys": ["Bar", "Position", "Pitch", "Duration", "TimeSig", "PositionShift",
                                      "NotesInOnset", "PositionInOnset"]},
        "trainer": {"output_dir": out_dir, "seed": 23, "batch_size": batch_size, "eval_batch_size": batch_size,
                    "epochs": 1000, "max_steps": max_steps, "log_steps": 5, "eval_strategy": "no",
                    "save_strategy": "no", "disable_progress": True, "num_workers": 4,
                    "optimization": dict(OPTIMIZATION)},
    }


def flash_counts(fa):
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches}


def reset_counts(fa, kv):
    kv.write_kv.launches = 0
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd_dkv.launches = fa.flash_attention_bwd_dq.launches = 0


def train_steps(torch, fa, kv, trainer, dataset, n_warmup, n_timed):
    """Train steps through `Trainer.train_step` on the trainer's own batches;
    every step's losses must be finite and launch 10 flash forwards and 10 of
    each backward kernel. Returns (step times in ms, launch totals, the last
    device batch, valid notes per batch)."""
    n = n_warmup + n_timed
    batches, epoch = [], 0
    while len(batches) < n:
        batches += list(trainer._iter_batches(dataset, trainer.config.batch_size, True, epoch))
        epoch += 1
    times, notes = [], []
    reset_counts(fa, kv)
    for step, host_batch in enumerate(batches[:n]):
        batch = trainer._put_batch(host_batch)
        before = flash_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, step)
        torch.cuda.synchronize()
        if step >= n_warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v - before[k] for k, v in flash_counts(fa).items()}
        if per_step != {k: 10 for k in per_step}:
            raise AssertionError(f"train step {step} launched {per_step}, expected 10 of each")
        values = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step {step}: non-finite metrics {values}")
        notes.append(int(host_batch["perf_mask"].sum()))
        print(f"train step {step}: loss {values['loss']:.5f} grad_norm {values['stats/grad_norm']:.4f} "
              f"MMD {values['MMD']:.5f} lm {values['loss/lm']:.5f}")
    return times, flash_counts(fa), batch, notes


def compare_train_step(torch, model_config, host_batch, b=4, devices=("cpu", "cuda")):
    """One train step (forward, loss, backward) of the same weights on the
    card and on the CPU (the plain versions), on the first `b` sequences and
    the same MMD samples: (loss error, largest gradient error over each
    gradient's largest value)."""
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer

    cfg = {k: v for k, v in model_config.items() if not k.startswith("_")}
    enc = cfg["perf_encoder"]
    gen = torch.Generator().manual_seed(SEED)
    draws = []

    def draw(d, n_latents):
        z = torch.randn(enc.get("mmd_num_samples", 256), d, generator=gen)
        m = enc.get("mmd_max_num_latents", 4096)
        draws.append((z, torch.rand(m, generator=gen) if n_latents > m else None))
        return draws[-1]

    results = {}
    for dev in devices:
        model, _ = build_scoreperformer(cfg, device=dev, seed=SEED)
        model.train()
        batch = {k: torch.as_tensor(np.asarray(v)[:b]).to(dev) for k, v in host_batch.items()}
        replay = iter(list(draws))
        sampler = draw if not draws else (
            lambda d, n: tuple(None if x is None else x.to(dev) for x in next(replay)))
        out = model(**batch, mmd_sampler=sampler)
        out.loss.backward()
        results[len(results)] = (out.loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                                                   if p.grad is not None})
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results[0], results[1]
    if set(cpu_grads) != set(gpu_grads):
        raise AssertionError("the card's step and the CPU's reach different parameters")
    grad_err = max(((gpu_grads[n] - g).abs().max() / g.abs().max().clamp_min(1e-12)).item()
                   for n, g in cpu_grads.items())
    return abs(gpu_loss - cpu_loss), grad_err, len(cpu_grads)


def profile_device(torch, fn, ported=("write_rows", "flash_fwd"), top=10):
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI),
    the device's busy time, its idle share of the profiled wall time, and the
    totals of the ported kernels (by kernel-name substring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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

    from scoreperformer_tpu_torch.data import build_synthetic_dataset, synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.models.wrappers import mixedlm_unmask
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig
    from scoreperformer_tpu_torch.training import ExperimentComponents, load_checkpoint

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
    ] + [
        check_flash(torch, fa, 2, 77, causal=True, padded=True, timed=False, d=32),
        # rows with no valid key: v averaged over the JAX wrapper's padded keys
        check_flash(torch, fa, 2, 37, causal=False, padded="empty", timed=False),
        check_flash(torch, fa, 2, 300, causal=True, padded="empty", timed=False),
        # the training step's shapes: 6 encoder layers, then 4 causal decoder layers
        check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=True, timed=True),
        check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded=True, timed=True),
    ]
    for rec in [kv_main] + kv_recs:
        print("write_kv", json.dumps(rec))
    for rec in [fa_main] + fa_recs:
        print("flash_attention_fwd", json.dumps(rec))
    # the backward kernels at the training step's shapes (timed), padded or
    # not, causal, d=32, one KV head per query head, and rows with no valid key
    bwd_main = check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=True, timed=True)
    bwd_recs = [
        check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=False, timed=False),
        check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded=True, timed=True),
        check_flash_bwd(torch, fa, 3, 77, causal=True, padded="empty", timed=False, d=32),
        check_flash_bwd(torch, fa, 4, 130, causal=False, padded=True, timed=False, hk=4),
        check_flash_bwd(torch, fa, 2, 300, causal=True, padded="empty", timed=False, hk=4),
    ]
    for dkv_rec, dq_rec in [bwd_main] + bwd_recs:
        print("flash_attention_bwd_dkv", json.dumps(dkv_rec))
        print("flash_attention_bwd_dq", json.dumps(dq_rec))

    # ---- the main path: the flagship renders the score on the card ----
    cfg = flagship_config(tokenizer, T)
    model, _ = build_scoreperformer(cfg, device="cuda", seed=SEED)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flagship: {n_params} parameters, use_flash=True")

    renders = {}
    for mode, kwargs in (("greedy", {"greedy": True}), ("top-k", {"filter_kwargs": {"thres": 0.9}})):
        reset_counts(fa, kv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perf = render_performance(model, tokenizer, score, seed=SEED, device="cuda", **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"write_kv": kv.write_kv.launches, **flash_counts(fa)}
        renders[mode] = (perf, launches, wall)
        print(f"render {mode}: {wall:.3f} s wall, {perf.num_notes} notes, launches {launches}")
        expected = {"write_kv": 2 * 4 * n_steps, "flash_attention_fwd": 2 + 4,
                    "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
        if launches != expected:
            raise AssertionError(f"{mode} render launched {launches}, expected {expected}")

    # ---- where a render's time goes: one more greedy render under the profiler ----
    prof = profile_device(torch, lambda: render_performance(model, tokenizer, score, seed=SEED,
                                                            device="cuda", greedy=True))
    print("profile greedy render", json.dumps(prof))

    # ---- the training path: the flagship takes train steps on the card ----
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "data")
    t0 = time.perf_counter()
    # 64-bar scores: every window of 16 bars from a sampled start fills 256 notes
    build_synthetic_dataset(root, n_scores=12, n_perfs_per_score=4, n_bars=64, seed=SEED, splits=True,
                            with_directions=False)
    comp = ExperimentComponents(train_config(tokenizer, root, os.path.join(work, "run"), TRAIN_BATCH, 2),
                                device="cuda").init_components()
    trainer = comp.trainer
    trainer._prepare()
    print(f"training: dataset of {len(comp.train_dataset)} windows written and loaded in "
          f"{time.perf_counter() - t0:.1f} s; flagship {sum(p.numel() for p in comp.model.parameters())} "
          f"parameters; batch {TRAIN_BATCH} x {TRAIN_SEQ + 2}")
    step_ms, train_launches, batch, notes = train_steps(torch, fa, kv, trainer, comp.train_dataset,
                                                        TRAIN_WARMUP, TRAIN_TIMED)
    median_ms = float(np.median(step_ms))
    train = {
        "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": TRAIN_BATCH * (TRAIN_SEQ + 2) / median_ms * 1e3,
        "valid_notes_per_s": float(np.mean(notes)) / median_ms * 1e3,
        "launches": train_launches, "steps": TRAIN_WARMUP + TRAIN_TIMED,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("train steps", json.dumps(train))
    prof_train = profile_device(torch, lambda: trainer.train_step(batch, TRAIN_WARMUP + TRAIN_TIMED),
                                ported=("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    if isinstance(prof_train["device_busy_ms"], float):
        prof_train["backward_kernels_share"] = sum(
            prof_train["ported"][k]["ms"] for k in ("flash_bwd_dkv", "flash_bwd_dq")) / prof_train["device_busy_ms"]
    print("profile train step", json.dumps(prof_train))
    # the trainer's own loop: two steps and the final checkpoint
    state = trainer.train()
    ckpt = load_checkpoint(os.path.join(work, "run", "checkpoint_last"))
    if state.global_step != 2 or ckpt["trainer_state"]["global_step"] != 2:
        raise AssertionError(f"Trainer.train() stopped at step {state.global_step}")
    losses = [h["train_step/loss"] for h in state.log_history if "train_step/loss" in h]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"Trainer.train() logged losses {losses}")
    print(f"Trainer.train(): 2 steps, logged losses {losses}, checkpoint {sorted(ckpt)}")
    host_batch = next(trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0))
    model_config = comp.model_config
    del comp, trainer, batch
    torch.cuda.empty_cache()

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

    # one train step on the card against the port's CPU path, same weights
    loss_err, grad_err, n_grads = compare_train_step(torch, model_config, host_batch)
    print(f"train step at batch 4, card vs CPU: loss error {loss_err:.3g}, largest gradient error over "
          f"its largest value {grad_err:.3g} ({n_grads} gradients)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3):
        raise AssertionError(f"the card's train step differs from the CPU's: loss {loss_err}, gradients {grad_err}")

    launches = renders["greedy"][1]
    bound_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "write_kv", "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/kv_cache.cu",
         "replaces": "scoreperformer_tpu/ops/kv_cache.py:34", "launches": launches["write_kv"],
         **{k: kv_main[k] for k in bound_keys}},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "scoreperformer_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "scoreperformer_tpu/ops/flash_attention.py:49",
         "launches": launches["flash_attention_fwd"],
         "launches_by_path": {"render_greedy": launches["flash_attention_fwd"],
                              "train_steps": train_launches["flash_attention_fwd"]},
         **{k: fa_main[k] for k in bound_keys}},
    ] + [
        {"name": name, "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": replaces, "launches": train_launches[name],
         "launches_by_path": {"render_greedy": launches[name], "train_steps": train_launches[name]},
         **{k: rec[k] for k in bound_keys}}
        for name, replaces, rec in (
            ("flash_attention_bwd_dkv", "scoreperformer_tpu/ops/flash_attention.py:135", bwd_main[0]),
            ("flash_attention_bwd_dq", "scoreperformer_tpu/ops/flash_attention.py:192", bwd_main[1]),
        )
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

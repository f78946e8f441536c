#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (scoreperformer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (`nvcc`); run it from the root of a
checkout. It
1. prints the card's name and power limit;
2. builds every CUDA kernel from `scoreperformer_tpu_torch/csrc/`;
3. holds each kernel against its plain PyTorch version on the card, at the
   render's, the training step's and the served batch's shapes (the served
   scores' valid lengths, batch-padding rows at valid length 1), and at
   edge cases (`prefix_attend` at head dims 16, 32, 64 and 128, and at the
   shapes of every path below; `write_kv` and `write_kv_pair` in every
   case), and times the kernel, the plain version and one PyTorch call of
   the same function (the yardstick; the port never calls it) by CUDA-graph
   replay, with the eager time beside (the two backward kernels also as a
   pair against one SDPA backward; the row writes also beside `copy_` and
   `index_copy_`); checks that every flash kernel, forward
   and backward, holds TF32 tensor-core instructions in its SASS
   (`cuobjdump -sass`) and that two calls of `prefix_attend` and of the
   backward give the same bits; sweeps `prefix_attend`'s split count at the
   served shape and at scale_1024's;
4. render path: builds the flagship ScorePerformer at full width (random
   weights from a seed, use_flash=True) and renders a 32-bar synthetic score
   through `render_performance`, greedy and top-k sampled, counting the
   kernel launches of each render, and profiles one more greedy render
   (one `prefix_attend` kernel a launch, no merge kernel);
5. training path: writes a synthetic dataset, builds the same flagship
   through `ExperimentComponents` from a config dict (the flagship recipe's
   data, collator and optimizer settings, batch 128, sequences of 258) and
   takes train steps through the `Trainer`, counting the flash forward and
   backward launches of each step; profiles one step; then one step at
   batch 4 on the card against the port's CPU path on the same weights;
6. the paper's recipe: writes a raw corpus of MIDI pairs, each piece with a
   MusicXML score carrying directions, prepares it with `python -m
   scoreperformer_tpu_torch.prepare_dataset --workers 4`, and trains the
   same flagship with recipes/scoreperformer/base.yaml's direction
   classifiers through `ExperimentComponents` and the `Trainer` (10 flash
   launches of each kind a step), profiles a step, reports an eval pass's
   per-group accuracy, checks `Trainer.train()`'s TensorBoard event file,
   and holds a batch-4 step on the card to the CPU path;
7. serving path: saves the flagship (random weights, `max_seq_len` covering
   the 384-note bucket) as a port checkpoint directory, starts a
   `RenderServer` on it, and serves 128 synthetic scores of 8-32 bars as one
   greedy batch through `handle_batch` and as 128 sampled requests from
   concurrent clients through the TCP coalescer; renders 16 of them with
   bf16 and int8 caches; profiles one batched render;
8. the recipes' other decoder head dims: a recipes/smoke.yaml-shaped model
   (2 heads of 16) renders an 8-bar score and serves 16 requests, and
   recipes/scoreperformer/scale_1024.yaml's model at full width (8 heads of
   128, 285M parameters) serves 32 requests with its `auto` (int8) caches,
   profiled once, each from a port checkpoint and against the CPU path;
9. checks the output: notes with the score's pitches and finite times (a
   served sampled rendition, or one from a bf16 or int8 cache, may leave a
   few notes out as "not performed"), and, on 4-bar scores, the same greedy
   tokens as the port's CPU path (one render, and a batch of four through
   the server; the smoke-shaped render and served batch; scale_1024's four
   4-bar requests with softmax_bf16 off); finite losses (the classifiers'
   too), and loss and gradients of the card's steps, with and without the
   classifiers, equal to the CPU's; every served response `ok`.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, ...}, printed only when every phase passed. Any failure exits
non-zero.
"""
import base64
import collections
import itertools
import json
import math
import os
import socket
import subprocess
import shutil
import sys
import threading
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
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
L2_BYTES = 50e6  # H100 L2: timed inputs cycle through copies that exceed it
CHUNK = 16  # the chunked decode's chunk, as the render and the server use it
DECODER_LAYERS = 4
# the served cell: 128 scores of 8, 16, 24 and 32 bars in turn (seeds 0-127);
# the longest has 364 notes, so every batch pads to the 384 bucket
SERVE_REQUESTS = 128
SERVE_BARS = (8, 16, 24, 32)
SERVE_BUCKET = 384
SERVE_ALONE = 4  # requests of the greedy batch rendered again one by one
SERVE_DTYPE_REQUESTS = 16  # requests rendered with bf16 and int8 caches
# the smoke-shaped (d = 16) and scale_1024 (d = 128) served batches: the
# first requests of the served cell
SMOKE_REQUESTS = 16
SCALE_REQUESTS = 32
# the TCP coalescer's window: it closes at 128 requests, so it only has to
# outlast 128 client threads connecting on a busy host (2 s did not, once)
SERVE_WINDOW_MS = 60000.0
# the share of a score's notes that a served sampled rendition, or one from a
# bf16 or int8 cache, may leave out as "not performed"; greedy fp32 ones and
# the render phase's leave none
MAX_LEFT_OUT = 0.1
# kernel names (substrings) in a render's profile; prefix_attend is one
# kernel a launch (its clusters merge the splits), with no merge kernel
PORTED_DECODE = ("prefix_attend", "write_rows", "flash_fwd")
PORTED_TRAIN = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# the paper-recipe phase: a raw corpus of MIDI pairs (12 pieces, 4
# performances each, 64 bars, as the train phase's dataset), each piece with
# a score.musicxml; the direction groups its classifiers learn, named by the
# MusicXML keyword tables; recipes/scoreperformer/base.yaml's classifiers
PAPER_PIECES, PAPER_PERFS, PAPER_BARS = 12, 4, 64
PAPER_GROUPS = {"dynamics": ["dynamic/p", "dynamic/f"], "hairpins": ["dynamic/crescendo"],
                "tempo": ["tempo/allegro", "tempo/andante"], "articulations": ["articulation/staccato"]}
PAPER_CLASSIFIERS = {"classifier": {"hidden_dims": [], "dropout": 0.2}, "loss_weight": 1.0,
                     "weighted_classes": True, "detach_inputs": True}


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


def base_recipe_config(tokenizer, dim, emb_dims, depths, heads, latent_dim, enc_attn, dec_attn, max_seq_len,
                       max_segments):
    """recipes/scoreperformer/base.yaml's resolved `model:` node with the
    widths a recipe sets on it, written out (the card's machine may have no
    PyYAML) and without the direction classifiers, which serving does not
    build; vocab sizes and token values come from the tokenizer, as training
    injects them. tests/test_torch_recipes.py holds it to the recipes."""
    token_values = {k: v.tolist() for k, v in tokenizer.token_values(normalize=True).items()}
    emb = {"_target_": "simple", "emb_dims": emb_dims, "mode": "cat", "emb_norm": True, "discrete": False,
           "continuous": True, "continuous_dense": True, "discrete_ids": [0, 1, 2, 3], "token_values": token_values}
    ff = {"mult": 4, "glu": True, "swish": True, "dropout": 0.1}

    def stack(target, depth, attn):
        return {"_target_": target, "depth": depth, "heads": heads, "attention": dict(attn), "feed_forward": dict(ff)}

    common = {"emb_norm": True, "emb_dropout": 0, "use_abs_pos_emb": False, "max_seq_len": max_seq_len}
    return {
        "num_tokens": tokenizer.performance_sizes, "num_score_tokens": tokenizer.score_sizes,
        "dim": dim, "tie_token_emb": True, "mode": "mixlm",
        "score_encoder": {"token_embeddings": dict(emb), **common, "transformer": stack("encoder", depths[0], enc_attn)},
        "perf_encoder": {"token_embeddings": dict(emb), **common, "max_segments": max_segments,
                         "latent_dim": list(latent_dim),
                         "aggregate_mode": ["mean", "bar_mean", "beat_mean", "onset_mean"],
                         "latent_dropout": [0.0, 0.1, 0.2, 0.4], "hierarchical": True,
                         "inclusive_latent_dropout": True, "deadpan_zero_latent": True, "loss_weight": 1.0,
                         "transformer": stack("encoder", depths[1], enc_attn)},
        "perf_decoder": {"token_embeddings": {**emb, "_target_": "multi-seq", "multiseq_mode": "post-cat"}, **common,
                         "context_emb_mode": "cat", "style_emb_dim": list(latent_dim), "style_emb_mode": "adanorm",
                         "transformer": stack("decoder", depths[2], dec_attn), "lm_head": {"_target_": "lm-tied"}},
    }


def smoke_config(tokenizer, n_notes):
    """recipes/smoke.yaml's model (dim 64, one layer a stack, 2 heads of 16,
    one KV head), with positions and segments for `n_notes` notes (the
    recipe's 50 fit its 48-note training windows, not a served bucket)."""
    attn = {"dim_head": 16, "one_kv_head": True, "dropout": 0.1, "alibi_pos_bias": True, "alibi_learned": True}
    return base_recipe_config(tokenizer, dim=64, emb_dims=32, depths=(1, 1, 1), heads=2, latent_dim=(8, 6, 4, 2),
                              enc_attn=attn, dec_attn=attn, max_seq_len=n_notes + 2, max_segments=n_notes + 4)


def scale_1024_config(tokenizer):
    """recipes/scoreperformer/scale_1024.yaml's model at full width: dim
    1024, encoders 4 and 6 deep with 8 heads of 64 (its attention node
    replaces the base's, so no ALiBi and no shared KV head), a decoder of 8
    layers with 8 heads of 128 and one KV head, every attention layer with
    fused_mask_select and softmax_bf16; 285M parameters with the
    SPMupleWindow vocabularies."""
    levers = {"fused_mask_select": True, "softmax_bf16": True}
    dec_attn = {"dim_head": 128, "one_kv_head": True, "dropout": 0.1, "alibi_pos_bias": True, "alibi_learned": True,
                **levers}
    return base_recipe_config(tokenizer, dim=1024, emb_dims=256, depths=(4, 6, 8), heads=8,
                              latent_dim=(64, 40, 16, 8), enc_attn=levers, dec_attn=dec_attn, max_seq_len=1026,
                              max_segments=1028)


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


def check_write_kv(torch, kv, cap, n, b, dim, index, cache_dtype, timed, pair=False):
    """`write_kv` (or, with `pair`, `write_kv_pair` into a K and a V cache)
    vs its plain version on copies of the same caches; bit-exact. Returns the
    record of this case (times only when `timed`: the kernel, the plain
    version, and the same rows written by `copy_` at a host start and by
    `index_copy_` with a device index tensor, once a cache, all by CUDA-graph
    replay)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    n_caches = 2 if pair else 1
    caches = [torch.randn(cap, b, dim, device=dev, generator=g).to(cache_dtype) for _ in range(n_caches)]
    news = [torch.randn(n, b, dim, device=dev, generator=g) for _ in range(n_caches)]
    idx = torch.tensor([index], dtype=torch.int64, device=dev)

    def kernel(cs, xs, i=idx):
        return kv.write_kv_pair(*cs, *xs, i) if pair else (kv.write_kv(cs[0], xs[0], i),)

    def plain(cs, xs, i):
        return tuple(kv.write_kv_plain(c, x, i) for c, x in zip(cs, xs))

    got = kernel([c.clone() for c in caches], news)
    want = plain([c.clone() for c in caches], news, idx)
    torch.cuda.synchronize()
    name = "write_kv_pair" if pair else "write_kv"
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version at {(cap, n, b, dim, index, cache_dtype)}")
    rec = {"name": name, "shape": [n, b, dim], "cap": cap, "index": index, "dtype": str(cache_dtype),
           "max_abs_err": 0.0}
    if timed:
        start = min(max(index + cap if index < 0 else index, 0), cap - n)
        rows = torch.arange(start, start + n, device=dev)  # index_copy_'s device index
        # each new row read once, written once into its cache, and the start
        nbytes = n_caches * news[0].numel() * (news[0].element_size() + caches[0].element_size()) + idx.element_size()
        copies = [([c.clone() for c in caches], [x.clone() for x in news])
                  for _ in range(n_copies(n_caches * caches[0].numel() * caches[0].element_size()))]
        rec["ms"] = graph_ms(torch, kernel, copies, iters=200)
        # the plain version reads a device index with a host sync, which a
        # graph cannot hold: it is given the same start as a host int
        rec["plain_ms"] = graph_ms(torch, lambda cs, xs: plain(cs, xs, index), copies, iters=200)
        rec["copy_ms"] = graph_ms(torch, lambda cs, xs: [c[start : start + n].copy_(x) for c, x in zip(cs, xs)],
                                  copies, iters=200)
        rec["index_copy_ms"] = graph_ms(torch, lambda cs, xs: [c.index_copy_(0, rows, x.to(c.dtype))
                                                               for c, x in zip(cs, xs)], copies, iters=200)
        # one PyTorch call of the same function: copy_ of one cache's rows,
        # or one _foreach_copy_ of both caches' rows
        rec["library_ms"] = graph_ms(
            torch, lambda cs, xs: torch._foreach_copy_([c[start : start + n] for c in cs], xs), copies,
            iters=200) if pair else rec["copy_ms"]
        rec["eager_ms"] = time_ms(torch, lambda: kernel(caches, news), iters=200)
        del copies
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


def key_mask(torch, b, t, padded, lengths, g):
    """(b, t) key validity: the given `lengths` (or (first, end) key ranges),
    else random valid lengths from `g` when `padded` (batch element 0 has
    none when it is "empty"), else all keys."""
    dev = "cuda"
    pos = torch.arange(t, device=dev)[None]
    first = torch.zeros(b, 1, dtype=torch.int64, device=dev)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
        if lengths.ndim == 2:
            first, lengths = lengths[:, :1], lengths[:, 1]
    elif padded:
        lengths = torch.randint(1, t + 1, (b,), device=dev, generator=g)
        if padded == "empty":
            lengths[0] = 0
    else:
        lengths = torch.full((b,), t, device=dev)
    return (pos >= first) & (pos < lengths[:, None])


def check_flash(torch, fa, b, t, causal, padded, timed, h=4, d=64, lengths=None, hk=1):
    """Kernel vs plain at fp32, max abs error of o and lse <= 1e-4, with
    random valid lengths when `padded` (batch element 0 has none when it is
    "empty"), or the given `lengths` (or (first, end) key ranges), and `hk`
    KV heads. Returns the record of this shape (times only when `timed`)."""
    import torch.nn.functional as F

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, h, t, d, device=dev, generator=g)
    k = torch.randn(b, hk, t, d, device=dev, generator=g)
    v = torch.randn(b, hk, t, d, device=dev, generator=g)
    slopes = torch.rand(h, device=dev, generator=g) * 0.5
    mask = key_mask(torch, b, t, padded, lengths, g)
    o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask=mask, causal=causal)
    po, plse = fa.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    err = max((o - po).abs().max().item(), (lse - plse).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"flash attention differs from its plain version by {err} at {(b, t, causal, padded)}")
    rec = {"shape": [b, h, t, d], "kv_heads": hk, "causal": causal, "padded": padded, "max_abs_err": err}
    if timed:
        # device time by graph replay over copies of q, k, v larger than L2
        nbytes_qkv = 4 * (q.numel() + k.numel() + v.numel())
        copies = [(q.clone(), k.clone(), v.clone()) for _ in range(n_copies(nbytes_qkv))]
        rec["ms"] = graph_ms(torch, lambda qc, kc, vc: fa.flash_attention_fwd(qc, kc, vc, slopes, mask, causal),
                             copies, iters=50)
        del copies
        rec["eager_ms"] = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, slopes, mask=mask, causal=causal))
        # the plain version syncs with the host (rows with no valid key), so a
        # graph cannot hold it: eager CUDA-event time
        rec["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal))
        rec["plain_timing"] = "eager"
        # yardstick: SDPA with the bias and masks materialized outside the timing
        bias, ok = sdpa_bias(torch, slopes, mask, causal)
        # SDPA reads outside expanded (stride-0) keys at odd t: copy them
        sdpa = [(q.clone(), k.expand(b, h, t, d).contiguous(), v.expand(b, h, t, d).contiguous())
                for _ in range(n_copies(3 * 4 * q.numel()))]
        rec["library_ms"] = graph_ms(
            torch, lambda qc, kc, vc: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=bias), sdpa, iters=50)
        del sdpa
        pairs = (ok.expand(b, 1, t, t)).sum().item()  # (query, key) pairs this data needs
        ops = 4 * d * h * pairs  # q.k and p.v, a multiply and an add each
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + h) + mask.numel()
        rec["bound_by"] = "operations" if ops / FP32_OPS_PER_S > nbytes / BYTES_PER_S else "bytes"
        rec["bound_ms"] = max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3
        # the same fp32-accurate work as three TF32 tensor-core products
        rec["bound_tc_ms"] = max(3 * ops / TF32_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3
    return rec


def flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk, lengths=None):
    """Inputs of one backward call on the card, with random valid lengths
    when `padded` (batch element 0 has none when it is "empty"), or the given
    `lengths` (or (first, end) key ranges). dout is nonzero on every row, rows
    with no valid key too, where JAX's gradient reaches the keys that its
    wrapper pads."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, h, t, d, device=dev, generator=g)
    k = torch.randn(b, hk, t, d, device=dev, generator=g)
    v = torch.randn(b, hk, t, d, device=dev, generator=g)
    slopes = torch.rand(h, device=dev, generator=g) * 0.5
    dout = torch.randn(b, h, t, d, device=dev, generator=g)
    return q, k, v, slopes, key_mask(torch, b, t, padded, lengths, g), dout


def check_flash_bwd(torch, fa, b, t, causal, padded, timed, h=4, d=64, hk=1, lengths=None):
    """Both backward kernels vs their plain versions on the kernel forward's
    lse: dq, dk, dv to 1e-4 and dslopes to 1e-3 of the plain version's largest
    value (the slope sum runs over b*h*t*t terms in another order), and two
    calls give the same bits. Returns the records of the dK/dV and the
    dQ/dslope kernel and of the pair at this shape; the kernels are timed by
    CUDA-graph replay when `timed`, beside one SDPA backward."""
    q, k, v, slopes, mask, dout = flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk, lengths)
    out, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal)
    delta = (dout * out).sum(-1)
    if t == 1:
        # with one key dS = dO.v - rowsum(dO * o) is 0 in exact arithmetic, so
        # dk, dq and dslopes would be rounding noise on both sides: the check
        # gives the kernels a delta of its own
        delta = torch.randn(delta.shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    args = (q, k, v, slopes, mask, dout, lse, delta, causal)
    got = fa.flash_attention_bwd_dkv(*args) + fa.flash_attention_bwd_dq(*args)
    again = fa.flash_attention_bwd_dkv(*args) + fa.flash_attention_bwd_dq(*args)
    want = fa.flash_attention_bwd_dkv_plain(*args) + fa.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    err = {name: ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
           for name, x, y in zip(("dk", "dv", "dq", "dslopes"), got, want)}
    limits = {"dk": 1e-4, "dv": 1e-4, "dq": 1e-4, "dslopes": 1e-3}
    bad = {n: e for n, e in err.items() if not e <= limits[n]}
    where = (b, t, causal, padded, d, hk)
    if bad:
        raise AssertionError(f"flash backward differs from its plain version at {where}: {bad}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"two flash backward calls give other bits at {where}")
    shape = {"shape": [b, h, t, d], "kv_heads": hk, "causal": causal, "padded": padded, "same_bits": True}
    dkv = {**shape, "max_abs_err": max(err["dk"], err["dv"]), "errors": err}
    dq = {**shape, "max_abs_err": max(err["dq"], err["dslopes"]), "errors": err}
    if not timed:
        return dkv, dq, None
    # device time by graph replay over copies of q, k, v and dout larger than L2
    copies = [(q.clone(), k.clone(), v.clone(), dout.clone())
              for _ in range(n_copies(4 * (q.numel() + k.numel() + v.numel() + dout.numel())))]
    rest = (slopes, mask)
    dkv["ms"] = graph_ms(torch, lambda qc, kc, vc, oc: fa.flash_attention_bwd_dkv(qc, kc, vc, *rest, oc, lse, delta, causal),
                         copies, iters=20)
    dq["ms"] = graph_ms(torch, lambda qc, kc, vc, oc: fa.flash_attention_bwd_dq(qc, kc, vc, *rest, oc, lse, delta, causal),
                        copies, iters=20)
    del copies
    dkv["eager_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(*args), iters=20)
    dq["eager_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq(*args), iters=20)
    dkv["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_plain(*args), iters=10, warmup=2)
    dq["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq_plain(*args), iters=10, warmup=2)
    dkv["plain_timing"] = dq["plain_timing"] = "eager"
    # yardstick: the backward alone of SDPA with the bias and masks
    # materialized; it computes both kernels' outputs in one call
    library, library_timing = sdpa_backward_ms(torch, q, k, v, dout, slopes, mask, causal)
    dkv["library_ms"] = dq["library_ms"] = library
    _, ok = sdpa_bias(torch, slopes, mask, causal)
    pairs = ok.expand(b, 1, t, t).sum().item()  # (query, key) pairs this data needs
    f32 = 4
    reads = f32 * (2 * q.numel() + k.numel() + v.numel() + 2 * lse.numel() + h) + mask.numel()
    parts = math.prod(fa.dq_slope_parts(b, h, hk, t))
    for rec, ops, writes in ((dkv, 8 * d * h * pairs, f32 * (k.numel() + v.numel())),
                             (dq, 6 * d * h * pairs, f32 * (q.numel() + parts))):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, (reads + writes) / BYTES_PER_S
        rec["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        # the same fp32-accurate work as three TF32 tensor-core products
        rec["bound_tc_ms"] = max(3 * ops / TF32_OPS_PER_S, t_bytes) * 1e3
    pair = {"name": "flash_attention_bwd_pair", **shape, "dkv_ms": dkv["ms"], "dq_ms": dq["ms"],
            "pair_ms": dkv["ms"] + dq["ms"], "library_ms": library, "library_timing": library_timing,
            "pair_over_library": (dkv["ms"] + dq["ms"]) / library,
            "bound_ms": dkv["bound_ms"] + dq["bound_ms"], "bound_tc_ms": dkv["bound_tc_ms"] + dq["bound_tc_ms"]}
    return dkv, dq, pair


def sdpa_backward_ms(torch, q, k, v, dout, slopes, mask, causal, iters=10):
    """Device time of one backward of SDPA (bias and masks materialized, keys
    and values contiguous per head) and how it was taken: "graph" when
    `torch.autograd.grad` can be captured in a CUDA graph (the forward runs
    on the capturing stream, so its backward is launched there), else
    "eager"."""
    import torch.nn.functional as F

    b, h, t, d = q.shape
    bias, _ = sdpa_bias(torch, slopes, mask, causal)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [x.detach().expand(b, h, t, d).contiguous().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        for _ in range(3):
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                torch.autograd.grad(out, leaves, dout, retain_graph=True)
        ms = time_ms(torch, graph.replay, iters=5, warmup=1) / iters
        del graph
        return ms, "graph"
    except RuntimeError as exc:
        print(f"SDPA backward cannot be captured in a CUDA graph ({str(exc).splitlines()[0]}): timed eagerly")
        torch.cuda.synchronize()
        return time_ms(torch, lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True),
                       iters=iters, warmup=2), "eager"


def graph_ms(torch, fn, arg_sets, iters):
    """Device time of one call: `iters` calls, cycling through `arg_sets`
    (copies of the inputs that together exceed the L2 cache, as the decode
    finds a layer's prefix after the other layers' work), captured in one
    CUDA graph and replayed under CUDA events, so the host's cost of a
    launch, larger than a decode attend's device time, is left out."""
    cycle = itertools.cycle(arg_sets)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*next(cycle))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*next(cycle))
    ms = time_ms(torch, graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def n_copies(nbytes):
    return max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))


def check_prefix_attend(torch, pa, b, cap, base, timed, dtype="fp32", h=4, d=64, kvh=1):
    """Kernel vs plain over the first `base` slots of a (cap, b, kvh*d)
    cache, with an ALiBi bias up to `base` and -1e9 from there: max abs
    error of o and lse <= 1e-4. Returns the record of this case (times only
    when `timed`)."""
    import torch.nn.functional as F
    from scoreperformer_tpu_torch.models.attention import quantize_kv_rows

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, h, d, device=dev, generator=g) * d**-0.5
    k = torch.randn(cap, b, kvh * d, device=dev, generator=g)
    v = torch.randn(cap, b, kvh * d, device=dev, generator=g)
    slopes = torch.rand(h, device=dev, generator=g) * 0.5
    pos = torch.arange(cap, device=dev)
    bias = torch.where(pos[None] < base, -slopes[:, None] * (base - pos[None]).float(),
                       torch.full((), -1e9, device=dev)).contiguous()
    scales = (None, None)
    if dtype == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif dtype == "int8":
        (k, k_s), (v, v_s) = quantize_kv_rows(k), quantize_kv_rows(v)
        scales = (k_s.contiguous(), v_s.contiguous())
    o, lse = pa.prefix_attend(q, k, v, bias, *scales, n_valid=base)
    o2, lse2 = pa.prefix_attend(q, k, v, bias, *scales, n_valid=base)
    po, plse = pa.prefix_attend_plain(q, k, v, bias, *scales, n_valid=base)
    torch.cuda.synchronize()
    err = max((o - po).abs().max().item(), (lse - plse).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"prefix_attend differs from its plain version by {err} at "
                             f"{(b, cap, base, dtype, h, d, kvh)}")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"two prefix_attend calls give other bits at {(b, cap, base, dtype, h, d, kvh)}")
    splits, _ = pa.split_plan(b, base, torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {"shape": [b, h, d], "cap": cap, "base": base, "dtype": dtype, "kv_heads": kvh, "splits": splits,
           "max_abs_err": err, "same_bits": True}
    if timed:
        # the bytes this call needs: the first `base` rows of k and v (and
        # their scales), q, the bias columns it reads, o and lse
        read = 2 * base * b * kvh * d * k.element_size() + (2 * base * b * 4 if dtype == "int8" else 0)
        nbytes = read + 4 * (2 * q.numel() + h * base + b * h)
        ops = 4 * d * h * b * base  # q.k and p.v, a multiply and an add each
        copies = [(k.clone(), v.clone()) for _ in range(n_copies(read))]
        rec["ms"] = graph_ms(torch, lambda kc, vc: pa.prefix_attend(q, kc, vc, bias, *scales, n_valid=base),
                             copies, iters=200)
        rec["plain_ms"] = graph_ms(
            torch, lambda kc, vc: pa.prefix_attend_plain(q, kc, vc, bias, *scales, n_valid=base), copies, iters=50)
        # the same calls back to back without a graph: what a caller pays,
        # host included
        rec["eager_ms"] = time_ms(torch, lambda: pa.prefix_attend(q, k, v, bias, *scales, n_valid=base), iters=200)
        del copies
        if dtype in ("fp32", "bf16"):
            # yardstick: SDPA over the same slots in the cache's type,
            # contiguous (b, h, base, d) keys and values and the bias laid
            # out outside the timing
            def heads(x):
                x = x[:base].reshape(base, b, kvh, d).permute(1, 2, 0, 3)
                return x.expand(b, h, base, d).contiguous()

            q4 = q[:, :, None].to(k.dtype)
            mask4 = bias[None, :, None, :base].expand(b, h, 1, base).to(k.dtype).contiguous()
            sdpa = [(heads(k), heads(v)) for _ in range(n_copies(read * h // kvh))]
            rec["library_ms"] = graph_ms(
                torch, lambda kc, vc: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask4, scale=1.0),
                sdpa, iters=200)
        else:
            # no PyTorch call takes int8 keys and values with row scales
            rec["library_ms"] = None
        rec["bound_by"] = "operations" if ops / FP32_OPS_PER_S > nbytes / BYTES_PER_S else "bytes"
        rec["bound_ms"] = max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3
    return rec


def prefix_split_sweep(torch, pa, b=SERVE_REQUESTS, cap=SERVE_BUCKET, base=SERVE_BUCKET // 2, d=64, h=4):
    """Device ms of the prefix_attend kernel (fp32, one KV head) at the served
    shape against its split count, called at its C entry, with the cache
    cycling through copies larger than L2 ("cold") or one copy that stays in
    L2 ("warm"): what the split plan and the per-row cost rest on."""
    from scoreperformer_tpu_torch.ops import _build

    fn = _build.kernel("prefix_attend", "sp_prefix_attend")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(b, h, d, device="cuda", generator=g) * d**-0.5
    k = torch.randn(cap, b, d, device="cuda", generator=g)
    v = torch.randn(cap, b, d, device="cuda", generator=g)
    bias = torch.zeros(h, cap, device="cuda")
    o, lse = torch.empty(b, h, d, device="cuda"), torch.empty(b, h, device="cuda")
    cold = [(k.clone(), v.clone()) for _ in range(n_copies(2 * base * b * d * 4))]

    def ms(splits, copies):
        per = -(-base // splits)

        def call(kc, vc):
            err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bias.data_ptr(), None, None, o.data_ptr(),
                     lse.data_ptr(), b, h, 1, d, cap, base, splits, per, 0, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"prefix_attend: CUDA error {err}")

        return graph_ms(torch, call, copies, iters=200)

    return {"shape": [b, h, d], "cap": cap, "base": base,
            "plan": pa.split_plan(b, base, torch.cuda.get_device_properties(0).multi_processor_count)[0],
            "cold_ms": {n: ms(n, cold) for n in (1, 2, 4, 8, 16)},
            "warm_ms": {n: ms(n, [(k, v)]) for n in (1, 4)}}


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


def reset_counts(fa, kv, pa):
    kv.write_kv.launches = kv.write_kv_pair.launches = pa.prefix_attend.launches = 0
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd_dkv.launches = fa.flash_attention_bwd_dq.launches = 0


def all_counts(fa, kv, pa):
    return {"write_kv": kv.write_kv.launches, "write_kv_pair": kv.write_kv_pair.launches,
            "prefix_attend": pa.prefix_attend.launches, **flash_counts(fa)}


def decode_launches(n_steps, layers=DECODER_LAYERS, flash=2 + 4):
    """The launches of one render, any batch: `flash` flash forwards (the
    flagship's: one per encoder layer, 2 score and 4 MMD; none without
    use_flash), then a chunked decode of `n_steps` steps with one
    `write_kv_pair` (the layer's K and V rows) and one `prefix_attend` per
    decoder layer and step; no single `write_kv` and no backward."""
    return {"write_kv": 0, "write_kv_pair": layers * n_steps, "prefix_attend": layers * n_steps,
            "flash_attention_fwd": flash, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}


def check_launches(what, got, expected):
    if got != expected:
        raise AssertionError(f"{what} launched {got}, expected {expected}")


def train_steps(torch, fa, kv, pa, trainer, dataset, n_warmup, n_timed):
    """Train steps through `Trainer.train_step` on the trainer's own batches;
    every step's losses must be finite and launch 10 flash forwards and 10 of
    each backward kernel. Returns (step times in ms, launch totals, the last
    device batch, valid notes per batch, the last step's metrics)."""
    n = n_warmup + n_timed
    batches, epoch = [], 0
    while len(batches) < n:
        batches += list(trainer._iter_batches(dataset, trainer.config.batch_size, True, epoch))
        epoch += 1
    times, notes = [], []
    reset_counts(fa, kv, pa)
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
        clf = "".join(f" {k} {v:.5f}" for k, v in values.items() if k.startswith("clf"))
        print(f"train step {step}: loss {values['loss']:.5f} grad_norm {values['stats/grad_norm']:.4f} "
              f"MMD {values['MMD']:.5f} lm {values['loss/lm']:.5f}{clf}")
    return times, all_counts(fa, kv, pa), batch, notes, values


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


def score_musicxml(n_bars, divisions=480):
    """A one-part 4/4 MusicXML score of `n_bars` measures of eight eighth
    notes, with directions every 8 and 16 measures (tests/test_musicxml.py's
    document widened to a piece): p or f in turn from measure 5 on, every
    8 measures, a crescendo wedge over two measures every 8, "Allegro." or
    "Andante" in turn from measure 5 on, every 8, and staccato on every note
    of every 4th measure; the first 4 measures carry no dynamic and no
    tempo word. At 480 divisions a quarter, its positions are the score
    MIDI's ticks."""
    eighth = divisions // 2
    measures = []
    for m in range(n_bars):
        parts = [f'<measure number="{m + 1}">']
        if m == 0:
            parts.append(f"<attributes><divisions>{divisions}</divisions>"
                         "<time><beats>4</beats><beat-type>4</beat-type></time></attributes>")
        if m % 8 == 4:
            mark = "p" if m // 8 % 2 == 0 else "f"
            parts.append(f'<direction placement="below"><direction-type><dynamics><{mark}/></dynamics>'
                         "</direction-type><staff>1</staff></direction>")
        if m % 16 in (4, 12):
            word = "Allegro." if m % 16 == 4 else "Andante"
            parts.append(f"<direction><direction-type><words>{word}</words></direction-type></direction>")
        if m % 8 in (1, 3):
            wedge = "crescendo" if m % 8 == 1 else "stop"
            parts.append(f'<direction><direction-type><wedge type="{wedge}" number="1"/></direction-type></direction>')
        art = "<notations><articulations><staccato/></articulations></notations>" if m % 4 == 2 else ""
        for i in range(8):
            step = "CDEFGAB"[(m + i) % 7]
            parts.append(f"<note><pitch><step>{step}</step><octave>5</octave></pitch>"
                         f"<duration>{eighth}</duration>{art}</note>")
        parts.append("</measure>")
        measures.append("".join(parts))
    return ('<?xml version="1.0"?>\n<score-partwise version="3.1"><part id="P1">'
            + "\n".join(measures) + "</part></score-partwise>\n")


def write_raw_corpus(raw):
    """A raw corpus as a user brings one to `prepare_dataset`: a directory a
    piece with score.mid, perf<i>.mid and score.musicxml; the scores and
    performances are `build_synthetic_dataset`'s (the same generators,
    pitches and tempos)."""
    from scoreperformer_tpu_torch.data import synthetic_performance, synthetic_score
    from scoreperformer_tpu_torch.midi import write_midi

    rng = np.random.RandomState(SEED)
    for si in range(PAPER_PIECES):
        piece = os.path.join(raw, f"piece{si:02d}")
        os.makedirs(piece)
        score = synthetic_score(rng, n_bars=PAPER_BARS, base_pitch=44 + 4 * si)
        write_midi(score, os.path.join(piece, "score.mid"))
        for pi in range(PAPER_PERFS):
            perf = synthetic_performance(score, rng, tempo_base=float(rng.randint(90, 140)))
            write_midi(perf, os.path.join(piece, f"perf{pi}.mid"))
        with open(os.path.join(piece, "score.musicxml"), "w") as f:
            f.write(score_musicxml(PAPER_BARS))


def paper_config(tokenizer, root, out_dir, batch_size, max_steps):
    """The paper's recipe on the train phase's model: the flagship at full
    width with base.yaml's direction classifiers, on the prepared dataset at
    `root` with its direction labels."""
    cfg = train_config(tokenizer, root, out_dir, batch_size, max_steps)
    cfg["data"]["dataset"].update(performance_directions=os.path.join(root, "direction_classes.json"),
                                  score_directions_dict=os.path.join(root, "score_directions.json"))
    cfg["model"]["classifiers"] = json.loads(json.dumps(PAPER_CLASSIFIERS))
    return cfg


def paper_phase(torch, tokenizer, work):
    """The paper's recipe on the card: a raw corpus of MIDI pairs with
    MusicXML directions, prepared by `python -m
    scoreperformer_tpu_torch.prepare_dataset --workers 4`; the flagship with
    base.yaml's classifiers trained on it through `ExperimentComponents` and
    the `Trainer` (10 flash forwards and 10 of each backward kernel a step,
    finite classifier losses), one step profiled, an eval pass's per-group
    accuracy, `Trainer.train()` writing a TensorBoard event file, and a
    batch-4 step on the card against the port's CPU path, the classifier
    heads included. Returns the phase's record."""
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.training import EVALUATORS, ExperimentComponents, read_events

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):  # host seconds of each step of the phase
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    shutil.rmtree(work, ignore_errors=True)
    raw, root, run = (os.path.join(work, d) for d in ("raw", "data", "run"))
    write_raw_corpus(raw)
    lap("write_raw_corpus")
    cmd = [sys.executable, "-m", "scoreperformer_tpu_torch.prepare_dataset", "--input", raw, "--output", root,
           "--workers", "4", "--splits", "train=0.9,eval=0.1"]
    done = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    print(done.stdout.strip())
    if done.returncode != 0:
        raise AssertionError(f"prepare_dataset failed ({done.returncode}): {done.stderr[-2000:]}")
    lap("prepare_dataset")
    if not os.path.exists(os.path.join(root, "score_directions.json")):
        raise AssertionError("prepare_dataset wrote no score_directions.json")
    with open(os.path.join(root, "direction_classes.json"), "w") as f:
        json.dump(PAPER_GROUPS, f)
    comp = ExperimentComponents(paper_config(tokenizer, root, run, TRAIN_BATCH, 2), device="cuda").init_components()
    trainer, model = comp.trainer, comp.model
    trainer._prepare()
    lap("load_dataset_and_build")
    heads = {g: m.layers[-1].out_features for g, m in model.classifiers.heads.items()}
    rec = {"pieces": PAPER_PIECES, "performances": PAPER_PIECES * PAPER_PERFS, "bars": PAPER_BARS,
           "train_windows": len(comp.train_dataset), "eval_windows": len(comp.eval_dataset),
           "parameters": sum(p.numel() for p in model.parameters()), "heads": heads,
           "class_samples": comp.model_config["classifiers"]["class_samples"], "phase_s": phase_s}
    if list(heads) != list(PAPER_GROUPS):
        raise AssertionError(f"the model's heads {list(heads)} are not the direction groups {list(PAPER_GROUPS)}")
    labels = {}
    for name, dataset in (("train", comp.train_dataset), ("eval", comp.eval_dataset)):
        d = next(trainer._iter_batches(dataset, TRAIN_BATCH, False, 0))["directions"]
        labels[name] = {g: int((d[..., j] > 0).sum()) for j, g in enumerate(PAPER_GROUPS)}
    rec["labelled_notes_first_batch"] = labels
    print("paper recipe: corpus", json.dumps({k: v for k, v in rec.items() if k != "phase_s"}))
    if not all(n > 0 for counts in labels.values() for n in counts.values()):
        raise AssertionError(f"a direction group has no labelled note in the windows: {labels}")

    step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset,
                                                          TRAIN_WARMUP, TRAIN_TIMED)
    lap("train_steps")
    median_ms = float(np.median(step_ms))
    rec["train"] = {"step_ms": step_ms, "median_step_ms": median_ms,
                    "tokens_per_s": TRAIN_BATCH * (TRAIN_SEQ + 2) / median_ms * 1e3,
                    "valid_notes_per_s": float(np.mean(notes)) / median_ms * 1e3, "launches": launches,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "last_step": {k: v for k, v in values.items() if k == "loss" or k.startswith("clf")}}
    print("paper recipe train steps", json.dumps(rec["train"]))
    prof = profile_device(torch, lambda: trainer.train_step(batch, TRAIN_WARMUP + TRAIN_TIMED), ported=PORTED_TRAIN)
    rec["profile"] = prof
    print("profile paper recipe train step", json.dumps(prof))
    counts = {name: prof["ported"][name]["count"] for name in PORTED_TRAIN}
    if counts != {name: 10 for name in PORTED_TRAIN}:
        raise AssertionError(f"the profiled step ran the flash kernels {counts} times, expected 10 of each")
    lap("profiled_step")

    evaluator = EVALUATORS.get("EmbeddingClassifierEvaluator")()
    eval_batch = trainer._put_batch(next(trainer._iter_batches(comp.eval_dataset, TRAIN_BATCH, False, 0)))
    model.eval()
    with torch.no_grad():
        out = model(**eval_batch, compute_loss=False)
    valid = eval_batch["perf_mask"]
    acc = evaluator(eval_batch["directions"][valid], {g: lg[valid] for g, lg in out.classifiers.logits.items()})
    rec["eval"] = {"accuracy_valid_notes": {k: float(v) for k, v in acc.items()},
                   **{k: v for k, v in trainer.evaluate().items() if k == "eval/loss" or k.startswith("eval/clf")}}
    print("paper recipe eval", json.dumps(rec["eval"]))
    if not all(np.isfinite(v) for v in rec["eval"].values() if isinstance(v, float)):
        raise AssertionError(f"paper recipe eval: non-finite values {rec['eval']}")
    lap("eval")

    state = trainer.train()
    events = sorted(f for f in os.listdir(os.path.join(run, "tb")) if f.startswith("events.out.tfevents."))
    tags = {v["tag"] for f in events for e in read_events(os.path.join(run, "tb", f)) for v in e.get("summary", [])}
    rec["tensorboard"] = {"event_files": events, "has_clf": "train_step/clf" in tags, "tags": len(tags)}
    print(f"paper recipe Trainer.train(): {state.global_step} steps; TensorBoard {json.dumps(rec['tensorboard'])}")
    if state.global_step != 2 or len(events) != 1 or not rec["tensorboard"]["has_clf"]:
        raise AssertionError(f"Trainer.train() stopped at {state.global_step} or wrote no classifier loss to {events}")
    lap("trainer_train")

    host_batch = next(trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0))
    # dropout off: the card and the CPU draw its masks from different streams
    model_config = json.loads(json.dumps(comp.model_config))
    model_config["classifiers"]["classifier"]["dropout"] = 0.0
    del comp, trainer, model, batch, eval_batch, out
    torch.cuda.empty_cache()
    loss_err, grad_err, n_grads = compare_train_step(torch, model_config, host_batch)
    rec["card_vs_cpu"] = {"loss_err": loss_err, "grad_err": grad_err, "gradients": n_grads}
    print(f"paper recipe train step at batch 4, card vs CPU: loss error {loss_err:.3g}, largest gradient error "
          f"over its largest value {grad_err:.3g} ({n_grads} gradients, the classifier heads' included)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3):
        raise AssertionError(f"the paper recipe's step on the card differs from the CPU's: loss {loss_err}, "
                             f"gradients {grad_err}")
    lap("card_vs_cpu")
    return rec


def profile_device(torch, fn, ported=("write_rows", "flash_fwd"), top=10):
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI),
    the device's busy time, its idle share of the profiled wall time, and the
    totals of the ported kernels (by kernel-name substring). The device
    events (kernels, copies, sets) are summed by name from the profiler's raw
    events: `key_averages()` would first build a Python object for every
    event, host operations included, which cost minutes of host time a run
    over the decode profiles' hundreds of thousands of kernels. `post_s`:
    the host seconds from the end of `fn` to the record (the profiler's stop
    and this sum)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    by_name = collections.defaultdict(lambda: [0, 0])  # kernel name -> [ns, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
            acc = by_name[e.name()]
            acc[0] += e.duration_ns()
            acc[1] += 1
    device = sorted(((name, ns / 1e6, n) for name, (ns, n) in by_name.items()), key=lambda x: -x[1])
    wall_ms = (t1 - t0) * 1e3
    busy_ms = sum(ms for _, ms, _ in device)
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if device else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if device else "not measured",
        "device_ops": sum(n for _, _, n in device),
        "top": [{"name": name[:70], "ms": ms, "count": n} for name, ms, n in device[:top]],
        "ported": {
            name: {"ms": sum(ms for _, ms, _ in hits), "count": sum(n for _, _, n in hits),
                   "kernels": sorted({k[:100] for k, _, _ in hits})}
            for name in ported
            for hits in [[e for e in device if name in e[0]]]
        },
        "post_s": time.perf_counter() - t1,
    }


def check_decode_profile(prof, what, expected):
    """The profile holds `expected["prefix_attend"]` prefix_attend kernels,
    one a launch, and no merge kernel, and one row-write kernel a
    `write_kv_pair` launch."""
    got = prof["ported"]["prefix_attend"]
    if got["count"] != expected["prefix_attend"] or any("merge" in name for name in got["kernels"]):
        raise AssertionError(f"{what}: prefix_attend kernels {got['kernels']} ran {got['count']} times, "
                             f"expected one kernel {expected['prefix_attend']} times")
    rows = prof["ported"]["write_rows"]
    if rows["count"] != expected["write_kv_pair"]:
        raise AssertionError(f"{what}: row-write kernels ran {rows['count']} times, expected one a "
                             f"write_kv_pair launch, {expected['write_kv_pair']}")


def tensor_core_counts(path, kernels):
    """The TF32 tensor-core instructions (HMMA ... TF32) in the SASS of the
    library at `path`, by kernel (a substring of its functions' names); fails
    when a function of one of them has none."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    by_function, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            by_function[name] = 0
        elif name is not None and "HMMA" in line and "TF32" in line:
            by_function[name] += 1
    counts = {}
    for kernel in kernels:
        functions = {f: n for f, n in by_function.items() if kernel in f}
        if not functions or not all(functions.values()):
            raise AssertionError(f"{kernel} in {path}: TF32 HMMA instructions by function {functions}")
        counts[kernel] = sum(functions.values())
    return counts


def check_performance(tokenizer, score_ids, perf, what, all_performed=True):
    """A rendered performance has the score's pitches and finite, ordered
    note times. With `all_performed` every score note is played; without,
    the notes whose Velocity came out as the tokenizer's "not performed"
    token are left out, so the pitches need only be the score's, and at most
    MAX_LEFT_OUT of the score's notes may be left out. Returns the number of
    score notes left out."""
    pitch_ids = np.asarray(score_ids)[:, tokenizer.types_idx["Pitch"]]
    src = collections.Counter((pitch_ids - tokenizer.zero_token + tokenizer.config.pitch_range[0]).tolist())
    notes = perf.all_notes()
    got = collections.Counter(notes.pitch.tolist())
    if (got != src) if all_performed else (got - src):
        raise AssertionError(f"{what}: {perf.num_notes} notes, pitches differ from the score's")
    if not (np.isfinite(notes.start).all() and np.isfinite(notes.end).all() and (notes.end >= notes.start).all()):
        raise AssertionError(f"{what}: note times are not finite and ordered")
    left_out = sum(src.values()) - perf.num_notes
    if left_out > MAX_LEFT_OUT * sum(src.values()):
        raise AssertionError(f"{what}: {left_out} of the score's {sum(src.values())} notes left out")
    return left_out


def served_inputs(tokenizer, n=SERVE_REQUESTS, bars=SERVE_BARS):
    """The served cell's scores (seeds 0..n-1, `bars` in turn) and their
    render inputs, as the server prepares them."""
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs

    scores = [synthetic_score(np.random.RandomState(s), n_bars=bars[s % len(bars)]) for s in range(n)]
    return scores, [prepare_render_inputs(tokenizer, sc) for sc in scores]


def save_port_checkpoint(tokenizer, cfg, work):
    """A port checkpoint directory under `work` (emptied first) of `cfg`'s
    model with random weights from SEED, the tokenizer beside it."""
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.training import save_checkpoint

    shutil.rmtree(work, ignore_errors=True)
    model, _ = build_scoreperformer(cfg, device="cpu", seed=SEED)
    ckpt = save_checkpoint(os.path.join(work, "checkpoint"), model, model_config={"_name_": "ScorePerformer", **cfg})
    tokenizer.save(os.path.join(ckpt, "tokenizer.json"))
    return ckpt


def greedy_tokens(torch, model, inputs, dev):
    """The greedy chunked decode's tokens for one score's render inputs on
    `dev`, through `mixedlm_unmask` as `render_performance` calls it."""
    from scoreperformer_tpu_torch.models.wrappers import mixedlm_unmask

    with torch.inference_mode():
        x = {k: torch.as_tensor(np.asarray(inputs[k])[None], dtype=torch.int64, device=dev)
             for k in ("deadpan_ids", "score_ids", "bars", "beats", "onsets", "tokens_in", "masked_all")}
        mask = torch.ones_like(x["bars"], dtype=torch.bool)
        score_emb, style_emb, _ = model.encode_embeddings(x["deadpan_ids"], mask, x["score_ids"], mask,
                                                          x["bars"], x["beats"], x["onsets"])
        return mixedlm_unmask(model, x["tokens_in"], x["masked_all"], style_embeddings=style_emb,
                              context=score_emb, greedy=True).cpu()


def token_agreement(out, ref, dims):
    """The share of the filled streams' tokens of `out` equal to `ref`'s,
    over render_batch results of the same requests."""
    same = sum(int((o["tokens"][1:, dims] == r["tokens"][1:, dims]).sum()) for o, r in zip(out, ref))
    return same / sum(r["tokens"][1:, dims].size for r in ref)


def smoke_render_score(tokenizer):
    """The smoke-shaped render's 8-bar score, its render inputs, and the
    capacity of its decode's caches (the render phase's `max(steps, T)`)."""
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs

    score = synthetic_score(np.random.RandomState(SEED + 2), n_bars=8)
    inputs = prepare_render_inputs(tokenizer, score)
    T = len(inputs["deadpan_ids"])
    return score, inputs, max(-(-(T - 1) // CHUNK) * CHUNK, T)


def smoke_phase(torch, tokenizer, work, scores, inputs):
    """recipes/smoke.yaml's model shape on the card, its decoder 2 heads of
    16 with one KV head (random weights, use_flash off as in the recipe):
    one greedy render of an 8-bar score, and a greedy served batch of the
    first SMOKE_REQUESTS `scores` (with their render `inputs`) through a
    `RenderServer` on a port checkpoint; each gives the port's CPU path's tokens and launches
    `prefix_attend` and `write_kv_pair` once per decoder layer and step.
    Returns the phase's record."""
    from scoreperformer_tpu_torch.inference import RenderServer, load_model_from_checkpoint, render_performance
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    cfg = smoke_config(tokenizer, SERVE_BUCKET)
    layers = cfg["perf_decoder"]["transformer"]["depth"]
    ckpt = save_port_checkpoint(tokenizer, cfg, work)
    rec = {"decoder": {"layers": layers, "heads": 2, "dim_head": 16, "kv_heads": 1}}

    score, score_inputs, _ = smoke_render_score(tokenizer)
    n_steps = -(-(len(score_inputs["deadpan_ids"]) - 1) // CHUNK) * CHUNK
    models = {dev: load_model_from_checkpoint(ckpt, device=dev)[0] for dev in ("cuda", "cpu")}
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perf = render_performance(models["cuda"], tokenizer, score, seed=SEED, device="cuda", greedy=True)
    torch.cuda.synchronize()
    rec["render"] = {"bars": 8, "notes": perf.num_notes, "wall_s": time.perf_counter() - t0,
                     "launches": all_counts(fa, kv, pa),
                     "notes_not_performed": check_performance(tokenizer, score_inputs["score_ids"], perf,
                                                              "smoke-shaped render", all_performed=False)}
    check_launches("the smoke-shaped render", rec["render"]["launches"], decode_launches(n_steps, layers, 0))
    same = torch.equal(*(greedy_tokens(torch, m, score_inputs, dev) for dev, m in models.items()))
    print(f"smoke-shaped render of 8 bars, card vs CPU: identical tokens={same}")
    if not same:
        raise AssertionError("the smoke-shaped model's greedy tokens on the card differ from the CPU path's")
    del models

    requests = [dict(score_midi=sc, greedy=True) for sc in scores[:SMOKE_REQUESTS]]
    server = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cuda")
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.render_batch(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(fa, kv, pa)
    check_launches("the smoke-shaped served batch", launches, decode_launches(-(-(SERVE_BUCKET - 1) // CHUNK) * CHUNK,
                                                                             layers, 0))
    left_out = sum(check_performance(tokenizer, inputs[i]["score_ids"], r["perf"], f"smoke-shaped served request {i}",
                                     all_performed=False) for i, r in enumerate(out))
    on_cpu = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cpu").render_batch(requests)
    same = all(np.array_equal(a["tokens"], b["tokens"]) for a, b in zip(out, on_cpu))
    rec["served"] = {"requests": len(requests), "wall_s": wall, "notes": sum(r["notes"] for r in out),
                     "notes_not_performed": left_out, "launches": launches, "identical_to_cpu": same}
    print("smoke-shaped served batch", json.dumps(rec["served"]))
    if not same:
        raise AssertionError("the smoke-shaped served batch's greedy tokens on the card differ from the CPU server's")
    return rec


def set_softmax_bf16(model, flag):
    """Turn every attention layer's softmax_bf16 on or off (the weights stay)."""
    from scoreperformer_tpu_torch.models.attention import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            m.softmax_bf16 = flag


def scale_1024_phase(torch, tokenizer, work, scores, inputs):
    """recipes/scoreperformer/scale_1024.yaml's model at full width on the
    card (random weights from SEED) through a `RenderServer` on a port
    checkpoint: the first SCALE_REQUESTS `scores` served greedy through
    `handle_batch` with the `auto` caches (int8 at dim 1024), every response
    ok; the share of tokens on which int8 agrees with fp32 caches (not
    gated); a profiled int8 batch; then four 4-bar requests through the
    card's server and the CPU's with fp32 caches, with softmax_bf16 off
    (gated: identical tokens) and on (the share of equal tokens: bf16
    rounds differently on the two devices). Returns the phase's record."""
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import RenderServer
    from scoreperformer_tpu_torch.midi import read_midi, write_midi
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):  # host seconds of each step of the phase
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    cfg = scale_1024_config(tokenizer)
    layers = cfg["perf_decoder"]["transformer"]["depth"]
    ckpt = save_port_checkpoint(tokenizer, cfg, work)
    lap("build_and_save_checkpoint")
    server = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, cache_dtype="auto", device="cuda")
    lap("load_on_card")
    n_params = sum(p.numel() for p in server.model.parameters())
    rec = {"parameters": n_params, "cache_dtype": server.cache_dtype, "requests": SCALE_REQUESTS,
           "decoder": {"layers": layers, "heads": 8, "dim_head": 128, "kv_heads": 1}, "phase_s": phase_s}
    if server.cache_dtype != "int8":
        raise AssertionError(f"the server's auto caches at dim 1024 are {server.cache_dtype}, not int8")
    subset = scores[:SCALE_REQUESTS]
    reqs = [{"id": i, "score_b64": base64.b64encode(write_midi(sc, None)).decode("ascii"), "greedy": True}
            for i, sc in enumerate(subset)]
    expected = decode_launches(-(-(SERVE_BUCKET - 1) // CHUNK) * CHUNK, layers, 0)
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resps = server.handle_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(fa, kv, pa)
    lap("int8_batch")
    bad = [r for r in resps if not r.get("ok")]
    if bad:
        raise AssertionError(f"scale_1024 served batch: {len(bad)} responses not ok, first {bad[0]}")
    check_launches("the scale_1024 served batch", launches, expected)
    left_out = sum(check_performance(tokenizer, inputs[i]["score_ids"], read_midi(base64.b64decode(r["midi_b64"])),
                                     f"scale_1024 served request {i}", all_performed=False)
                   for i, r in enumerate(resps))
    notes = sum(r["notes"] for r in resps)
    rec["int8"] = {"wall_s": wall, "notes": notes, "notes_per_s": notes / wall, "notes_not_performed": left_out,
                   "launches": launches, "batched": sorted({r["batched"] for r in resps}),
                   "padded_to": sorted({r["padded_to"] for r in resps}), "timings_ms": resps[-1]["timings"]}
    print("scale_1024 served int8 batch", json.dumps(rec["int8"]))

    requests = [dict(score_midi=sc, greedy=True) for sc in subset]
    box = {}
    rec["profile"] = profile_device(torch, lambda: box.update(int8=server.render_batch(requests)),
                                    ported=PORTED_DECODE)
    print("profile scale_1024 served int8 batch", json.dumps(rec["profile"]))
    check_decode_profile(rec["profile"], "the scale_1024 served batch's profile", expected)
    lap("profiled_int8_batch")
    # fp32 caches; a length bucket of 64, so that the 4-bar scores below pad
    # to 64 (the CPU's decode of this model is slow), the served batch still
    # to 384
    card = RenderServer(ckpt, bucket=64, chunk_size=CHUNK, cache_dtype="fp32", device="cuda")
    rec["int8_agreement_with_fp32"] = token_agreement(box["int8"], card.render_batch(requests),
                                                      list(server.sample_dims))
    lap("fp32_batch")
    print(f"scale_1024 served batch: int8 caches agree with fp32 on {rec['int8_agreement_with_fp32']:.4f} "
          f"of the filled tokens")
    del server, box

    small = [dict(score_midi=synthetic_score(np.random.RandomState(1000 + i), n_bars=4), greedy=True)
             for i in range(4)]
    cpu = RenderServer(ckpt, bucket=64, chunk_size=CHUNK, cache_dtype="fp32", device="cpu")
    lap("load_on_cpu")
    rec["card_vs_cpu"] = {}
    for flag in (False, True):
        for srv in (card, cpu):
            set_softmax_bf16(srv.model, flag)
        t0 = time.perf_counter()
        on_card, on_cpu = card.render_batch(small), cpu.render_batch(small)
        rec["card_vs_cpu"][f"softmax_bf16={flag}"] = {
            "identical_requests": sum(np.array_equal(a["tokens"], b["tokens"]) for a, b in zip(on_card, on_cpu)),
            "token_agreement": token_agreement(on_card, on_cpu, list(card.sample_dims)),
            "padded_to": on_cpu[0]["padded_to"], "wall_s": time.perf_counter() - t0}
    lap("card_vs_cpu")
    print("scale_1024, four 4-bar requests, card vs CPU server (fp32 caches)", json.dumps(rec["card_vs_cpu"]))
    if rec["card_vs_cpu"]["softmax_bf16=False"]["identical_requests"] != len(small):
        raise AssertionError("the scale_1024 model's greedy tokens on the card differ from the CPU server's")
    rec["launches"] = expected
    return rec


def serve_phase(torch, tokenizer, cfg, work, scores, inputs, bucket=SERVE_BUCKET):
    """The serving path on the card: a port checkpoint directory of `cfg`'s
    model, a `RenderServer` on it, the `scores` (with their render `inputs`)
    served greedy through `handle_batch` and sampled through the TCP
    coalescer from one client thread each; then agreement checks and a
    profile. Returns the phase's record."""
    from scoreperformer_tpu_torch import serve as serve_cli
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import RenderServer
    from scoreperformer_tpu_torch.midi import read_midi, write_midi
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    ckpt = save_port_checkpoint(tokenizer, cfg, work)
    n = len(scores)
    rec = {"requests": n, "bars": list(SERVE_BARS)}

    t0 = time.perf_counter()
    server = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cuda")
    server.warmup([bucket], greedy_variants=(True, False), batch_sizes=(n,))
    rec["load_and_warmup_s"] = time.perf_counter() - t0
    score_ids = [x["score_ids"] for x in inputs]
    wire = [base64.b64encode(write_midi(sc, None)).decode("ascii") for sc in scores]
    n_steps = -(-(bucket - 1) // CHUNK) * CHUNK
    expected = decode_launches(n_steps)

    def check_responses(resps, what, all_performed):
        bad = [r for r in resps if not r.get("ok")]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} responses not ok, first {bad[0]}")
        left_out = sum(check_performance(tokenizer, score_ids[i], read_midi(base64.b64decode(r["midi_b64"])),
                                         f"{what} {i}", all_performed) for i, r in enumerate(resps))
        return sum(r["notes"] for r in resps), left_out

    # 1. one greedy batch of n through the wire layer
    greedy_reqs = [{"id": i, "score_b64": w, "greedy": True} for i, w in enumerate(wire)]
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = server.handle_batch(greedy_reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(fa, kv, pa)
    check_launches("the served greedy batch", launches, expected)
    notes, left_out = check_responses(greedy, "served greedy request", all_performed=True)
    rec["greedy"] = {"wall_s": wall, "notes": notes, "notes_per_s": notes / wall, "notes_not_performed": left_out,
                     "launches": launches,
                     "batched": sorted({r["batched"] for r in greedy}),
                     "padded_to": sorted({r["padded_to"] for r in greedy}),
                     # the last response's timings run from the batch's start
                     # through every request's detokenization; the rest of the
                     # wall is MIDI parsing before and MIDI writing after
                     "render_batch_ms": greedy[-1]["wall_ms"], "timings_ms": greedy[-1]["timings"]}
    print("serve greedy batch", json.dumps(rec["greedy"]))

    # 2. the same scores sampled (top-k 0.9), from n concurrent TCP clients
    srv, coalescer = serve_cli.make_tcp_server(server, "127.0.0.1", 0, max_batch=n, window_ms=SERVE_WINDOW_MS)
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    loop.start()
    port = srv.server_address[1]
    sampled, latency_ms = [None] * n, [None] * n

    def client(i):
        req = {"id": i, "score_b64": wire[i], "greedy": False, "seed": i,
               "temperature": 0.8 + 0.4 * i / max(1, n - 1)}
        with socket.create_connection(("127.0.0.1", port), timeout=600) as sock:
            t = time.perf_counter()
            sock.sendall((json.dumps(req) + "\n").encode())
            sampled[i] = json.loads(sock.makefile().readline())
            latency_ms[i] = (time.perf_counter() - t) * 1e3

    reset_counts(fa, kv, pa)
    clients = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for th in clients:
        th.start()
    for th in clients:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    srv.shutdown()
    srv.server_close()
    coalescer.stop()
    loop.join(timeout=60)
    if any(r is None for r in sampled):
        raise AssertionError(f"{sum(r is None for r in sampled)} TCP clients got no response")
    launches = all_counts(fa, kv, pa)
    notes, left_out = check_responses(sampled, "served sampled request", all_performed=False)
    batched = sorted({r["batched"] for r in sampled})
    if batched != [n]:
        raise AssertionError(f"the coalescer formed batches of {batched}, expected one of {n}")
    check_launches("the served sampled batch", launches, expected)
    rec["sampled_tcp"] = {"wall_s": wall, "notes": notes, "notes_per_s": notes / wall,
                          "notes_not_performed": left_out, "launches": launches,
                          "batched": batched, "latency_ms_p50": float(np.percentile(latency_ms, 50)),
                          "latency_ms_p99": float(np.percentile(latency_ms, 99))}
    print("serve sampled batch through TCP", json.dumps(rec["sampled_tcp"]))

    # 3. per-request agreement of the batch with renders one at a time (not
    # gated: fp32 products may sum in another order at another batch size)
    alone = [server.handle_request(greedy_reqs[i]) for i in range(SERVE_ALONE)]
    rec["greedy_alone_identical"] = [a["midi_b64"] == g["midi_b64"] for a, g in zip(alone, greedy)]
    print(f"served greedy batch vs the same requests alone: identical MIDI {rec['greedy_alone_identical']}")

    # 4. bf16 and int8 caches against fp32 on the first requests: the share
    # of filled tokens that agree (not gated: JAX's int8 is not bit-stable)
    subset = [dict(score_midi=sc, greedy=True) for sc in scores[:SERVE_DTYPE_REQUESTS]]
    ref = server.render_batch(subset)
    dims = list(server.sample_dims)
    rec["cache_dtypes"] = {}
    for dtype in ("bf16", "int8"):
        other = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, cache_dtype=dtype, device="cuda")
        reset_counts(fa, kv, pa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = other.render_batch(subset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(f"the served {dtype} batch", all_counts(fa, kv, pa), expected)
        for i, r in enumerate(out):
            check_performance(tokenizer, score_ids[i], r["perf"], f"served {dtype} request {i}", all_performed=False)
        rec["cache_dtypes"][dtype] = {"wall_s": wall, "greedy_agreement_with_fp32": token_agreement(out, ref, dims),
                                      "identical_requests": sum(np.array_equal(r["tokens"], w["tokens"])
                                                                for r, w in zip(out, ref))}
        del other
    print("served bf16 and int8 caches", json.dumps(rec["cache_dtypes"]))

    # 5. gate: four 4-bar requests through the card's server and the CPU's
    small = [dict(score_midi=synthetic_score(np.random.RandomState(1000 + i), n_bars=4), greedy=True)
             for i in range(4)]
    on_card = server.render_batch(small)
    on_cpu = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cpu").render_batch(small)
    same = all(np.array_equal(a["tokens"], b["tokens"]) for a, b in zip(on_card, on_cpu))
    print(f"served batch of four 4-bar requests, card vs CPU server: identical tokens={same}")
    if not same:
        raise AssertionError("the card's server gives other greedy tokens than the CPU's")

    # 6. where a served batch's time goes
    requests = [dict(score_midi=sc, greedy=True) for sc in scores]
    rec["profile"] = profile_device(torch, lambda: server.render_batch(requests),
                                    ported=PORTED_DECODE)
    print("profile served greedy batch", json.dumps(rec["profile"]))
    rec["launches"] = expected
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from scoreperformer_tpu_torch.data import build_synthetic_dataset, synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.ops import _build
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {path.stem}: {line.strip()}")
    hmma = {**tensor_core_counts(libs["flash_attention_fwd"], ("flash_fwd",)),
            **tensor_core_counts(libs["flash_attention_bwd"], ("flash_bwd_dkv", "flash_bwd_dq"))}
    print(f"TF32 tensor-core instructions (HMMA) in the SASS, by kernel: {json.dumps(hmma)}")

    # ---- the score and the render's shapes ----
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    score = synthetic_score(np.random.RandomState(SEED), n_bars=N_BARS)
    inputs = prepare_render_inputs(tokenizer, score)
    T = len(inputs["deadpan_ids"])
    n_steps = -(-(T - 1) // CHUNK) * CHUNK
    print(f"score: {N_BARS} bars, T={T} notes, {n_steps} decode steps")
    # the served cell's scores; a batch of them pads to the length bucket
    serve_scores, serve_inputs = served_inputs(tokenizer)
    serve_lens = [len(x["deadpan_ids"]) for x in serve_inputs]
    if -(-max(serve_lens) // 128) * 128 != SERVE_BUCKET:
        raise AssertionError(f"the served scores' longest has {max(serve_lens)} notes, not in the {SERVE_BUCKET} bucket")

    # ---- kernels against their plain versions ----
    # write_kv and write_kv_pair (every case both ways, timed at the
    # render's step, the served batch's step and a 2 MB write): the render's
    # fresh buffers; the served batch's, fp32 rows into fp32 (fp32 and int8
    # caches) or bf16 ones, at slots inside the chunk and clamped; the
    # scale_1024 served batch's (32 rows of 128); a cast into bf16; rows of a
    # length that is no multiple of 16 bytes (one element a unit)
    kv_cases = [(CHUNK, 1, 1, 64, idx, dt, idx == 5 and dt == torch.float32)
                for idx in (0, 5, CHUNK - 1, CHUNK + 3, -1) for dt in (torch.float32, torch.bfloat16)] + [
        (CHUNK, 1, SERVE_REQUESTS, 64, idx, dt, idx == 5 and dt == torch.float32)
        for idx in (0, 5, CHUNK - 1, CHUNK + 3, -1) for dt in (torch.float32, torch.bfloat16)] + [
        (CHUNK, 1, SCALE_REQUESTS, 128, 7, torch.float32, True), (CHUNK, 1, SCALE_REQUESTS, 128, -1, torch.bfloat16, False),
        (272, 16, 512, 64, 100, torch.float32, True), (272, 16, 512, 64, 300, torch.float32, False),
        (272, 16, 512, 64, 40, torch.bfloat16, False), (T, 1, 1, 64, T + 7, torch.float32, False),
        (10, 2, 3, 5, -3, torch.float32, False), (10, 2, 3, 5, 4, torch.bfloat16, False),
    ]
    kv_recs = [check_write_kv(torch, kv, cap, n, b, dim, idx, dt, timed, pair)
               for pair in (False, True) for cap, n, b, dim, idx, dt, timed in kv_cases]
    kv_main, pair_main = (next(r for r in kv_recs if r["name"] == name and "ms" in r)
                          for name in ("write_kv", "write_kv_pair"))
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
        # the served encoders: the served batch's valid lengths; a batch of
        # 112 padded to 128 with rows at valid_len 1; the warmup's batch
        check_flash(torch, fa, SERVE_REQUESTS, SERVE_BUCKET, causal=False, padded="served", timed=True,
                    lengths=serve_lens),
        check_flash(torch, fa, SERVE_REQUESTS, SERVE_BUCKET, causal=False, padded="served+pad", timed=False,
                    lengths=serve_lens[:SERVE_REQUESTS - 16] + [1] * 16),
        check_flash(torch, fa, SERVE_REQUESTS, SERVE_BUCKET, causal=False, padded="warmup", timed=False,
                    lengths=[1] * SERVE_REQUESTS),
        # one KV head per query head (blocks of one head): padded; causal with
        # an element that has no valid key
        check_flash(torch, fa, 4, 130, causal=False, padded=True, timed=False, hk=4),
        check_flash(torch, fa, 2, 300, causal=True, padded="empty", timed=False, hk=4),
        check_flash(torch, fa, 2, 77, causal=False, padded=True, timed=False, d=32),
    ] + [
        # t around the 16-row warp tiles and the 64-key tiles
        check_flash(torch, fa, 2, t, causal=c, padded=False, timed=False)
        for t in (1, 15, 17, 63, 65, 129) for c in (False, True)
    ] + [
        # key tiles skipped in long padded tails beside an element with no
        # valid key (the JAX average) in one batch; then keys that start late,
        # so early causal rows have none
        check_flash(torch, fa, 4, SERVE_BUCKET, causal=c, padded="tails", timed=False, lengths=[0, 3, 64, 130])
        for c in (False, True)
    ] + [
        check_flash(torch, fa, 3, 200, causal=True, padded="late", timed=False,
                    lengths=[(70, 200), (5, 90), (130, 131)]),
    ]
    for rec in kv_recs:
        print(rec["name"], json.dumps(rec))
    for rec in [fa_main] + fa_recs:
        print("flash_attention_fwd", json.dumps(rec))
    # the backward kernels at the training step's shapes (timed), padded or
    # not, causal, d=32, one KV head per query head, and rows with no valid key
    bwd_main = check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=True, timed=True)
    bwd_causal = check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded=True, timed=True)
    bwd_recs = [
        check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=False, timed=False),
        check_flash_bwd(torch, fa, 3, 77, causal=True, padded="empty", timed=False, d=32),
        check_flash_bwd(torch, fa, 2, 77, causal=False, padded=True, timed=False, d=32),
        check_flash_bwd(torch, fa, 4, 130, causal=False, padded=True, timed=False, hk=4),
        check_flash_bwd(torch, fa, 2, 300, causal=True, padded="empty", timed=False, hk=4),
    ] + [
        # t around the 16-row warp tiles, the 32-row streamed tiles and the
        # 64-row blocks
        check_flash_bwd(torch, fa, 2, t, causal=c, padded=False, timed=False)
        for t in (1, 15, 17, 63, 65, 129) for c in (False, True)
    ] + [
        # all-masked key blocks and tiles in long padded tails beside an
        # element with no valid key; then keys that start late, so early
        # causal rows have none and put P = 1 on masked key blocks
        check_flash_bwd(torch, fa, 4, SERVE_BUCKET, causal=c, padded="tails", timed=False, lengths=[0, 3, 64, 130])
        for c in (False, True)
    ] + [
        check_flash_bwd(torch, fa, 3, 200, causal=True, padded="late", timed=False,
                        lengths=[(70, 200), (5, 90), (130, 131)]),
    ]
    for dkv_rec, dq_rec, _ in [bwd_main, bwd_causal] + bwd_recs:
        print("flash_attention_bwd_dkv", json.dumps(dkv_rec))
        print("flash_attention_bwd_dq", json.dumps(dq_rec))
    for _, _, pair in (bwd_main, bwd_causal):
        print("flash_attention_bwd_pair", json.dumps(pair))
    # the prefix attend of the chunked decode: the served batch (timed in
    # fp32, bf16 and int8, halfway through its decode), the TPU script's
    # shape, the render's (b=1, the 32-bar score's cache), and the edges:
    # the first chunk (base 0, no slot read), the last, d=32, one KV head
    # per query head
    cap_render = max(n_steps, T)
    pa_main = check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, timed=True)
    pa_recs = [
        check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, timed=True, dtype=dt)
        for dt in ("bf16", "int8")
    ] + [
        check_prefix_attend(torch, pa, 512, 256, 256 - CHUNK, timed=True),
        check_prefix_attend(torch, pa, 1, cap_render, cap_render // 2, timed=True),
    ] + [
        check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dt)
        for b, cap in ((512, 256), (1, cap_render), (SERVE_REQUESTS, SERVE_BUCKET))
        for base in (0, CHUNK, 128, cap - CHUNK) for dt in ("fp32", "bf16", "int8")
    ] + [
        check_prefix_attend(torch, pa, 3, 100, 77, timed=False, dtype=dt, d=32) for dt in ("fp32", "int8")
    ] + [
        check_prefix_attend(torch, pa, 5, 100, base, timed=False, dtype=dt, kvh=4)
        for base in (0, 60) for dt in ("fp32", "bf16", "int8")
    ]
    # the recipes' other decoder head dims, one KV head: recipes/smoke.yaml's
    # 2 heads of 16 at the served shape; scale_1024's 8 heads of 128 over a
    # cache of 1024, timed in fp32 and in int8 (its served caches); bases
    # from the first chunk to the last
    pa_dims = [
        check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, timed=True, h=2, d=16),
        check_prefix_attend(torch, pa, 64, 1024, 512, timed=True, h=8, d=128),
        check_prefix_attend(torch, pa, 64, 1024, 512, timed=True, dtype="int8", h=8, d=128),
    ] + [
        check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dt, h=h, d=d)
        for b, cap, h, d in ((SERVE_REQUESTS, SERVE_BUCKET, 2, 16), (64, 1024, 8, 128))
        for base in (0, CHUNK, cap // 2, cap - CHUNK) for dt in ("fp32", "bf16", "int8")
    ]
    # and at the shapes the new paths give it, bases from the first chunk to
    # the last: the smoke-shaped render (b = 1) and served batch (b = 16);
    # scale_1024's served batch (b = 32, int8, and fp32 for the agreement
    # batch) and its card-vs-CPU gate (b = 4, a 64 bucket, fp32)
    cap_smoke = smoke_render_score(tokenizer)[2]
    pa_dims += [
        check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dt, h=h, d=d)
        for b, cap, h, d, dtypes in ((1, cap_smoke, 2, 16, ("fp32",)), (SMOKE_REQUESTS, SERVE_BUCKET, 2, 16, ("fp32",)),
                                     (SCALE_REQUESTS, SERVE_BUCKET, 8, 128, ("fp32", "int8")), (4, 64, 8, 128, ("fp32",)))
        for base in (0, CHUNK, cap // 2, cap - CHUNK) for dt in dtypes
    ]
    for rec in [pa_main] + pa_recs + pa_dims:
        print("prefix_attend", json.dumps(rec))
    print("prefix_attend split sweep", json.dumps(prefix_split_sweep(torch, pa)))
    print("prefix_attend split sweep, scale_1024's shape",
          json.dumps(prefix_split_sweep(torch, pa, b=64, cap=1024, base=512, d=128, h=8)))

    # ---- the main path: the flagship renders the score on the card ----
    cfg = flagship_config(tokenizer, T)
    model, _ = build_scoreperformer(cfg, device="cuda", seed=SEED)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flagship: {n_params} parameters, use_flash=True")

    renders = {}
    for mode, kwargs in (("greedy", {"greedy": True}), ("top-k", {"filter_kwargs": {"thres": 0.9}})):
        reset_counts(fa, kv, pa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perf = render_performance(model, tokenizer, score, seed=SEED, device="cuda", **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_counts(fa, kv, pa)
        renders[mode] = (perf, launches, wall)
        print(f"render {mode}: {wall:.3f} s wall, {perf.num_notes} notes, launches {launches}")
        check_launches(f"the {mode} render", launches, decode_launches(n_steps))

    # ---- where a render's time goes: one more greedy render under the profiler ----
    prof = profile_device(torch, lambda: render_performance(model, tokenizer, score, seed=SEED,
                                                            device="cuda", greedy=True), ported=PORTED_DECODE)
    print("profile greedy render", json.dumps(prof))
    check_decode_profile(prof, "the render's profile", decode_launches(n_steps))

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
    step_ms, train_launches, batch, notes, _ = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset,
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
                                ported=PORTED_TRAIN)
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

    if train_launches["prefix_attend"] or train_launches["write_kv"]:
        raise AssertionError(f"the train steps launched decode kernels: {train_launches}")

    # ---- the output is right ----
    for mode, (perf, _, _) in renders.items():
        check_performance(tokenizer, inputs["score_ids"], perf, f"{mode} render")

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
    small_inputs = prepare_render_inputs(tokenizer, synthetic_score(np.random.RandomState(SEED + 1), n_bars=4))
    same = torch.equal(greedy_tokens(torch, model, small_inputs, "cuda"),
                       greedy_tokens(torch, cpu_model, small_inputs, "cpu"))
    print(f"4-bar greedy render tokens, GPU kernels vs CPU plain: identical={same}")
    if not same:
        raise AssertionError("greedy tokens on the GPU differ from the port's CPU path")

    # one train step on the card against the port's CPU path, same weights
    loss_err, grad_err, n_grads = compare_train_step(torch, model_config, host_batch)
    print(f"train step at batch 4, card vs CPU: loss error {loss_err:.3g}, largest gradient error over "
          f"its largest value {grad_err:.3g} ({n_grads} gradients)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3):
        raise AssertionError(f"the card's train step differs from the CPU's: loss {loss_err}, gradients {grad_err}")
    del model, cpu_model
    torch.cuda.empty_cache()

    # ---- the paper's recipe: MIDI and MusicXML prepared, direction classifiers trained ----
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    t0 = time.perf_counter()
    paper = paper_phase(torch, tokenizer, os.path.join(build, "chip_smoke_paper"))
    print(f"paper recipe phase: {time.perf_counter() - t0:.1f} s")
    print("paper recipe", json.dumps({k: v for k, v in paper.items() if k != "profile"}))
    if paper["train"]["launches"]["prefix_attend"] or paper["train"]["launches"]["write_kv_pair"]:
        raise AssertionError(f"the paper recipe's train steps launched decode kernels: {paper['train']['launches']}")

    # ---- the serving path: a RenderServer on a port checkpoint serves 128 requests ----
    t0 = time.perf_counter()
    served = serve_phase(torch, tokenizer, flagship_config(tokenizer, SERVE_BUCKET),
                         os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_serve"),
                         serve_scores, serve_inputs)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s")
    served_launches = served["greedy"]["launches"]
    check_decode_profile(served["profile"], "the served batch's profile", served_launches)

    # ---- the recipes' other decoder head dims: smoke.yaml's d = 16, scale_1024's d = 128 ----
    t0 = time.perf_counter()
    smoke = smoke_phase(torch, tokenizer, os.path.join(build, "chip_smoke_smoke"), serve_scores, serve_inputs)
    print(f"smoke-shaped phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scale = scale_1024_phase(torch, tokenizer, os.path.join(build, "chip_smoke_scale_1024"), serve_scores,
                             serve_inputs)
    shutil.rmtree(os.path.join(build, "chip_smoke_scale_1024"), ignore_errors=True)  # a 1.1 GB checkpoint
    print(f"scale_1024 phase: {time.perf_counter() - t0:.1f} s")
    print("scale_1024 served", json.dumps({k: v for k, v in scale.items() if k != "profile"}))

    launches = renders["greedy"][1]
    paths = {"render_greedy": launches, "train_steps": train_launches,
             "paper_recipe_train_steps": paper["train"]["launches"], "served_batch": served_launches,
             "smoke_render": smoke["render"]["launches"], "smoke_served": smoke["served"]["launches"],
             "scale_1024_served": scale["int8"]["launches"]}
    bound_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    timed = ("ms", "plain_ms", "bound_ms", "library_ms", "eager_ms")
    kernels = [
        # the row-write kernel as the decode launches it: write_kv_pair (a
        # layer's K and V rows) at the render's step, against one
        # _foreach_copy_ (library), two copy_ and two index_copy_; a single
        # write_kv (one cache), which no path calls, beside it
        {"name": "write_kv_pair", "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/kv_cache.cu",
         "replaces": "scoreperformer_tpu/ops/kv_cache.py:34", "launches": launches["write_kv_pair"],
         **{k: pair_main[k] for k in bound_keys + ("eager_ms", "copy_ms", "index_copy_ms")},
         "shape": pair_main["shape"], "cap": pair_main["cap"],
         "single_write_kv": {k: kv_main[k] for k in timed + ("copy_ms", "index_copy_ms", "shape", "cap")}},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "scoreperformer_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "scoreperformer_tpu/ops/flash_attention.py:49",
         "launches": launches["flash_attention_fwd"],
         **{k: fa_main[k] for k in bound_keys + ("bound_tc_ms", "eager_ms")}, "tf32_hmma_in_sass": hmma["flash_fwd"]},
    ] + [
        {"name": name, "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": replaces, "launches": train_launches[name],
         **{k: rec[k] for k in bound_keys + ("bound_tc_ms", "eager_ms")}, "tf32_hmma_in_sass": hmma[kernel]}
        for name, kernel, replaces, rec in (
            ("flash_attention_bwd_dkv", "flash_bwd_dkv", "scoreperformer_tpu/ops/flash_attention.py:135", bwd_main[0]),
            ("flash_attention_bwd_dq", "flash_bwd_dq", "scoreperformer_tpu/ops/flash_attention.py:192", bwd_main[1]),
        )
    ] + [
        {"name": "prefix_attend", "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/prefix_attend.cu",
         "replaces": "scripts/exp_pallas_decode_attend.py:51", "launches": launches["prefix_attend"],
         **{k: pa_main[k] for k in bound_keys + ("eager_ms",)},
         "head_dims": [{"shape": r["shape"], "cap": r["cap"], "base": r["base"], "dtype": r["dtype"],
                        **{k: r[k] for k in timed}} for r in pa_dims if "ms" in r]},
    ]
    for rec in kernels:
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in paths.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

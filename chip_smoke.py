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
   case), and times each kernel at the main path's shape (the render's
   step, the flash forward at the render's encoders, the backward and the
   bf16 instances at the train step's, `prefix_attend` at the served
   batch's), its plain version and one PyTorch call of the same function
   (the yardstick; the port never calls it) by CUDA-graph replay, with the
   eager time beside (the two backward kernels also as a pair against one
   SDPA backward; the row writes also beside `copy_` and `index_copy_`);
   `chip_probe_recipe_shapes.py` times the other paths' shapes, which this
   script holds to the plain versions without timing them; checks that the fp32 flash forward and backward hold
   TF32 warpgroup MMAs (HGMMA) in their SASS (`cuobjdump -sass`) and no
   TF32 HMMA (`mma.sync`), and the bf16 forward and backward bf16 HGMMA and
   no TF32 HMMA, in an instance at each head dim the wrapper takes
   (16, 32, 64, 128), and that two calls of `prefix_attend` and of each
   flash kernel give the same bits; holds the three flash kernels at head
   dims 128 and 16 (fp32 and bf16) to their plain versions at the edges and
   at the scale regime's and the smoke-shaped paths' shapes
   (`check_flash_head_dims`; `chip_probe_recipe_shapes.py` times those
   shapes, and sweeps `prefix_attend`'s split count);
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
   (2 heads of 16) renders an 8-bar score and serves 16 requests, then with
   `use_flash` (the kernels at d = 16) trains at the recipe's batch of 4,
   renders from its weights and trains held in bf16 (`smoke_flash`); and
   recipes/scoreperformer/scale_1024.yaml's model at full width (8 heads of
   128, 285M parameters) with `use_flash` serves 32 requests with its `auto`
   (int8) caches, profiled once, and renders, each from a port checkpoint
   and against the CPU path; then scripts/exp_scale_flash.py's regime
   (`scale_flash_phase`): scale_1024 with `use_flash` trains at batch 8 x
   1024 and 2048 notes (18 launches of each flash kernel a step), each
   beside the same model without the kernels, with an eval pass, a
   card-vs-CPU step and the model held in bf16;
9. streaming: scripts/exp_streaming_slo.py's regime (a 48-bar synthetic
   piece, 0.2 s windows with 0.1 s overflow, a 256-row decoder cache, top-k
   sampling) through `ScorePerformerGenerator`: the flagship for 60
   windows and scale_1024 for 20, the encoder pass and `warmup` timed, the
   median, p95 and largest window wall and the windows over 0.2 s, the
   decoder's counters and the kernel launches they predict, one more window
   profiled; greedy windows
   against the port's CPU path (12 over a 64-row cache, so that the
   window shifts; 4 at scale_1024), one seed sampling the same tokens
   through blocks as through the per-note path; then `write_kv_pair` and
   the flash forward held against their plain versions at the streaming
   shapes;
10. the Performer family (`performer_phase`): recipes/performer.yaml (the
   standalone Performer LM, batch 128 x 258 of PerformanceDataset windows)
   trained through `ExperimentComponents`, plain and with the flash kernels,
   one step of each profiled and a batch-4 step of each against the CPU;
   `ar_generate` from the trained weights, chunked (16 prompts, 253 steps,
   top-k) and on the ring past the 258-row window, with exact launch counts
   and a profiled generation, greedy tokens against the CPU's at both paths,
   top-p and top-a draws inside their filters' support; `mlm_unmask`
   single-run and iterative on an mlm Performer against the CPU's tokens;
   the kernels held to their plain versions at these paths' shapes;
11. Mixture-of-Experts (`moe_phase`): recipes/scoreperformer/moe.yaml (an
   MoE layer of 4 experts in every 2nd feed-forward of all three stacks)
   trained as written on the paper phase's corpus (batch 128 x 258,
   `loss/moe_aux` and `stats/moe_drop`, a profiled step, a batch-4 step
   against the CPU's); from those weights the 32-bar render, 16 served
   requests and 12 greedy streamed windows, each with the CPU's tokens and
   the dense formula's launches; an 8-bar score decoded with the classic
   layout and every `mixedlm_unmask` variant (static_prefix, unrolled,
   capacity_stages, chunk_tokens), each with the classic tokens; the
   tokenizer ops on the card against the CPU; `prefix_attend` at the
   variants' caps against its plain version;
12. several processes (`parallel_phase`): the flagship with `use_flash`
   (batch 128 x 258, 2 adamw steps) at data = 2 with ZeRO, model = 2 and
   data = 2 x model = 2, and moe.yaml at expert = 2, each against the
   one-process steps of the same batch, started through
   `scoreperformer_tpu_torch.parallel.launch` (nccl with a card a rank;
   with one card, a world-size-1 nccl group plus the ranks sharing the card
   over gloo); sharded, async and gathered checkpoints restored in one
   process and at model = 2, a render from the gathered one; the flash
   kernels at the model axis's shape and `prefix_attend` at moe.yaml's
   served batch against their plain versions;
13. head shapes the kernels are not built for (`head_shapes_phase`, last;
   a budget of 60 s, its seconds printed in `phase_s` beside the script's):
   the three flash kernels (fp32 and bf16, both passes) at 6 and 12 heads
   over one KV head at d = 64, then at d = 8, 48 and 96 (zero-padded to
   the built width 16, 64 or 128), and `prefix_attend` at 3, 6 and 12
   heads over one KV head and 12 over 12 at d = 48 and 96 (fp32, bf16,
   int8), each against its plain version on the unpadded inputs; the
   flagship at 6 heads of 48 over one KV head in every stack: greedy tokens
   on an 8-bar score against the CPU path's, the 32-bar score rendered, 16
   requests served from a checkpoint, a batch-4 train step against the
   CPU's, each with its launches counted;
14. checks the output: notes with the score's pitches and finite times (a
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
import concurrent.futures
import contextlib
import itertools
import json
import math
import os
import re
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
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# bf16 passes over the (query, key) pairs of the bf16 forward
# (csrc/flash_attention_fwd_bf16.cu): S and three for P.V; and of the bf16
# backward kernels (csrc/flash_attention_bwd_bf16.cu): dK/dV S, dP and three
# each for dV and dK; dQ/dslope S, dP and three for dQ
BF16_FWD_PASSES = 4
BF16_BWD_PASSES = {"dkv": 8, "dq": 5}
# bf16 passes of the one-pass kernels (csrc/flash_attention_fwd_one_pass.cu,
# csrc/flash_attention_bwd_one_pass.cu): the forward S and P.V; dK/dV S, dP,
# dV and dK; dQ/dslope S, dP and dQ
ONE_PASS_PASSES = {"fwd": 2, "dkv": 4, "dq": 3}
# the words of a SASS line of each tensor-core instruction the kernels take
TF32_HMMA = ("HMMA", "TF32")  # TF32 mma.sync, which no kernel takes
TF32_HGMMA = ("HGMMA", "TF32")  # split-TF32 wgmma (the fp32 forward and backward)
BF16_HGMMA = ("HGMMA", "BF16")  # bf16 wgmma
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
# the smoke-shaped model with use_flash trains at recipes/smoke.yaml's batch
# of 4 and windows of 8 bars, 48 notes (sequences of 50), warm-up + timed steps
SMOKE_TRAIN_BATCH, SMOKE_TRAIN_SEQ, SMOKE_WINDOW_BARS, SMOKE_TRAIN_STEPS = 4, 48, 8, (2, 4)
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
# the bf16 flash kernels' gate: one bf16 ulp of each element, where an element
# below this share of its tensor's largest takes the ulp at that share (there
# both sides are fp32 sums whose rounding, about 2^-21 of their operands,
# exceeds the element's own ulp)
BF16_ULP_FLOOR = 2.0**-10
# the flash kernels at the recipes' other head dims, (heads, head dim):
# scale_1024's decoder and recipes/smoke.yaml's stacks, one KV head each; the
# shapes timed: (b, h, KV heads, d, t, causal, what gives them)
FLASH_NEW_DIMS = ((8, 128), (2, 16))
FLASH_TIMED_SHAPES = (
    (8, 8, 1, 128, 1025, True, "scale_1024 decoder at 1024 notes"),
    (8, 8, 1, 128, 1026, False, "d = 128, non-causal, at 1024 notes"),
    (8, 8, 1, 128, 2049, True, "scale_1024 decoder at 2048 notes"),
    (8, 8, 1, 128, 2050, False, "d = 128, non-causal, at 2048 notes"),
    (8, 8, 8, 64, 1026, False, "scale_1024 encoders at 1024 notes (8 heads of 64, 8 KV heads)"),
    (4, 2, 1, 16, 49, True, "smoke-shaped decoder"),
    (4, 2, 1, 16, 50, False, "smoke-shaped encoders"),
)
# scale_1024's training phase: the recipe's batch and sequences (1024 notes
# and SOS/EOS), windows of 96 bars of 224-bar scores, so that most fill them
SCALE_TRAIN_BATCH, SCALE_TRAIN_SEQ, SCALE_WINDOW_BARS, SCALE_SCORE_BARS = 8, 1024, 96, 224
# the scale regime with the flash kernels (scripts/exp_scale_flash.py): also
# at 2048 notes (windows of 192 bars); every attention layer of scale_1024's
# stacks launches each flash kernel once a step (4 + 6 + 8); its card-vs-CPU
# step takes the first 130 notes of 2 sequences
SCALE_LONG_SEQ, SCALE_FLASH_LAUNCHES, SCALE_GATE_SEQ = 2048, 4 + 6 + 8, 130
# the optimizers' card-vs-CPU step: lamb, lion and adafactor with the plateau
# schedule at scale 0.5 (as after one bad epoch), each parameter after the
# update within 1e-4 relative L2 of the CPU's; lr 1e-5, so that lion's sign,
# which turns a gradient element within rounding of 0 into -+lr where the
# other side has +-lr, moves a parameter by less than the gate
OPTIMIZER_CHECKS = ("lamb", "lion", "adafactor")
# the streaming phase: scripts/exp_streaming_slo.py's regime (a 48-bar
# piece, windows of 256 notes for the encoder pass, a 256-row decoder cache,
# 0.2 s windows with 0.1 s overflow, the first 5 of them warm-up); the
# flagship streams 60 windows, scale_1024 20. The greedy card-vs-CPU gate:
# 12 windows of 1.2 s over a 64-row cache (so that the context window
# shifts), 4 of 0.2 s at scale_1024 (the CPU decodes a 285M-parameter model)
STREAM_BARS, STREAM_SEQ, STREAM_CTX = 48, 256, 256
STREAM_WINDOW, STREAM_OVERFLOW, STREAM_WARMUP = 0.2, 0.1, 5
STREAM_WINDOWS, STREAM_SCALE_WINDOWS = 60, 20
STREAM_GATE_WINDOWS, STREAM_GATE_WINDOW, STREAM_GATE_CTX = 12, 1.2, 64
STREAM_SCALE_GATE_WINDOWS = 4
# the MoE phase: recipes/scoreperformer/moe.yaml's feed-forward over
# base.yaml (every 2nd feed-forward of each stack 4 GLU-swish experts, top-2);
# the mixedlm_unmask variants it decodes an 8-bar score with (the classic
# layout, then each chunked variant, all greedy, each held to the classic
# tokens; the render is the default chunked layout); the served requests
# and streamed greedy windows it holds to the CPU
MOE_FEED_FORWARD = dict(num_experts=4, expert_top_k=2, capacity_factor=1.25, moe_stride=2, router_aux_weight=0.01)
MOE_VARIANTS = {"static_prefix": dict(static_prefix=True), "unrolled": dict(unrolled_chunks=True),
                "unrolled_static_prefix": dict(unrolled_chunks=True, static_prefix=True),
                "capacity_stages_4": dict(capacity_stages=4), "chunk_tokens": dict(chunk_tokens=True),
                "chunk_tokens_capacity_stages_2": dict(chunk_tokens=True, capacity_stages=2)}
MOE_VARIANT_BARS, MOE_REQUESTS = 8, 16


def flagship_config(tokenizer, n_notes, use_flash=True, heads=4, dim_head=64):
    """bench.py::build_flagship's model at full width; vocab sizes and token
    values come from the tokenizer, as training injects them. Every stack
    has `heads` heads of `dim_head` over one KV head."""
    num_tokens = tokenizer.performance_sizes
    score_tokens = tokenizer.score_sizes
    token_values = {k: v.tolist() for k, v in tokenizer.token_values(normalize=True).items()}
    emb = {"_target_": "simple", "emb_dims": 128, "mode": "cat", "emb_norm": True,
           "discrete": False, "continuous": True, "continuous_dense": True,
           "discrete_ids": [0, 1, 2, 3], "token_values": token_values}
    attn = {"dim_head": dim_head, "one_kv_head": True, "alibi_pos_bias": True, "alibi_learned": True,
            "use_flash": use_flash}
    ff = {"mult": 4, "glu": True, "swish": True}

    def stack(target, depth):
        return {"_target_": target, "depth": depth, "heads": heads, "attention": attn, "feed_forward": ff}

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


def scale_flash_config(tokenizer, seq=SCALE_TRAIN_SEQ, dropout=0.0):
    """scale_1024_config with `use_flash` in every stack's attention node (the
    recipe gives both encoders a node of their own: 8 heads of 64, 8 KV heads,
    no ALiBi; the decoder's is 8 heads of 128 with one KV head), the
    decoder's attention dropout `dropout` (the kernels have none, so while
    training with it the gate keeps a layer off the flash path, as JAX's
    does: scripts/exp_scale_flash.py trains without), and positions and
    segments for `seq` notes."""
    cfg = scale_1024_config(tokenizer)
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"]["attention"]["use_flash"] = True
        cfg[key]["max_seq_len"] = seq + 2
    cfg["perf_decoder"]["transformer"]["attention"]["dropout"] = dropout
    cfg["perf_encoder"]["max_segments"] = seq + 4
    return cfg


def smoke_flash_config(tokenizer, n_notes):
    """smoke_config with `use_flash` and no attention dropout in its one
    attention node (2 heads of 16, one KV head), which all three stacks
    share."""
    cfg = smoke_config(tokenizer, n_notes)
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"]["attention"].update(use_flash=True, dropout=0.0)
    return cfg


def dropout_off(model_config):
    """A copy of a ScorePerformer model config with every dropout at 0 (the
    card and the CPU draw their masks from other streams)."""
    cfg = json.loads(json.dumps(model_config))
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        for node in ("attention", "feed_forward"):
            if "dropout" in cfg[key]["transformer"][node]:
                cfg[key]["transformer"][node]["dropout"] = 0.0
    if "latent_dropout" in cfg["perf_encoder"]:
        cfg["perf_encoder"]["latent_dropout"] = [0.0] * len(cfg["perf_encoder"]["latent_dropout"])
    if "classifiers" in cfg:
        cfg["classifiers"]["classifier"]["dropout"] = 0.0
    return cfg


def moe_config(tokenizer, n_notes=TRAIN_SEQ):
    """recipes/scoreperformer/moe.yaml's model: base.yaml's (dim 256,
    stacks 2/4/4 deep, 4 heads of 64 with one KV head, learned ALiBi,
    dropout 0.1, GLU-swish) with moe.yaml's feed-forward in all three stacks
    (base.yaml points both encoders' feed_forward at the decoder's), without
    the direction classifiers; positions and segments for `n_notes` notes
    (the recipe's 256 train; a served bucket of 384 needs more). No
    parameter depends on them (no absolute positions), so weights trained at
    one size load at the other."""
    attn = {"dim_head": 64, "one_kv_head": True, "dropout": 0.1, "alibi_pos_bias": True, "alibi_learned": True}
    cfg = base_recipe_config(tokenizer, dim=256, emb_dims=128, depths=(2, 4, 4), heads=4, latent_dim=(32, 20, 8, 4),
                             enc_attn=attn, dec_attn=attn, max_seq_len=n_notes + 2, max_segments=n_notes + 4)
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"]["feed_forward"].update(MOE_FEED_FORWARD)
    return cfg


# Each phase's seconds (`PHASE_S`), the host seconds of its CPU references
# (`CPU_REF_S`: CPU renders, CPU train steps, CPU greedy tokens; those the
# worker computes counted in its seconds) and the seconds the script waited
# for the worker's (`CPU_WAIT_S`, by the phase that waited), by phase
PHASE_S, CPU_REF_S, CPU_WAIT_S = {}, {}, {}
_PHASE = ["set-up"]
# the CPU reference worker's torch threads: half the card machine's 8
# cores, the rest for the card's host work
CPU_REF_THREADS = 4


def begin_phase(name):
    """Start the phase `name`: later CPU references count toward it."""
    _PHASE[0] = name
    CPU_REF_S.setdefault(name, 0.0)
    PHASE_S[name] = -time.perf_counter()


def end_phase(name):
    """End the phase `name`; print its seconds, its CPU references' and its
    waits for the worker's."""
    PHASE_S[name] += time.perf_counter()
    print(f"phase {name}: phase_s {PHASE_S[name]:.1f}, cpu_ref_s {CPU_REF_S[name]:.1f} (the worker's joined so "
          f"far), cpu_wait_s {CPU_WAIT_S.get(name, 0.0):.1f}", flush=True)


@contextlib.contextmanager
def cpu_ref():
    """Count the block's host seconds as a CPU reference of the running phase."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        CPU_REF_S[_PHASE[0]] = CPU_REF_S.get(_PHASE[0], 0.0) + time.perf_counter() - t0


def _cpu_worker_init(threads):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the worker computes on the CPU alone
    import torch

    torch.set_num_threads(threads)
    import scoreperformer_tpu_torch.inference  # noqa: F401  (the imports while the card builds)


def _timed(fn, *args):
    t0 = time.perf_counter()
    value = fn(*args)
    return value, time.perf_counter() - t0


class CpuReferences:
    """The CPU references that need no result of the card (only seeded
    weights, checkpoints and inputs on disk), computed by one spawned
    worker process on the CPU while the card works. `submit` queues one as
    soon as its inputs exist and `later` registers its gate; `check_all`
    runs the gates, joining each result, before the script's record. A
    reference counts toward its phase's `cpu_ref_s` in the worker's seconds,
    and the main process's wait for it toward the waiting phase's
    `cpu_wait_s`."""

    def __init__(self, threads=CPU_REF_THREADS):
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"), initializer=_cpu_worker_init, initargs=(threads,))
        self.gates = []
        self.pool.submit(int)  # start the worker now

    def submit(self, fn, *args, phase=None):
        """Queue `fn(*args)`; its seconds count toward `phase` (the running
        one unless given)."""
        return phase or _PHASE[0], self.pool.submit(_timed, fn, *args)

    def result(self, job):
        phase, future = job
        t0 = time.perf_counter()
        value, seconds = future.result()
        CPU_WAIT_S[_PHASE[0]] = CPU_WAIT_S.get(_PHASE[0], 0.0) + time.perf_counter() - t0
        CPU_REF_S[phase] = CPU_REF_S.get(phase, 0.0) + seconds
        return value

    def later(self, what, job, gate):
        """`gate(value)` on the job's result, run by `check_all`."""
        self.gates.append((what, job, gate))

    def check_all(self):
        for what, job, gate in self.gates:
            gate(self.result(job))
            print(f"CPU reference gate passed: {what}", flush=True)
        self.gates = []

    def close(self):
        """Stop the worker, whatever it is doing."""
        for process in list(getattr(self.pool, "_processes", {}).values()):
            process.terminate()
        self.pool.shutdown(wait=True, cancel_futures=True)


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
    """Kernel vs plain at fp32, with random valid lengths when `padded`
    (batch element 0 has none when it is "empty"), or the given `lengths`
    (or (first, end) key ranges), and `hk` KV heads: o within 1e-4 and lse
    within 1e-4 (or 4 fp32 ulps of its value where that is more,
    `lse_over_gate`) of the plain version run in fp64 (the fp32 plain
    version's error is recorded beside); two kernel calls give the same
    bits. Returns the record of this shape (times only when `timed`)."""
    import torch.nn.functional as F

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, h, t, d, device=dev, generator=g)
    k = torch.randn(b, hk, t, d, device=dev, generator=g)
    v = torch.randn(b, hk, t, d, device=dev, generator=g)
    slopes = torch.rand(h, device=dev, generator=g) * 0.5
    mask = key_mask(torch, b, t, padded, lengths, g)
    o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask=mask, causal=causal)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, slopes, mask=mask, causal=causal)
    po, plse = fa.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)
    o64, lse64 = forward_fp64(fa, q, k, v, slopes, mask, causal)
    torch.cuda.synchronize()
    o_err = (o.double() - o64).abs().max().item()
    err = max(o_err, (lse.double() - lse64).abs().max().item())
    lse_gate = lse_over_gate(torch, lse, lse64, 1e-4)
    where = (b, t, causal, padded, d, hk)
    if not (o_err <= 1e-4 and lse_gate <= 1.0):
        raise AssertionError(f"flash attention differs from its plain version at {where}: o {o_err}, "
                             f"lse {lse_gate} of its gate")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"two flash attention calls give other bits at {where}")
    rec = {"shape": [b, h, t, d], "kv_heads": hk, "causal": causal, "padded": padded, "max_abs_err": err,
           "lse_err_over_gate": lse_gate,
           "max_abs_err_vs_fp32_plain": max((o - po).abs().max().item(), (lse - plse).abs().max().item()),
           "same_bits": True}
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
        rec["over_library"] = rec["ms"] / rec["library_ms"]
        rec["over_bound_tc"] = rec["ms"] / rec["bound_tc_ms"]
    return rec


def ptxas_entries(log, kernel):
    """Registers, spills and static shared memory of each instance of
    `kernel` (a substring of its mangled name) in an `nvcc -Xptxas=-v` log:
    [{"function", "d", "warpgroups", "registers", "spill_stores", "smem"}],
    d and warpgroups from the template arguments `ILi<d>ELi<g>E`."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m is not None:
            cur = None
            if kernel in m.group(1):
                args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(1).split(kernel, 1)[1])]
                cur = {"function": m.group(1), "d": args[0] if args else None,
                       "warpgroups": args[1] if len(args) > 1 else None}
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return out


def fp32_fwd_smem(d, warpgroups, t):
    """Dynamic shared memory of an fp32 forward launch, as
    csrc/flash_attention_fwd.cu's FwdSmem lays it out: each warpgroup's q
    hi and lo (64 rows), one key tile's K, K's lo and V's transpose, hi and
    lo (32 keys, 64 at d = 16), three mbarriers, the warps' first keys, the
    key mask's words and the 1024-byte alignment's slack."""
    keys = 64 if d == 16 else 32
    return warpgroups * 2 * 64 * d * 4 + 4 * keys * d * 4 + 3 * 8 + warpgroups * 16 + 4 * -(-t // 32) + 1024


def one_pass_fwd_smem(d, operands, t):
    """Dynamic shared memory of a one-pass forward launch, as
    csrc/flash_attention_fwd_bf16.cu's FwdSmem lays it out (edit the two
    together): two q tiles and three stages of K and V tiles in bf16 (64 rows
    each), on fp32 operands the rows that land to be rounded (q's, then a key
    tile's, 4 tiles' worth), 7 mbarriers (9 on fp32 operands), the warps'
    first keys, the key mask's words and the 1024-byte alignment's slack."""
    staged, bars = (4, 9) if operands == "fp32" else (0, 7)
    return (2 + 6 + staged) * 64 * d * 2 + bars * 8 + 2 * 4 * 4 + 4 * -(-t // 32) + 1024


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


def dq_fp64(fa, args):
    """(dq, dslopes) of the plain dQ/dslope version on fp64 copies of the
    backward's arguments: the reference of the kernels' slope gradients. The
    slope sum runs over b*h*t*t cancelling terms, so the fp32 plain version's
    own rounding grows with t (`dslopes_beyond`)."""
    q, k, v, slopes, mask, dout, lse, delta, causal = args
    return fa.flash_attention_bwd_dq_plain(q.double(), k.double(), v.double(), slopes.double(), mask, dout.double(),
                                           lse.double(), delta.double(), causal)


def forward_fp64(fa, q, k, v, slopes, mask, causal):
    """(o, lse) of the plain forward on fp64 copies of its inputs."""
    return fa.flash_attention_plain(q.double(), k.double(), v.double(), slopes.double(), mask, causal,
                                    return_lse=True)


def lse_over_gate(torch, lse, lse64, tol):
    """Largest |lse - lse64| over max(tol, 4 fp32 ulps of lse64): lse is fp32,
    and a query row far from its keys (a padded position, up to t away) has
    |lse| of hundreds, from the bias -slope*|i-j|, whose product and
    subtraction round in fp32 in any kernel of this math (the Pallas one's
    too): an fp32 ulp is 7.6e-6 at 127 and 6.1e-5 at 1000."""
    ulp = torch.exp2(torch.floor(torch.log2(lse64.abs().clamp_min(1e-30))) - 23)
    return ((lse.double() - lse64).abs() / torch.clamp(4 * ulp, min=tol)).max().item()


def dslopes_beyond(got, p32, exact):
    """The slope gradient's largest error against the fp64 plain version's,
    beyond the fp32 plain version's own, over the fp64 one's largest value
    (0 when no farther than the fp32 plain version). The fp32 rounding of dS
    = P * (dP - delta), whose two terms cancel, adds up over the t*t terms,
    each weighted by |i-j| up to t: at t = 2049 and 2050 on an H100, 4.3e-4
    and 1.6e-3 of the largest value in the fp32 plain version, 1.15e-3 and
    7.8e-4 in the kernel."""
    err = (got.double() - exact).abs().max() - (p32.double() - exact).abs().max()
    return max(err.item(), 0.0) / exact.abs().max().clamp_min(1e-30).item()


def check_flash_bwd(torch, fa, b, t, causal, padded, timed, h=4, d=64, hk=1, lengths=None):
    """Both backward kernels vs their plain versions on the kernel forward's
    lse: dq, dk, dv to 1e-4 of the plain version's largest value, and dslopes
    to 1e-3 of the fp64 plain version's largest value beyond the fp32 plain
    version's own error (`dq_fp64`, `dslopes_beyond`; both errors recorded
    beside), and two calls give the same bits. Returns the records of the dK/dV and the
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
    exact = dq_fp64(fa, args)[1]
    torch.cuda.synchronize()
    err = {name: ((x.double() - y.double()).abs().max() / y.double().abs().max().clamp_min(1e-30)).item()
           for name, x, y in zip(("dk", "dv", "dq", "dslopes_vs_fp64", "dslopes_vs_fp32_plain"), got + got[3:],
                                 want[:3] + (exact, want[3]))}
    err["fp32_plain_dslopes_vs_fp64"] = ((want[3].double() - exact).abs().max() / exact.abs().max()).item()
    err["dslopes"] = dslopes_beyond(got[3], want[3], exact)
    limits = {"dk": 1e-4, "dv": 1e-4, "dq": 1e-4, "dslopes": 1e-3}
    bad = {n: e for n, e in err.items() if n in limits and not e <= limits[n]}
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
    bias = bias.to(q.dtype)
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


def bf16_ulps(torch, got, want):
    """Largest |got - want| in bf16 ulps of max(|got|, |want|), an element
    below BF16_ULP_FLOOR of the tensor's largest counted at that floor."""
    got, want = got.float(), want.float()
    floor = want.abs().max() * BF16_ULP_FLOOR
    m = torch.maximum(torch.maximum(got.abs(), want.abs()), floor).clamp_min(1.2e-38)
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)).max().item()


def ulps_beyond(torch, got, ref, p32, sel):
    """Largest (|got - ref| - e32) in bf16 ulps of max(|got|, |ref|) over the
    elements `sel` marks, where ref is an fp64 reference and e32 the largest
    error against it of p32, the fp32 plain version, there; an element below
    BF16_ULP_FLOOR of ref's largest there counted at that floor."""
    if not bool(sel.any()):
        return 0.0
    got, ref, p32 = got.double(), ref.double(), p32.double()
    e32 = torch.where(sel, (p32 - ref).abs(), 0).max()
    floor = torch.where(sel, ref.abs(), 0).max() * BF16_ULP_FLOOR
    m = torch.maximum(torch.maximum(got.abs(), ref.abs()), floor).clamp_min(1.2e-38)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return torch.where(sel, ((got - ref).abs() - e32).clamp_min(0) / ulp, 0).max().item()


def check_flash_bf16(torch, fa, b, t, causal, padded, timed, h=4, d=64, hk=1, lengths=None):
    """The bf16 instances of the three flash kernels against their plain
    versions on the same bf16 q, k, v and dout (fp32 slopes, the kernel
    forward's lse, delta the bf16 row sum as the autograd Function takes it):
    o, dk, dv and dq within one bf16 ulp (`bf16_ulps`; o and dq on the query
    rows the mask keeps, and on the rows it drops within one ulp beyond the
    fp32 plain version's error against the fp64 one, `ulps_beyond`), lse to
    1e-5 (or 4 fp32 ulps of its value where that is more) of the fp64 plain
    version's, dslopes
    (fp32 with fp32 slopes, a sum over b*h*t*t terms in another order) to 1e-3
    of the fp64 plain version's largest value beyond the fp32 plain version's
    own error (`dq_fp64`, `dslopes_beyond`) as in `check_flash_bwd`, and two calls, forward and
    backward, give the same bits. Returns the records of the
    forward, dK/dV and dQ/dslope kernels at this shape, timed by CUDA-graph
    replay when `timed`, beside SDPA on bf16 (bias materialized in bf16) and
    its backward, the forward's time over SDPA's forward (`over_library`)
    and the backward pair's over SDPA's backward (`pair_over_library`)
    beside."""
    import torch.nn.functional as F

    q, k, v, slopes, mask, dout = flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk, lengths)
    q, k, v, dout = (x.bfloat16() for x in (q, k, v, dout))
    o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, slopes, mask, causal)
    po, plse = fa.flash_attention_plain(q, k, v, slopes, mask, causal, return_lse=True)
    delta = (dout * o).sum(-1).float()
    args = (q, k, v, slopes, mask, dout, lse, delta, causal)
    got = fa.flash_attention_bwd_dkv(*args) + fa.flash_attention_bwd_dq(*args)
    again = fa.flash_attention_bwd_dkv(*args) + fa.flash_attention_bwd_dq(*args)
    want = fa.flash_attention_bwd_dkv_plain(*args) + fa.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    if o.dtype != torch.bfloat16 or any(x.dtype != torch.bfloat16 for x in got[:3]):
        raise AssertionError(f"the bf16 kernels returned {o.dtype} and {[x.dtype for x in got]}")
    # the query rows the mask keeps: o and dq within one bf16 ulp of the
    # plain version's; the rows it drops (padded positions, whose outputs the
    # model zeroes and which get no gradient from it) lie up to t from their
    # keys, where |s| reaches hundreds and its fp32 rounding (3e-5 at 500)
    # moves P: there o and dq within one bf16 ulp beyond the fp32 plain
    # version's own error against the fp64 one (`ulps_beyond`)
    keep = mask[:, None, :, None]
    ulps = {"o": bf16_ulps(torch, torch.where(keep, o, 0), torch.where(keep, po, 0)),
            **{name: bf16_ulps(torch, x, y) for name, x, y in zip(("dk", "dv"), got, want)},
            "dq": bf16_ulps(torch, torch.where(keep, got[2], 0), torch.where(keep, want[2], 0)),
            "dslopes": bf16_ulps(torch, got[3], want[3])}
    o64, lse64 = forward_fp64(fa, q, k, v, slopes, mask, causal)
    dq64, exact = dq_fp64(fa, args)
    f32 = (q.float(), k.float(), v.float(), slopes, mask)
    ulps["o_dropped_rows"] = ulps_beyond(torch, o, o64, fa.flash_attention_plain(*f32, causal), ~keep)
    ulps["dq_dropped_rows"] = ulps_beyond(torch, got[2], dq64, fa.flash_attention_bwd_dq_plain(
        *f32, dout.float(), lse, delta, causal)[0], ~keep)
    # lse (fp32 on both sides) to 1e-5 of the fp64 plain version's, or 4
    # fp32 ulps of its value where that is more (`lse_over_gate`)
    lse_err = (lse.double() - lse64).abs().max().item()
    lse_gate = lse_over_gate(torch, lse, lse64, 1e-5)
    lse_err_fp32_plain = (lse - plse).abs().max().item()
    dslopes_err = dslopes_beyond(got[3], want[3], exact)
    where = (b, t, causal, padded, d, hk)
    if not (max(v for k, v in ulps.items() if k != "dslopes") <= 1.0 and lse_gate <= 1.0 and dslopes_err <= 1e-3):
        raise AssertionError(f"bf16 flash kernels differ from their plain versions at {where}: ulps {ulps}, "
                             f"lse {lse_err}, dslopes {dslopes_err}")
    if not all(torch.equal(x, y) for x, y in zip(got + (o, lse), again + (o2, lse2))):
        raise AssertionError(f"two bf16 flash calls give other bits at {where}")
    shape = {"shape": [b, h, t, d], "kv_heads": hk, "causal": causal, "padded": padded, "dtype": "bf16",
             "bf16_ulps": ulps, "lse_err": lse_err, "lse_err_over_gate": lse_gate,
             "lse_err_vs_fp32_plain": lse_err_fp32_plain,
             "dslopes_err": dslopes_err}
    fwd = {**shape, "max_abs_err": (o.float() - po.float()).abs().max().item()}
    dkv = {**shape, "max_abs_err": max((x.float() - y.float()).abs().max().item() for x, y in zip(got[:2], want[:2]))}
    dq = {**shape, "max_abs_err": max((x.float() - y.float()).abs().max().item() for x, y in zip(got[2:], want[2:]))}
    if not timed:
        return fwd, dkv, dq
    copies = [(q.clone(), k.clone(), v.clone(), dout.clone())
              for _ in range(n_copies(2 * (q.numel() + k.numel() + v.numel() + dout.numel())))]
    fwd["ms"] = graph_ms(torch, lambda qc, kc, vc, oc: fa.flash_attention_fwd(qc, kc, vc, slopes, mask, causal),
                         copies, iters=50)
    rest = (slopes, mask)
    dkv["ms"] = graph_ms(torch, lambda qc, kc, vc, oc: fa.flash_attention_bwd_dkv(qc, kc, vc, *rest, oc, lse, delta,
                                                                                  causal), copies, iters=20)
    dq["ms"] = graph_ms(torch, lambda qc, kc, vc, oc: fa.flash_attention_bwd_dq(qc, kc, vc, *rest, oc, lse, delta,
                                                                                causal), copies, iters=20)
    del copies
    fwd["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, slopes, mask, causal))
    dkv["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_plain(*args), iters=10, warmup=2)
    dq["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq_plain(*args), iters=10, warmup=2)
    for rec in (fwd, dkv, dq):
        rec["plain_timing"] = "eager"
    bias, ok = sdpa_bias(torch, slopes, mask, causal)
    bias = bias.bfloat16()
    sdpa = [(q.clone(), k.expand(b, h, t, d).contiguous(), v.expand(b, h, t, d).contiguous())
            for _ in range(n_copies(3 * 2 * q.numel()))]
    fwd["library_ms"] = graph_ms(
        torch, lambda qc, kc, vc: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=bias), sdpa, iters=50)
    del sdpa, bias
    fwd["over_library"] = fwd["ms"] / fwd["library_ms"]
    print(f"bf16 forward at {(b, h, hk, d, t, causal, padded)}: {fwd['ms']:.4f} ms, SDPA's bf16 forward "
          f"{fwd['library_ms']:.4f} ms, ratio {fwd['over_library']:.3f}")
    library, library_timing = sdpa_backward_ms(torch, q, k, v, dout, slopes, mask, causal)
    dkv["library_ms"] = dq["library_ms"] = library
    dkv["library_timing"] = dq["library_timing"] = library_timing
    pair_over_library = (dkv["ms"] + dq["ms"]) / library
    dkv["pair_over_library"] = dq["pair_over_library"] = pair_over_library
    print(f"bf16 backward pair at {(b, h, hk, d, t, causal, padded)}: {dkv['ms'] + dq['ms']:.4f} ms "
          f"(dK/dV {dkv['ms']:.4f}, dQ/dslope {dq['ms']:.4f}), SDPA's backward {library:.4f} ms, "
          f"ratio {pair_over_library:.3f}")
    # bounds: bf16 operands (2 bytes an element), fp32 lse, delta, slopes and
    # slope parts; fp32 arithmetic, as the Pallas kernels upcast. The
    # tensor-core floor counts the bf16 passes each kernel takes
    # (BF16_FWD_PASSES, BF16_BWD_PASSES) at 989 TFLOP/s; those passes are
    # its operations, so its bound is that floor (the fp32 operations at 67
    # TFLOP/s beside, `bound_fp32_ms`)
    pairs = ok.expand(b, 1, t, t).sum().item()
    product = 2 * d * h * pairs  # one d-long product over every (query, key) pair and head
    bf16, f32 = 2, 4
    parts = math.prod(fa.dq_slope_parts(b, h, hk, t))
    for rec, products, (tc_key, tc_products, tc_rate), nbytes in (
        (fwd, 2, ("bf16_passes", BF16_FWD_PASSES, BF16_OPS_PER_S),
         bf16 * (2 * q.numel() + k.numel() + v.numel()) + f32 * (lse.numel() + h) + mask.numel()),
        (dkv, 4, ("bf16_passes", BF16_BWD_PASSES["dkv"], BF16_OPS_PER_S),
         bf16 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()) + f32 * (2 * lse.numel() + h) + mask.numel()),
        (dq, 3, ("bf16_passes", BF16_BWD_PASSES["dq"], BF16_OPS_PER_S),
         bf16 * (3 * q.numel() + k.numel() + v.numel()) + f32 * (2 * lse.numel() + h + parts) + mask.numel()),
    ):
        ops = products * product
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S
        if tc_key == "bf16_passes":
            rec["bound_fp32_ms"] = max(t_ops, t_bytes) * 1e3
            t_ops = tc_products * product / tc_rate
        rec["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        rec[tc_key] = tc_products
        rec["bound_tc_ms"] = max(tc_products * product / tc_rate, t_bytes) * 1e3
    return fwd, dkv, dq


def one_pass_over_bound(torch, got, want, bound):
    """Largest |got - want| over `bound` (elementwise), one bf16 ulp of the
    output added for bf16 outputs, whose own rounding may flip."""
    err = (got.double() - want.double()).abs()
    if got.dtype == torch.bfloat16:
        m = torch.maximum(got.double().abs(), want.double().abs()).clamp_min(1.2e-38)
        bound = bound + torch.exp2(torch.floor(torch.log2(m)) - 7)
    return (err / bound.clamp_min(1e-30)).max().item()


def one_pass_bounds(torch, fa, q, k, v, slopes, mask, dout, lse, delta, causal):
    """The one-pass kernels' bounds against their one-pass plain versions on
    the same inputs, elementwise for o, dk, dv and dq. Each rounded P or dS
    may land on the other bf16 neighbour on the two sides (their fp32
    values differ by the sums' order and `__expf`): one bf16 ulp, at most 2^-7 of
    the value, on every product it enters, so 2^-7 of the output's sum over
    those products' absolute values (P.|v| / l, P^T.|dO|, |dS|^T.|q|*scale,
    |dS|.|k|*scale), and 2^-12 of it for the fp32 rounding of S and exp at
    |s| up to a few hundred (2^-23 relative each). dS = P * (dP - delta)
    cancels where dP is near delta (a query row with one valid key: dP =
    delta = dO.v), so its fp32 rounding, both sides' sums of d products in
    dP, d * 2^-23 of sum |dO|.|v| (times P), enters dk and dq as well."""
    hk, d = k.shape[1], q.shape[-1]
    scale = d**-0.5
    ulp = 2.0**-7 + 2.0**-12
    bounds = {"o": ulp * fa.flash_attention_plain(q.float(), k.float(), v.float().abs(), slopes, mask, causal)}
    p, ds, _ = fa._bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale, True)
    ds_err = ulp * ds.abs() + p * (d * 2.0**-23) * (dout.float().abs() @ v.float().abs().transpose(-1, -2))
    del ds
    bounds["dv"] = ulp * fa._sum_kv_heads(p.transpose(-1, -2) @ dout.float().abs(), hk)
    del p
    bounds["dk"] = fa._sum_kv_heads(ds_err.transpose(-1, -2) @ q.float().abs(), hk) * scale
    bounds["dq"] = (ds_err @ k.float().abs()) * scale
    return bounds


def one_pass_bwd_parts(torch, fa, q, k, v, dout, slopes, mask, lse, delta, causal):
    """(dk, dv, dq, slope parts) of one launch of each one-pass backward
    kernel on these operands, as they are (no wrapper, no sum)."""
    b, h, t, d = q.shape
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    parts = torch.empty(fa.dq_slope_parts(b, h, k.shape[1], t), dtype=torch.float32, device=q.device)
    for name, outs in (("dkv", (dk, dv)), ("dq", (dq, parts))):
        fa._bwd_launch(f"flash_attention_bwd_{name}", f"sp_flash_attention_bwd_{name}", q, k, v, slopes, mask, dout,
                       lse, delta, causal, d**-0.5, outs, True)
    return dk, dv, dq, parts


def check_flash_one_pass(torch, fa, b, t, causal, padded, timed, h=4, d=64, hk=1, dtype="fp32", lengths=None):
    """The one-pass kernels (the TPU's "default" numerics: q, k, v and dO
    rounded to bf16, P and dS one bf16 term) against their one-pass plain
    versions on the same fp32 or bf16 (`dtype`) inputs: o, dk, dv and dq
    within `one_pass_bounds` (one bf16 ulp of each rounded P or dS), lse to
    1e-5 (or 4 fp32 ulps of its value) of the fp64 plain version's on the
    rounded operands, dslopes (from the
    unrounded dS) to 1e-3 of the fp64 one's largest value beyond the fp32
    plain version's own error, outputs in the inputs' dtype, and two calls
    giving the same bits. The kernels round q, k, v and dO themselves, so
    they give the same bits on the operands as on their roundings (the
    rounding is torch's): the forward's o and lse on (q, k, v) with the
    scale s as on (bf16(q*s), bf16(k), bf16(v)) with scale 1, those in fp32
    on fp32 operands; on fp32 operands the backward kernels' dk, dv, dq and
    slope parts on x as on fp32(bf16(x)). Returns the records of the
    forward, dK/dV and dQ/dslope kernels; timed when `timed` (by CUDA-graph
    replay, the kernel launches alone on the operands as the wrappers
    receive them, which no wrapper copies; SDPA's bf16 forward and backward
    as the library)."""
    import torch.nn.functional as F

    q, k, v, slopes, mask, dout = flash_bwd_inputs(torch, b, t, causal, padded, h, d, hk, lengths)
    if dtype == "bf16":
        q, k, v, dout = (x.bfloat16() for x in (q, k, v, dout))
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, slopes, mask, causal, one_pass=True)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, slopes, mask, causal, one_pass=True)
    po, plse = fa.flash_attention_plain(q, k, v, slopes, mask, causal, return_lse=True, one_pass=True)
    delta = (dout * o).sum(-1).float()
    args = (q, k, v, slopes, mask, dout, lse, delta, causal)
    got = fa.flash_attention_bwd_dkv(*args, one_pass=True) + fa.flash_attention_bwd_dq(*args, one_pass=True)
    again = fa.flash_attention_bwd_dkv(*args, one_pass=True) + fa.flash_attention_bwd_dq(*args, one_pass=True)
    want = (fa.flash_attention_bwd_dkv_plain(*args, one_pass=True)
            + fa.flash_attention_bwd_dq_plain(*args, one_pass=True))
    torch.cuda.synchronize()
    if o.dtype != q.dtype or any(x.dtype != y.dtype for x, y in zip(got[:3], (k, v, q))):
        raise AssertionError(f"the one-pass kernels returned {o.dtype} and {[x.dtype for x in got]} for {q.dtype}")
    bounds = one_pass_bounds(torch, fa, q, k, v, slopes, mask, dout, lse, delta, causal)
    over = {name: one_pass_over_bound(torch, x, y, bounds[name])
            for name, x, y in (("o", o, po), ("dk", got[0], want[0]), ("dv", got[1], want[1]), ("dq", got[2], want[2]))}
    qs = (q.float() * scale).bfloat16()
    _, lse64 = fa.flash_attention_plain(qs.double(), k.bfloat16().double(), v.bfloat16().double(), slopes.double(),
                                        mask, causal, 1.0, return_lse=True, one_pass=True)
    lse_gate = lse_over_gate(torch, lse, lse64, 1e-5)
    exact = fa.flash_attention_bwd_dq_plain(q.double(), k.double(), v.double(), slopes.double(), mask,
                                            dout.double(), lse.double(), delta.double(), causal, one_pass=True)[1]
    dslopes_err = dslopes_beyond(got[3], want[3], exact)
    where = (b, t, causal, padded, d, hk, dtype)
    if not (max(over.values()) <= 1.0 and lse_gate <= 1.0 and dslopes_err <= 1e-3):
        raise AssertionError(f"one-pass flash kernels differ from their plain versions at {where}: over their "
                             f"bounds {over}, lse {lse_gate}, dslopes {dslopes_err}")
    if not all(torch.equal(x, y) for x, y in zip(got + (o, lse), again + (o2, lse2))):
        raise AssertionError(f"two one-pass flash calls give other bits at {where}")
    rounded = ((q.float() * scale).bfloat16(), k.bfloat16(), v.bfloat16())
    rounded = [x.to(q.dtype) for x in rounded]
    o_r, lse_r = fa._fwd_launch(*rounded, slopes, mask, causal, 1.0, True)
    if not (torch.equal(o, o_r) and torch.equal(lse, lse_r)):
        raise AssertionError(f"the one-pass forward kernel gives other bits on (q, k, v) with scale {scale} than on "
                             f"(bf16(q*scale), bf16(k), bf16(v)) with scale 1 at {where}")
    if dtype == "fp32":
        rounded = [x.bfloat16().float() for x in (q, k, v, dout)]
        on_x, on_rounded = (one_pass_bwd_parts(torch, fa, *ops, slopes, mask, lse, delta, causal)
                            for ops in ((q, k, v, dout), rounded))
        if not all(torch.equal(x, y) for x, y in zip(on_x, on_rounded)):
            raise AssertionError(f"the one-pass backward kernels on fp32 operands give other bits on x than on "
                                 f"fp32(bf16(x)) at {where}")
    shape = {"shape": [b, h, t, d], "kv_heads": hk, "causal": causal, "padded": padded, "dtype": dtype,
             "one_pass": True, "err_over_bound": over, "lse_err_over_gate": lse_gate,
             "lse_err_vs_fp32_plain": (lse - plse).abs().max().item(), "dslopes_err": dslopes_err}
    fwd = {**shape, "max_abs_err": (o.float() - po.float()).abs().max().item()}
    dkv = {**shape, "max_abs_err": max((x.float() - y.float()).abs().max().item() for x, y in zip(got[:2], want[:2]))}
    dq = {**shape, "max_abs_err": max((x.float() - y.float()).abs().max().item() for x, y in zip(got[2:], want[2:]))}
    if not timed:
        return fwd, dkv, dq
    # the kernels alone, writing outputs in the inputs' dtype, on the
    # operands as their wrappers receive them (no wrapper makes a copy)
    ops = [(q.clone(), k.clone(), v.clone(), dout.clone())
           for _ in range(n_copies(q.element_size() * (q.numel() + k.numel() + v.numel() + dout.numel())))]
    fwd["ms"] = graph_ms(torch, lambda qc, kc, vc, dc: fa._fwd_launch(qc, kc, vc, slopes, mask, causal, scale, True),
                         ops, iters=50)

    def bwd(name, outs):
        return lambda qc, kc, vc, dc: fa._bwd_launch(
            f"flash_attention_bwd_{name}", f"sp_flash_attention_bwd_{name}", qc, kc, vc, slopes, mask, dc, lse, delta,
            causal, scale, outs(), True)

    dkv["ms"] = graph_ms(torch, bwd("dkv", lambda: (torch.empty_like(k), torch.empty_like(v))), ops, iters=20)
    parts = fa.dq_slope_parts(b, h, hk, t)
    dq["ms"] = graph_ms(torch, bwd("dq", lambda: (torch.empty_like(q), torch.empty(parts, device=q.device))), ops,
                        iters=20)
    del ops
    fwd["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, slopes, mask, causal, one_pass=True))
    dkv["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_plain(*args, one_pass=True), iters=10,
                              warmup=2)
    dq["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq_plain(*args, one_pass=True), iters=10, warmup=2)
    for rec in (fwd, dkv, dq):
        rec["plain_timing"] = "eager"
    # the library: SDPA on bf16 q, k, v (bias materialized in bf16)
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, dout))
    bias, ok = sdpa_bias(torch, slopes, mask, causal)
    bias = bias.bfloat16()
    sdpa = [(qb.clone(), kb.expand(b, h, t, d).contiguous(), vb.expand(b, h, t, d).contiguous())
            for _ in range(n_copies(3 * 2 * q.numel()))]
    fwd["library_ms"] = graph_ms(
        torch, lambda qc, kc, vc: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=bias), sdpa, iters=50)
    del sdpa, bias
    fwd["over_library"] = fwd["ms"] / fwd["library_ms"]
    library, library_timing = sdpa_backward_ms(torch, qb, kb, vb, dob, slopes, mask, causal)
    dkv["library_ms"] = dq["library_ms"] = library
    dkv["library_timing"] = dq["library_timing"] = library_timing
    dkv["pair_over_library"] = dq["pair_over_library"] = (dkv["ms"] + dq["ms"]) / library
    print(f"one-pass kernels ({dtype}) at {(b, h, hk, d, t, causal, padded)}, on the operands as received: forward "
          f"{fwd['ms']:.4f} ms, SDPA's bf16 forward {fwd['library_ms']:.4f}; dK/dV {dkv['ms']:.4f}, dQ/dslope "
          f"{dq['ms']:.4f} ms, SDPA's bf16 backward {library:.4f}")
    # bounds: each kernel's bf16 passes (ONE_PASS_PASSES) at 989 TFLOP/s,
    # against its bytes: operands read once and outputs written once in the
    # inputs' dtype, fp32 lse, delta, slopes and slope parts
    pairs = ok.expand(b, 1, t, t).sum().item()
    product = 2 * d * h * pairs
    f32, out = 4, q.element_size()
    for rec, key, nbytes in (
        (fwd, "fwd", out * (2 * q.numel() + k.numel() + v.numel()) + f32 * (lse.numel() + h) + mask.numel()),
        (dkv, "dkv", out * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()) + f32 * (2 * lse.numel() + h)
         + mask.numel()),
        (dq, "dq", out * (3 * q.numel() + k.numel() + v.numel()) + f32 * (2 * lse.numel() + h + math.prod(parts))
         + mask.numel()),
    ):
        t_ops, t_bytes = ONE_PASS_PASSES[key] * product / BF16_OPS_PER_S, nbytes / BYTES_PER_S
        rec.update(bf16_passes=ONE_PASS_PASSES[key], bound_by="operations" if t_ops > t_bytes else "bytes",
                   bound_ms=max(t_ops, t_bytes) * 1e3)
    return fwd, dkv, dq


def check_flash_head_dims(torch, fa, timed=True):
    """The three flash kernels at the recipes' other head dims, 128
    (scale_1024's decoder: 8 heads, one KV head) and 16 (recipes/smoke.yaml:
    2 heads, one KV head), against their plain versions, each case twice for
    the same bits: fp32 within `check_flash`'s and `check_flash_bwd`'s gates,
    bf16 within one bf16 ulp (`check_flash_bf16`); t from 1 to 129 around the
    tiles, padded tails beside an element with no valid key, keys that start
    late, one KV head per query head (MHA). Then, timed when `timed` (fp32
    and bf16), the shapes the scale regime's and the smoke-shaped paths
    give them (FLASH_TIMED_SHAPES), with scale_1024's encoders (8 heads of
    64, 8 KV heads) beside them. Returns {"fwd", "bwd", "bf16"} records of the edge
    cases and {"timed"}: per shape, the forward, dK/dV, dQ/dslope and pair
    records in fp32 and the bf16 ones."""
    fwd, bwd, bf16 = [], [], []
    for h, d in FLASH_NEW_DIMS:
        shape = dict(h=h, d=d)
        for t in (1, 15, 17, 63, 65, 129):
            for c in (False, True):
                fwd.append(check_flash(torch, fa, 2, t, causal=c, padded=False, timed=False, **shape))
                bwd.append(check_flash_bwd(torch, fa, 2, t, causal=c, padded=False, timed=False, **shape))
                if t > 1:
                    bf16.append(check_flash_bf16(torch, fa, 2, t, causal=c, padded=False, timed=False, **shape))
        cases = [dict(b=4, t=SERVE_BUCKET, causal=c, padded="tails", lengths=[0, 3, 64, 130]) for c in (False, True)] + [
            dict(b=3, t=200, causal=True, padded="late", lengths=[(70, 200), (5, 90), (130, 131)]),
            dict(b=3, t=77, causal=True, padded="empty"), dict(b=2, t=77, causal=False, padded="empty"),
            dict(b=2, t=130, causal=False, padded=True, hk=h), dict(b=2, t=77, causal=True, padded="empty", hk=h)]
        for case in cases:
            fwd.append(check_flash(torch, fa, timed=False, **shape, **case))
            bwd.append(check_flash_bwd(torch, fa, timed=False, **shape, **case))
            bf16.append(check_flash_bf16(torch, fa, timed=False, **shape, **case))
    timed = []
    for b, h, hk, d, t, causal, what in FLASH_TIMED_SHAPES:
        shape = dict(h=h, d=d, hk=hk)
        rec = {"path": what, "fwd": check_flash(torch, fa, b, t, causal=causal, padded=True, timed=timed, **shape)}
        rec["dkv"], rec["dq"], rec["pair"] = check_flash_bwd(torch, fa, b, t, causal=causal, padded=True, timed=timed,
                                                             **shape)
        if t <= 1026:  # the bf16 model trains at 1024 notes
            rec["bf16"] = dict(zip(("fwd", "dkv", "dq"), check_flash_bf16(torch, fa, b, t, causal=causal, padded=True,
                                                                           timed=timed, **shape)))
        timed.append(rec)
    return {"fwd": fwd, "bwd": bwd, "bf16": bf16, "timed": timed}


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
    error of o and lse <= 1e-4. At a head dim the kernel is not built for,
    the kernel reads the same cache in the layout the decode writes on the
    card (each head zero-padded to the next built width) and the plain
    version the cache itself. Returns the record of this case (times only
    when `timed`)."""
    import torch.nn.functional as F
    from scoreperformer_tpu_torch.models.attention import quantize_kv_rows
    from scoreperformer_tpu_torch.ops import head_layout

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
    width = head_layout.head_width(d, dev)
    kc, vc = (head_layout.pad_head_dim(x.reshape(cap, b, kvh, d), width).flatten(2) for x in (k, v))
    o, lse = pa.prefix_attend(q, kc, vc, bias, *scales, n_valid=base)
    o2, lse2 = pa.prefix_attend(q, kc, vc, bias, *scales, n_valid=base)
    po, plse = pa.prefix_attend_plain(q, k, v, bias, *scales, n_valid=base)
    torch.cuda.synchronize()
    err = max((o - po).abs().max().item(), (lse - plse).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"prefix_attend differs from its plain version by {err} at "
                             f"{(b, cap, base, dtype, h, d, kvh)}")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"two prefix_attend calls give other bits at {(b, cap, base, dtype, h, d, kvh)}")
    # the first launch's query heads a KV head (`prefix_attend`'s own groups)
    rows = pa.launch_groups(h, kvh)[0][2]
    tile, splits, per = pa.grid_plan(q.device, b * kvh, base, width, rows, k.dtype)
    rec = {"shape": [b, h, d], "cap": cap, "base": base, "dtype": dtype, "kv_heads": kvh, "tile": tile,
           "splits": splits, "tiles_per_split": per, "max_abs_err": err, "same_bits": True}
    if width != d or rows != h // kvh:
        rec.update(width=width, heads_a_launch=rows)
    if timed:
        # the bytes this call needs: the first `base` rows of k and v (and
        # their scales), q, the bias columns it reads, o and lse
        read = 2 * base * b * kvh * d * k.element_size() + (2 * base * b * 4 if dtype == "int8" else 0)
        nbytes = read + 4 * (2 * q.numel() + h * base + b * h)
        ops = 4 * d * h * b * base  # q.k and p.v, a multiply and an add each
        copies = [(kc.clone(), vc.clone()) for _ in range(n_copies(read))]
        rec["ms"] = graph_ms(torch, lambda kx, vx: pa.prefix_attend(q, kx, vx, bias, *scales, n_valid=base),
                             copies, iters=200)
        if width != d:
            copies = [(k.clone(), v.clone()) for _ in range(n_copies(read))]
        rec["plain_ms"] = graph_ms(
            torch, lambda kx, vx: pa.prefix_attend_plain(q, kx, vx, bias, *scales, n_valid=base), copies, iters=50)
        # the same calls back to back without a graph: what a caller pays,
        # host included
        rec["eager_ms"] = time_ms(torch, lambda: pa.prefix_attend(q, kc, vc, bias, *scales, n_valid=base), iters=200)
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


def prefix_split_sweep(torch, pa, b=SERVE_REQUESTS, cap=SERVE_BUCKET, base=SERVE_BUCKET // 2, d=64, h=4,
                       dtype="fp32"):
    """Device ms of the prefix_attend kernel (one KV head) at a decode shape
    against its split count: every split of its tiles into up to 16 runs of
    whole tiles, called at its C entry with the cache cycling through copies
    larger than L2, beside the split count `grid_plan` picks: what the plan
    rests on."""
    from scoreperformer_tpu_torch.models.attention import quantize_kv_rows
    from scoreperformer_tpu_torch.ops import _build

    fn = _build.kernel("prefix_attend", "sp_prefix_attend")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(b, h, d, device="cuda", generator=g) * d**-0.5
    k = torch.randn(cap, b, d, device="cuda", generator=g)
    v = torch.randn(cap, b, d, device="cuda", generator=g)
    bias = torch.zeros(h, cap, device="cuda")
    k_s = v_s = None
    if dtype == "int8":
        (k, k_s), (v, v_s) = quantize_kv_rows(k), quantize_kv_rows(v)
    o, lse = torch.empty(b, h, d, device="cuda"), torch.empty(b, h, device="cuda")
    cold = [(k.clone(), v.clone()) for _ in range(n_copies(2 * base * b * d * k.element_size()))]
    tile, plan, _ = pa.grid_plan(q.device, b, base, d, h, k.dtype)
    n_tiles = -(-base // tile)

    def ms(per):
        def call(kc, vc):
            err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bias.data_ptr(),
                     k_s.data_ptr() if k_s is not None else None, v_s.data_ptr() if v_s is not None else None,
                     o.data_ptr(), lse.data_ptr(), b, h, 1, d, cap, base, -(-n_tiles // per), per, tile,
                     pa._DTYPE_CODES[k.dtype], torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"prefix_attend: CUDA error {err}")

        return graph_ms(torch, call, cold, iters=200)

    pers = sorted({-(-n_tiles // n) for n in range(1, min(pa.MAX_CLUSTER, n_tiles) + 1)}, reverse=True)
    return {"shape": [b, h, d], "cap": cap, "base": base, "dtype": dtype, "tile": tile, "plan": plan,
            "cold_ms": {-(-n_tiles // per): ms(per) for per in pers}}


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


FLASH = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# PyTorch's copy kernels (names holding `copy_kernel`), which convert
# dtypes: in a profile of the flagship's step the one-pass wrappers'
# rounding copies were what the "medium" step ran beyond the fp32 one (110
# with every wrapper rounding, 30 with the forward's alone; H100,
# chip_probe_precision.py::profiled_steps)
CONVERSION_KERNEL = "copy_kernel"
# the "medium" step's conversions over the fp32 step's, at most: a profile's
# count moves by a few between steps and runs, and the forward wrapper's
# copies (3 a launch, 30 a step) gave +22 to +30 (H100: 298, 299 and 299
# against 276 in three runs of one program, 307 against 277 in another)
CONVERSIONS_OVER_FP32_LIMIT = 15


def flash_counts(fa, dtype="fp32"):
    """The flash wrappers' counts of their fp32 (`launches`), bf16
    (`launches_bf16`) or one-pass (`launches_one_pass`, either operand
    dtype) kernel instances."""
    attr = {"bf16": "launches_bf16", "one_pass": "launches_one_pass"}.get(dtype, "launches")
    return {name: getattr(getattr(fa, name), attr) for name in FLASH}


def reset_counts(fa, kv, pa):
    kv.write_kv.launches = kv.write_kv_pair.launches = pa.prefix_attend.launches = 0
    for name in FLASH:
        getattr(fa, name).launches = getattr(fa, name).launches_bf16 = getattr(fa, name).launches_one_pass = 0


def all_counts(fa, kv, pa):
    return {"write_kv": kv.write_kv.launches, "write_kv_pair": kv.write_kv_pair.launches,
            "prefix_attend": pa.prefix_attend.launches, **flash_counts(fa),
            **{f"{name}_bf16": n for name, n in flash_counts(fa, "bf16").items()},
            **{f"{name}_one_pass": n for name, n in flash_counts(fa, "one_pass").items()}}


def decode_launches(n_steps, layers=DECODER_LAYERS, flash=2 + 4):
    """The launches of one render, any batch: `flash` flash forwards (the
    flagship's: one per encoder layer, 2 score and 4 MMD; none without
    use_flash), then a chunked decode of `n_steps` steps with one
    `write_kv_pair` (the layer's K and V rows) and one `prefix_attend` per
    decoder layer and step; no single `write_kv` and no backward."""
    return {"write_kv": 0, "write_kv_pair": layers * n_steps, "prefix_attend": layers * n_steps,
            "flash_attention_fwd": flash, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            **{f"{name}{suffix}": 0 for name in FLASH for suffix in ("_bf16", "_one_pass")}}


def check_launches(what, got, expected):
    if got != expected:
        raise AssertionError(f"{what} launched {got}, expected {expected}")


def train_steps(torch, fa, kv, pa, trainer, dataset, n_warmup, n_timed, dtype="fp32", flash=10):
    """Train steps through `Trainer.train_step` on the trainer's own batches;
    every step's losses must be finite and launch `flash` flash forwards and
    as many of each backward kernel, all of them the `dtype` instances
    ("fp32", "bf16" or "one_pass").
    Returns (step times in ms, launch totals, the last device batch, valid
    notes per batch, the last step's metrics)."""
    n = n_warmup + n_timed
    batches, epoch = [], 0
    while len(batches) < n:
        batches += list(trainer._iter_batches(dataset, trainer.config.batch_size, True, epoch))
        epoch += 1
    times, notes = [], []
    reset_counts(fa, kv, pa)
    for step, host_batch in enumerate(batches[:n]):
        batch = trainer._put_batch(host_batch)
        before = all_counts(fa, kv, pa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, step)
        torch.cuda.synchronize()
        if step >= n_warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v - before[k] for k, v in all_counts(fa, kv, pa).items()}
        suffix = {"bf16": "_bf16", "one_pass": "_one_pass"}.get(dtype, "")
        expected = {k: flash if k in {name + suffix for name in FLASH} else 0 for k in per_step}
        if per_step != expected:
            raise AssertionError(f"train step {step} launched {per_step}, expected {expected}")
        values = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step {step}: non-finite metrics {values}")
        notes.append(int(host_batch["perf_mask" if "perf_mask" in host_batch else "mask"].sum()))
        terms = "".join(f" {k} {values[k]:.5f}" for k in ("MMD", "loss/lm") if k in values)
        clf = "".join(f" {k} {v:.5f}" for k, v in values.items() if k.startswith("clf"))
        print(f"train step {step}: loss {values['loss']:.5f} grad_norm {values['stats/grad_norm']:.4f}"
              f"{terms}{clf}")
    return times, all_counts(fa, kv, pa), batch, notes, values


@contextlib.contextmanager
def plain_flash(fa):
    """The flash wrappers swapped for their plain versions, on CUDA tensors
    too (the autograd Function calls them by their module names)."""
    saved = {name: getattr(fa, name) for name in FLASH}
    fa.flash_attention_fwd = lambda q, k, v, slopes, mask=None, causal=True, scale=None, one_pass=False: (
        fa.flash_attention_plain(q, k, v, slopes, mask, causal, scale, return_lse=True, one_pass=one_pass))
    fa.flash_attention_bwd_dkv = fa.flash_attention_bwd_dkv_plain
    fa.flash_attention_bwd_dq = fa.flash_attention_bwd_dq_plain
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)


def compare_train_step(torch, model_config, host_batch, b=4, devices=("cpu", "cuda"), precision="fp32",
                       optimizer=None, reference_plain_flash=False, reference_matmul=None, by_name=False):
    """One train step (forward, loss, backward) of the same weights on the
    card and on the CPU (the plain versions), on the first `b` sequences and
    the same MMD samples: {"loss_err", "loss_rel" (its relative error),
    "grad_err" (the largest gradient error over that gradient's largest
    value), "grad_rel_l2" (the largest relative L2 error of a gradient) and
    its "worst" gradient, "global_rel_l2" (over all gradients as one
    vector), "gradients" (their number), and with `by_name` "grad_errs"
    (each gradient's error over its largest value, by name)}. `precision`: "fp32";
    "bf16_compute", the Trainer's bf16 copies of the fp32 parameters; "bf16",
    the model held in bf16. With `optimizer` (an OptimizerConfig dict) the
    step also updates the parameters, and the gradient errors are those of
    the parameters after the update. With `reference_plain_flash` the
    reference (the first of `devices`) runs the plain flash functions; with
    `reference_matmul` it runs under that `torch.set_float32_matmul_precision`
    (the other under the global one). A
    model without an MMD style encoder (the standalone Performer) takes no
    MMD samples. An MoE model's loss is the trainer's: its layers' aux
    added."""
    from scoreperformer_tpu_torch.convert import jax_param_paths
    from scoreperformer_tpu_torch.models.factory import build_model
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.training import Optimizer, OptimizerConfig
    from scoreperformer_tpu_torch.training.trainer import _bf16_parameters

    cfg = {k: v for k, v in model_config.items() if not k.startswith("_")}
    enc = cfg.get("perf_encoder") or {}
    gen = torch.Generator().manual_seed(SEED)
    draws = []

    def draw(d, n_latents):
        z = torch.randn(enc.get("mmd_num_samples", 256), d, generator=gen)
        m = enc.get("mmd_max_num_latents", 4096)
        draws.append((z, torch.rand(m, generator=gen) if n_latents > m else None))
        return draws[-1]

    results = {}
    for dev in devices:
        t_dev = time.perf_counter()
        model, _ = build_model(model_config.get("_name_", "ScorePerformer"), cfg, device=dev, seed=SEED)
        if precision == "bf16":
            model.to(torch.bfloat16)
        model.train()
        batch = {k: torch.as_tensor(np.asarray(v)[:b]).to(dev) for k, v in host_batch.items()}
        replay = iter(list(draws))
        sampler = (lambda d, n: tuple(None if x is None else x.to(dev) for x in draw(d, n))) if not draws else (
            lambda d, n: tuple(None if x is None else x.to(dev) for x in next(replay)))
        with contextlib.ExitStack() as stack:
            if precision == "bf16_compute":
                stack.enter_context(_bf16_parameters(model))
            if reference_plain_flash and not results:
                stack.enter_context(plain_flash(fa))
            if reference_matmul is not None and not results:
                stack.callback(torch.set_float32_matmul_precision, torch.get_float32_matmul_precision())
                torch.set_float32_matmul_precision(reference_matmul)
            out = model(**batch, **({"mmd_sampler": sampler} if enc else {}))
            loss = out.loss.float() if out.moe_aux is None else out.loss.float() + out.moe_aux
            loss.backward()
        if optimizer is not None:
            transposed = [n for n, (_, t) in jax_param_paths(model).items() if t]
            opt = Optimizer(model.named_parameters(), OptimizerConfig.from_dict(optimizer), 1, transposed)
            opt.plateau_scale = 0.5 if opt.plateau_scale is not None else None
            opt.step()
            values = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
        else:
            values = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters() if p.grad is not None}
        results[len(results)] = (loss.item(), values)
        if dev == "cpu":
            CPU_REF_S[_PHASE[0]] = CPU_REF_S.get(_PHASE[0], 0.0) + time.perf_counter() - t_dev
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results[0], results[1]
    if set(cpu_grads) != set(gpu_grads):
        raise AssertionError("the card's step and the CPU's reach different parameters")
    grad_errs = {n: ((gpu_grads[n] - g).abs().max() / g.abs().max().clamp_min(1e-12)).item()
                 for n, g in cpu_grads.items()}
    grad_err = max(grad_errs.values())
    rel_l2, worst = max((((gpu_grads[n] - g).norm() / g.norm().clamp_min(1e-30)).item(), n)
                        for n, g in cpu_grads.items())
    diff = math.sqrt(sum(((gpu_grads[n] - g).norm() ** 2).item() for n, g in cpu_grads.items()))
    total = math.sqrt(sum((g.norm() ** 2).item() for g in cpu_grads.values()))
    return {"loss_err": abs(gpu_loss - cpu_loss), "loss_rel": abs(gpu_loss - cpu_loss) / abs(cpu_loss),
            "grad_err": grad_err, "grad_rel_l2": rel_l2, "worst": worst, "global_rel_l2": diff / total,
            "gradients": len(cpu_grads), **({"grad_errs": grad_errs} if by_name else {})}


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

    torch.cuda.reset_peak_memory_stats()  # this phase's peak, not the phases' before it
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
    gate = compare_train_step(torch, model_config, host_batch)
    loss_err, grad_err, n_grads = gate["loss_err"], gate["grad_err"], gate["gradients"]
    rec["card_vs_cpu"] = {"loss_err": loss_err, "grad_err": grad_err, "gradients": n_grads}
    print(f"paper recipe train step at batch 4, card vs CPU: loss error {loss_err:.3g}, largest gradient error "
          f"over its largest value {grad_err:.3g} ({n_grads} gradients, the classifier heads' included)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3):
        raise AssertionError(f"the paper recipe's step on the card differs from the CPU's: loss {loss_err}, "
                             f"gradients {grad_err}")
    lap("card_vs_cpu")
    return rec


def train_record(torch, step_ms, notes, launches, batch=TRAIN_BATCH, seq=TRAIN_SEQ + 2):
    median_ms = float(np.median(step_ms))
    return {"step_ms": step_ms, "median_step_ms": median_ms, "tokens_per_s": batch * seq / median_ms * 1e3,
            "valid_notes_per_s": float(np.mean(notes)) / median_ms * 1e3, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def options_phase(torch, tokenizer, root, work):
    """The trainer's options on the card, on the train phase's dataset at
    `root`:
    (b) the flagship (use_flash=True) with `bf16_compute`: 10 + 2 steps at
        batch 128, profiled; its activations stay fp32 as JAX's do (the
        stream tables promote), so the fp32 flash instances run, 10 of each
        a step; a batch-4 step against the CPU's; then the flagship held in
        bf16 (`model.to(torch.bfloat16)`, every floating tensor), whose
        attention inputs are bf16: the bf16 flash instances, 10 of each a
        step, profiled, and a batch-4 step against the CPU's;
    (c) the fp32 step with `remat`: gradients equal to the step without it
        (same generators), peak memory and step time of both;
    (d) recipes/scoreperformer/scale_1024.yaml trained as the recipe sets
        it: dim 1024, batch 8, sequences of 1024 notes (windows of 96 bars),
        zero_sharding, fp32, no flash, softmax_bf16, base.yaml's classifiers;
    (e) one batch-4 flagship step each with lamb, lion and adafactor (the
        plateau schedule at scale 0.5): the parameters after the update
        against the CPU's.
    Returns the phase's record."""
    from scoreperformer_tpu_torch.data import build_synthetic_dataset
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.training import ExperimentComponents

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):  # host seconds of each step of the phase
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    def components(cfg, **trainer):
        cfg["trainer"].update(trainer)
        comp = ExperimentComponents(cfg, device="cuda").init_components()
        return comp

    rec = {"phase_s": phase_s}
    # (b) bf16_compute, then the model held in bf16
    for name, precision in (("bf16_compute", "bf16_compute"), ("bf16_model", "bf16")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = train_config(tokenizer, root, os.path.join(work, name), TRAIN_BATCH, 2)
        comp = components(cfg, bf16_compute=precision == "bf16_compute")
        if precision == "bf16":
            comp.model.to(torch.bfloat16)
        trainer = comp.trainer
        trainer._prepare()
        dtype = "bf16" if precision == "bf16" else "fp32"
        step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset,
                                                              TRAIN_WARMUP, TRAIN_TIMED, dtype=dtype)
        rec[name] = train_record(torch, step_ms, notes, launches)
        rec[name]["last_loss"] = values["loss"]
        prof = profile_device(torch, lambda: trainer.train_step(batch, TRAIN_WARMUP + TRAIN_TIMED),
                              ported=PORTED_TRAIN)
        rec[name]["profile"] = prof
        counts = {k: prof["ported"][k]["count"] for k in PORTED_TRAIN}
        if counts != {k: 10 for k in PORTED_TRAIN}:
            raise AssertionError(f"the profiled {name} step ran the flash kernels {counts} times, expected 10 of each")
        kernels = {k for n in PORTED_TRAIN for k in prof["ported"][n]["kernels"]}
        if any(bf16_instance(k) != (precision == "bf16") for k in kernels):
            raise AssertionError(f"the profiled {name} step ran the flash kernels {sorted(kernels)}")
        host_batch = next(trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0))
        model_config = comp.model_config
        del comp, trainer, batch
        torch.cuda.empty_cache()
        gate = compare_train_step(torch, model_config, host_batch, precision=precision)
        rec[name]["card_vs_cpu"] = gate
        # bf16_compute: the CPU test's gates (tests/test_torch_bf16.py), loss
        # 1e-5 relative and each gradient 5e-3 relative L2 (a gradient is a
        # bf16 cotangent, rounded to bf16). The bf16 model rounds every
        # activation and cotangent to bf16 in the order its device's GEMMs
        # and reductions sum, which the card and the CPU do not share: its
        # card-vs-CPU record is kept, and its gate holds the kernels' step
        # against the same step on the card with the plain flash functions,
        # as one vector (a cancelling sum such as the ALiBi slopes' gradient
        # can differ wholly), to the gates first set for bf16_compute, loss
        # 1e-2 and gradients 5e-2
        if precision == "bf16_compute":
            ok = gate["loss_rel"] <= 1e-5 and gate["grad_rel_l2"] <= 5e-3
        else:
            gate = compare_train_step(torch, model_config, host_batch, devices=("cuda", "cuda"), precision=precision,
                                      reference_plain_flash=True)
            rec[name]["kernels_vs_plain_on_card"] = gate
            ok = gate["loss_rel"] <= 1e-2 and gate["global_rel_l2"] <= 5e-2
        print(f"{name} train steps", json.dumps(rec[name]))
        if not ok:
            raise AssertionError(f"the {name} step on the card differs from the CPU's: {gate}")
        lap(name)

    # (c) remat: the same fp32 step's gradients, and the peak memory of both.
    # Deterministic algorithms for the comparison: the MMD subsample's
    # backward (`flat[idx]` with repeated indices) accumulates by atomics,
    # so two plain steps differ in the last bits otherwise
    cfg = train_config(tokenizer, root, os.path.join(work, "remat"), TRAIN_BATCH, 2)
    comp = components(cfg)
    trainer, model = comp.trainer, comp.model
    trainer._prepare()
    batch = trainer._put_batch(next(trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0)))
    grads, rec["remat"] = {}, {}
    model.train()
    torch.use_deterministic_algorithms(True, warn_only=True)
    for remat in (False, True, False, True):  # in turns; the second pair is timed
        trainer.config.remat = remat
        model.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _ = trainer.loss_fn(batch, 5)
        loss.backward()
        torch.cuda.synchronize()
        key = "remat" if remat else "plain"
        rec["remat"][key] = {"forward_backward_ms": (time.perf_counter() - t0) * 1e3,
                             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "activation_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                             "loss": loss.item()}
        grads[remat] = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    torch.use_deterministic_algorithms(False)
    err = max(((grads[True][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item() for n, g in grads[False].items())
    rec["remat"]["grad_err"] = err
    print("remat", json.dumps(rec["remat"]))
    if set(grads[True]) != set(grads[False]) or not err <= 1e-5:
        raise AssertionError(f"remat changes the gradients on the card by {err}")
    del comp, trainer, model, batch, grads
    torch.cuda.empty_cache()
    lap("remat")

    # (d) scale_1024.yaml as the recipe sets it
    scale_root = os.path.join(work, "scale_data")
    build_synthetic_dataset(scale_root, n_scores=4, n_perfs_per_score=2, n_bars=SCALE_SCORE_BARS, seed=SEED,
                            splits=True)
    cfg = train_config(tokenizer, scale_root, os.path.join(work, "scale_run"), SCALE_TRAIN_BATCH, 2)
    cfg["data"]["dataset"].update(max_seq_len=SCALE_TRAIN_SEQ, bar_sliding_window=SCALE_WINDOW_BARS,
                                  performance_directions=os.path.join(scale_root, "direction_classes.json"),
                                  score_directions_dict=os.path.join(scale_root, "score_directions.json"))
    cfg["model"] = {"_name_": "ScorePerformer", **scale_1024_config(tokenizer),
                    "classifiers": json.loads(json.dumps(PAPER_CLASSIFIERS))}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    comp = components(cfg, zero_sharding=True, bf16_compute=False, remat=False, eval_batch_size=SCALE_TRAIN_BATCH)
    trainer = comp.trainer
    trainer._prepare()
    step_ms, launches, _, notes, values = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset, 2, 4, flash=0)
    rec["scale_1024"] = {**train_record(torch, step_ms, notes, launches, SCALE_TRAIN_BATCH, SCALE_TRAIN_SEQ + 2),
                         "parameters": sum(p.numel() for p in comp.model.parameters()),
                         "last_step": {k: v for k, v in values.items() if k == "loss" or k.startswith("clf")}}
    print("scale_1024 train steps", json.dumps(rec["scale_1024"]))
    rec["scale_1024"]["filled_share"] = float(np.mean(notes)) / (SCALE_TRAIN_BATCH * SCALE_TRAIN_SEQ)
    if not rec["scale_1024"]["filled_share"] >= 0.75:  # windows are sampled; most fill their 1024 notes
        raise AssertionError(f"scale_1024's batches hold {np.mean(notes)} valid notes, not sequences of "
                             f"{SCALE_TRAIN_SEQ}")
    del comp, trainer
    torch.cuda.empty_cache()
    shutil.rmtree(scale_root, ignore_errors=True)
    lap("scale_1024")

    # (e) lamb, lion and adafactor with the plateau schedule, card vs CPU
    cfg = train_config(tokenizer, root, os.path.join(work, "opt"), TRAIN_BATCH, 2)
    comp = components(cfg)
    host_batch = next(comp.trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0))
    model_config = comp.model_config
    del comp
    torch.cuda.empty_cache()
    rec["optimizers"] = {}
    for name in OPTIMIZER_CHECKS:
        opt = {"optimizer": name, "lr": 1e-5, "lr_scheduler": "plateau", "grad_clip": 2.0}
        gate = compare_train_step(torch, model_config, host_batch, optimizer=opt)
        rec["optimizers"][name] = {"param_err": gate["grad_err"], "param_rel_l2": gate["grad_rel_l2"],
                                   "worst": gate["worst"], "parameters": gate["gradients"]}
        if not gate["grad_rel_l2"] <= 1e-4:
            raise AssertionError(f"{name}: the parameters after the card's update differ from the CPU's: "
                                 f"{rec['optimizers'][name]} (relative L2 of a parameter)")
    print("optimizers card vs CPU", json.dumps(rec["optimizers"]))
    lap("optimizers")
    return rec


def scale_flash_train_config(tokenizer, root, out_dir, seq):
    """The experiment config of the scale regime with the flash kernels:
    options_phase's scale_1024 training (the recipe's batch of 8, base.yaml's
    classifiers, zero_sharding, fp32) with `scale_flash_config`'s model, at
    data max_seq_len `seq` over windows of SCALE_WINDOW_BARS bars a 1024
    notes."""
    cfg = train_config(tokenizer, root, out_dir, SCALE_TRAIN_BATCH, 2)
    cfg["data"]["dataset"].update(max_seq_len=seq, bar_sliding_window=SCALE_WINDOW_BARS * seq // SCALE_TRAIN_SEQ,
                                  performance_directions=os.path.join(root, "direction_classes.json"),
                                  score_directions_dict=os.path.join(root, "score_directions.json"))
    cfg["model"] = {"_name_": "ScorePerformer", **scale_flash_config(tokenizer, seq),
                    "classifiers": json.loads(json.dumps(PAPER_CLASSIFIERS))}
    cfg["trainer"].update(zero_sharding=True, bf16_compute=False, remat=False, eval_batch_size=SCALE_TRAIN_BATCH)
    return cfg


def scale_flash_phase(torch, tokenizer, work, smi):
    """scripts/exp_scale_flash.py's regime through the normal entry points:
    recipes/scoreperformer/scale_1024.yaml (285M parameters, base.yaml's
    classifiers, zero_sharding, fp32) with `use_flash` in every stack and no
    decoder attention dropout (`scale_flash_train_config`), built by
    `ExperimentComponents` and trained by the `Trainer`:
    (a) batch 8 x 1024 notes: 2 + 10 steps, each launching every flash kernel
        SCALE_FLASH_LAUNCHES times (4 + 6 encoder layers at d = 64 with 8 KV
        heads, 8 causal decoder layers at d = 128 with one), a profiled step;
        then the same model with use_flash off (every attention layer's
        flag) on the same batches, 1 + 1 steps and a profiled one; a
        deterministic eval pass (a forward of each kernel a layer, no
        backward); a batch-2 x SCALE_GATE_SEQ-note step on the card against
        the port's CPU path on the same weights (dropout off: the two draw
        other masks), loss 1e-4 and gradients 1e-3 of their largest;
    (b) batch 8 x 2048 notes (model positions 2050, segments 2052): 2 + 2
        flash steps, and without the kernels 1 + 1 steps (an out-of-memory
        step is recorded as such), each with its peak memory and a profiled
        step;
    (e) the model held in bf16 at 1024 notes: 1 + 2 steps on the bf16
        instances, then a batch-2 step against the same step with the plain
        flash functions on the card (loss 1e-2 relative, gradients 5e-2
        relative L2 over all, options_phase's gates for the bf16 flagship).
    Returns the phase's record."""
    from scoreperformer_tpu_torch.data import build_synthetic_dataset
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.training import ExperimentComponents

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):  # host seconds of each step of the phase
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "data")
    build_synthetic_dataset(root, n_scores=4, n_perfs_per_score=2, n_bars=SCALE_SCORE_BARS, seed=SEED, splits=True)
    lap("dataset")
    rec = {"phase_s": phase_s, "layers": {"score_encoder": 4, "perf_encoder": 6, "decoder": 8}, "card": smi}

    def build(seq, dtype=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        comp = ExperimentComponents(scale_flash_train_config(tokenizer, root, os.path.join(work, f"run_{seq}"), seq),
                                    device="cuda").init_components()
        if dtype is not None:
            comp.model.to(dtype)
        comp.trainer._prepare()
        return comp

    def profiled(trainer, batch, step, flash):
        prof = profile_device(torch, lambda: trainer.train_step(batch, step), ported=PORTED_TRAIN)
        counts = {k: prof["ported"][k]["count"] for k in PORTED_TRAIN}
        if counts != {k: flash for k in PORTED_TRAIN}:
            raise AssertionError(f"a profiled scale_1024 step ran the flash kernels {counts} times, expected {flash}")
        return prof

    def steps(comp, seq, n_warmup, n_timed, flash, dtype="fp32"):
        torch.cuda.reset_peak_memory_stats()
        step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, comp.trainer, comp.train_dataset,
                                                              n_warmup, n_timed, dtype=dtype, flash=flash)
        out = {**train_record(torch, step_ms, notes, launches, SCALE_TRAIN_BATCH, seq + 2),
               "last_step": {k: v for k, v in values.items() if k == "loss" or k.startswith("clf")},
               "filled_share": float(np.mean(notes)) / (SCALE_TRAIN_BATCH * seq)}
        if not out["filled_share"] >= 0.75:  # windows are sampled; most fill their notes
            raise AssertionError(f"the scale batches at {seq} notes hold {np.mean(notes)} valid notes")
        return out, batch, n_warmup + n_timed

    def without_flash(comp, seq):
        """The same model and batches with the kernels off: steps, peak
        memory, a profiled step; an out-of-memory step is recorded."""
        set_attention(comp.model, use_flash=False)
        torch.cuda.empty_cache()
        try:
            out, batch, n = steps(comp, seq, 1, 1, flash=0)
            out["profile"] = profiled(comp.trainer, batch, n, 0)
        except torch.cuda.OutOfMemoryError as exc:
            out = {"out_of_memory": str(exc).splitlines()[0], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            torch.cuda.empty_cache()
        set_attention(comp.model, use_flash=True)
        return out

    # (a) 1024 notes
    comp = build(SCALE_TRAIN_SEQ)
    rec["parameters"] = sum(p.numel() for p in comp.model.parameters())
    lap("build_1024")
    a, batch, n = steps(comp, SCALE_TRAIN_SEQ, 2, 10, SCALE_FLASH_LAUNCHES)
    a["profile"] = profiled(comp.trainer, batch, n, SCALE_FLASH_LAUNCHES)
    print(f"scale_1024 with use_flash, batch {SCALE_TRAIN_BATCH} x {SCALE_TRAIN_SEQ + 2} ({smi})", json.dumps(a))
    lap("train_1024")
    a["without_flash"] = without_flash(comp, SCALE_TRAIN_SEQ)
    print("scale_1024 without use_flash, the same batches", json.dumps(a["without_flash"]))
    lap("train_1024_without_flash")
    # a deterministic eval pass: the forward kernel in every layer, the decoder's too
    comp.model.eval()
    reset_counts(fa, kv, pa)
    with torch.no_grad():
        loss, _ = comp.trainer.loss_fn(batch, 0)
    a["eval_pass"] = {"loss": loss.item(), "launches": all_counts(fa, kv, pa)}
    comp.model.train()
    check_launches("the scale_1024 eval pass", a["eval_pass"]["launches"],
                   {k: SCALE_FLASH_LAUNCHES if k == "flash_attention_fwd" else 0 for k in a["eval_pass"]["launches"]})
    print("scale_1024 eval pass with use_flash", json.dumps(a["eval_pass"]))
    if not np.isfinite(a["eval_pass"]["loss"]):
        raise AssertionError(f"the scale_1024 eval pass gave loss {a['eval_pass']['loss']}")
    host_batch = {k: v.cpu().numpy() for k, v in batch.items()}
    short = {k: v[:, :SCALE_GATE_SEQ] if v.ndim >= 2 else v for k, v in host_batch.items()}
    model_config = json.loads(json.dumps(comp.model_config))
    del comp, batch
    torch.cuda.empty_cache()
    lap("eval_pass")
    gate = compare_train_step(torch, dropout_off(model_config), short, b=2)
    a["card_vs_cpu"] = {k: gate[k] for k in ("loss_err", "grad_err", "worst", "gradients")}
    print(f"scale_1024 with use_flash, a batch-2 x {SCALE_GATE_SEQ} step, card vs CPU", json.dumps(a["card_vs_cpu"]))
    if not (gate["loss_err"] <= 1e-4 and gate["grad_err"] <= 1e-3):
        raise AssertionError(f"the scale_1024 flash step on the card differs from the CPU's: {gate}")
    rec["seq_1024"] = a
    lap("card_vs_cpu")

    # (b) 2048 notes
    comp = build(SCALE_LONG_SEQ)
    lap("build_2048")
    b_rec, batch, n = steps(comp, SCALE_LONG_SEQ, 2, 2, SCALE_FLASH_LAUNCHES)
    b_rec["profile"] = profiled(comp.trainer, batch, n, SCALE_FLASH_LAUNCHES)
    print(f"scale_1024 with use_flash, batch {SCALE_TRAIN_BATCH} x {SCALE_LONG_SEQ + 2} ({smi})", json.dumps(b_rec))
    del batch
    lap("train_2048")
    b_rec["without_flash"] = without_flash(comp, SCALE_LONG_SEQ)
    print("scale_1024 at 2048 notes without use_flash, the same batches", json.dumps(b_rec["without_flash"]))
    rec["seq_2048"] = b_rec
    del comp
    lap("train_2048_without_flash")

    # (e) the model held in bf16: the bf16 instances at d = 128 (and the encoders' d = 64)
    comp = build(SCALE_TRAIN_SEQ, torch.bfloat16)
    e, batch, n = steps(comp, SCALE_TRAIN_SEQ, 1, 2, SCALE_FLASH_LAUNCHES, dtype="bf16")
    e["profile"] = profiled(comp.trainer, batch, n, SCALE_FLASH_LAUNCHES)
    del comp, batch
    torch.cuda.empty_cache()
    gate = compare_train_step(torch, dropout_off(model_config), short, b=2, devices=("cuda", "cuda"),
                              precision="bf16", reference_plain_flash=True)
    e["kernels_vs_plain_on_card"] = {k: gate[k] for k in ("loss_rel", "global_rel_l2", "grad_rel_l2", "worst")}
    print("scale_1024 held in bf16 with use_flash", json.dumps(e))
    if not (gate["loss_rel"] <= 1e-2 and gate["global_rel_l2"] <= 5e-2):
        raise AssertionError(f"the bf16 scale_1024 step's kernels differ from the plain flash functions: {gate}")
    rec["bf16_model"] = e
    lap("bf16_model")
    shutil.rmtree(root, ignore_errors=True)
    return rec


def profile_device(torch, fn, ported=("write_rows", "flash_fwd"), top=10, host_events=False, counted=()):
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI),
    the device's busy time, its idle share of the profiled wall time, and the
    totals of the ported kernels (by kernel-name substring). Only the CUDA
    activity is recorded: the host's operator events, most of a decode's
    trace, added about as much host time to the profiled call as the call
    itself and tens of seconds to the profiler's stop, and nothing here reads
    them. The device events (kernels, copies, sets) are summed by name from
    the profiler's raw events: `key_averages()` would first build a Python
    object for every event, which cost minutes of host time a run over the
    decode profiles' hundreds of thousands of kernels. `post_s`: the host
    seconds from the end of `fn` to the record (the profiler's stop and this
    sum). `host_events` records the host's operator events as well (what
    `profile_decode` falls back on); `hidden_device_events` counts the device
    events that the profiler marks hidden, which no sum here takes.
    `counted`: other kernels' totals by name substring, as `ported`'s (the
    dtype conversions, `CONVERSION_KERNEL`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_events else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    by_name = collections.defaultdict(lambda: [0, 0])  # kernel name -> [ns, launches]
    hidden = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_hidden_event():
                hidden += 1
                continue
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
        "hidden_device_events": hidden,
        "host_events": host_events,
        "top": [{"name": name[:70], "ms": ms, "count": n} for name, ms, n in device[:top]],
        "ported": {
            name: {"ms": sum(ms for _, ms, _ in hits), "count": sum(n for _, _, n in hits),
                   "kernels": sorted({k[:100] for k, _, _ in hits})}
            for name in ported
            for hits in [[e for e in device if name in e[0]]]
        },
        **({"counted": {name: {"ms": sum(ms for _, ms, _ in hits), "count": sum(n for _, _, n in hits),
                               "kernels": sorted({k[:160] for k, _, _ in hits})[:8]}
                        for name in counted for hits in [[e for e in device if name in e[0]]]}} if counted else {}),
        "post_s": time.perf_counter() - t1,
    }


def bf16_instance(kernel):
    """Whether a profiled flash kernel's name is a bf16 instance:
    `flash_fwd_bf16<64>`, `flash_bwd_dkv_bf16<64>` or `flash_bwd_dq_bf16<64>`
    (the fp32 ones are `flash_fwd<64>`, `flash_bwd_dkv<64>`, ...)."""
    return "_bf16<" in kernel


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


def profile_decode(torch, fn, what, expected):
    """One decode call `fn` under `profile_device`, held to `expected` twice:
    the wrappers' counts of this very call, then `check_decode_profile`.
    The CUDA-only profile once held 1,023 of a chunked `ar_generate`'s 1,024
    `prefix_attend` kernels in a run whose counts of the same call's twin
    were exact, and no merge kernel: a kernel record lost among the call's
    144k device events. So where the wrappers launched exactly `expected` and
    only the profile's count differs, the call is profiled once more with the
    host's operator events recorded too (the slower profile that held these
    counts in every earlier run), and that profile must hold them exactly.
    Returns the profile that passed; a first one that did not is kept in it
    under `first_counts`."""
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    reset_counts(fa, kv, pa)
    prof = profile_device(torch, fn, ported=PORTED_DECODE)
    check_launches(f"{what} (the profiled call)", all_counts(fa, kv, pa), expected)
    try:
        check_decode_profile(prof, what, expected)
        return prof
    except AssertionError as err:
        if any("merge" in name for name in prof["ported"]["prefix_attend"]["kernels"]):
            raise
        print(f"{err}; the wrappers launched {expected['prefix_attend']} and "
              f"{expected['write_kv_pair']}: profiling the call again with host events")
    first = {name: got["count"] for name, got in prof["ported"].items()}
    reset_counts(fa, kv, pa)
    prof = profile_device(torch, fn, ported=PORTED_DECODE, host_events=True)
    check_launches(f"{what} (profiled again)", all_counts(fa, kv, pa), expected)
    check_decode_profile(prof, f"{what} (profiled again with host events)", expected)
    prof["first_counts"] = first
    return prof


def tensor_core_counts(path, kernels, head_dims=(), instruction=TF32_HGMMA, forbidden=None):
    """The tensor-core instructions of one kind (`instruction`, the words of
    its SASS lines: TF32 HGMMA for the fp32 kernels, BF16 HGMMA for the bf16
    ones) in the SASS of the library at `path`, by kernel (a
    substring of its functions' names); fails when a function of one of
    them has none, or has any `forbidden` instruction (no TF32 HMMA in the
    `wgmma` kernels), or when a
    kernel has no instance at one of `head_dims` (the first template
    argument of its functions' mangled names, `ILi<d>E`). Returns the counts
    by kernel and by kernel and head dim."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    by_function, other, name = {}, collections.Counter(), None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            by_function[name] = 0
        elif name is not None and all(w in line for w in instruction):
            by_function[name] += 1
        elif name is not None and forbidden is not None and all(w in line for w in forbidden):
            other[name] += 1
    what = " ".join(reversed(instruction))
    counts, by_dim = {}, {}
    for kernel in kernels:
        functions = {f: n for f, n in by_function.items() if kernel in f}
        if not functions or not all(functions.values()):
            raise AssertionError(f"{kernel} in {path}: {what} instructions by function {functions}")
        if any(other[f] for f in functions):
            raise AssertionError(f"{kernel} in {path}: {' '.join(reversed(forbidden))} instructions by function "
                                 f"{ {f: other[f] for f in functions} }")
        counts[kernel] = sum(functions.values())
        dims = collections.Counter()
        for f, n in functions.items():
            m = re.search(re.escape(kernel) + r"\w*?ILi(\d+)E", f)
            if m is not None:
                dims[int(m.group(1))] += n
        by_dim[kernel] = dict(sorted(dims.items()))
        if any(d not in dims for d in head_dims):
            raise AssertionError(f"{kernel} in {path}: instances with {what} at head dims {by_dim[kernel]}, "
                                 f"expected {list(head_dims)}")
    return counts, by_dim


def check_performance(tokenizer, score_ids, perf, what, all_performed=True, max_left_out=MAX_LEFT_OUT):
    """A rendered performance has the score's pitches and finite, ordered
    note times. With `all_performed` every score note is played; without,
    the notes whose Velocity came out as the tokenizer's "not performed"
    token are left out, so the pitches need only be the score's, and at most
    `max_left_out` of the score's notes may be left out. Returns the number
    of score notes left out."""
    pitch_ids = np.asarray(score_ids)[:, tokenizer.types_idx["Pitch"]]
    src = collections.Counter((pitch_ids - tokenizer.zero_token + tokenizer.config.pitch_range[0]).tolist())
    notes = perf.all_notes()
    got = collections.Counter(notes.pitch.tolist())
    if (got != src) if all_performed else (got - src):
        raise AssertionError(f"{what}: {perf.num_notes} notes, pitches differ from the score's")
    if not (np.isfinite(notes.start).all() and np.isfinite(notes.end).all() and (notes.end >= notes.start).all()):
        raise AssertionError(f"{what}: note times are not finite and ordered")
    left_out = sum(src.values()) - perf.num_notes
    if left_out > max_left_out * sum(src.values()):
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

    with torch.inference_mode(), (cpu_ref() if dev == "cpu" else contextlib.nullcontext()):
        x = {k: torch.as_tensor(np.asarray(inputs[k])[None], dtype=torch.int64, device=dev)
             for k in ("deadpan_ids", "score_ids", "bars", "beats", "onsets", "tokens_in", "masked_all")}
        mask = torch.ones_like(x["bars"], dtype=torch.bool)
        score_emb, style_emb, _ = model.encode_embeddings(x["deadpan_ids"], mask, x["score_ids"], mask,
                                                          x["bars"], x["beats"], x["onsets"])
        return mixedlm_unmask(model, x["tokens_in"], x["masked_all"], style_embeddings=style_emb,
                              context=score_emb, greedy=True).cpu()


# ---- CPU references the worker computes (`CpuReferences`): arguments and
# results are paths, configs and numpy arrays ----


def cpu_greedy_from_checkpoint(params, inputs):
    """The CPU path's greedy tokens for one score's render `inputs` from the
    port checkpoint `params` (its params.pt or directory)."""
    import torch

    from scoreperformer_tpu_torch.inference import load_model_from_checkpoint

    model, _ = load_model_from_checkpoint(params, device="cpu")
    return greedy_tokens(torch, model, inputs, "cpu").numpy()


def cpu_greedy_from_config(cfg, inputs):
    """The CPU path's greedy tokens for one score's render `inputs` from a
    ScorePerformer of `cfg` with its weights made from SEED."""
    import torch

    from scoreperformer_tpu_torch.models.factory import build_scoreperformer

    model, _ = build_scoreperformer(cfg, device="cpu", seed=SEED)
    return greedy_tokens(torch, model.eval(), inputs, "cpu").numpy()


def cpu_scale_1024_references(ckpt, small, small_inputs):
    """scale_1024's CPU server (fp32 caches) on the four 4-bar requests
    `small`, with softmax_bf16 off and on, and the CPU path's greedy tokens
    of `small_inputs` (softmax_bf16 off)."""
    import torch

    from scoreperformer_tpu_torch.inference import RenderServer

    cpu = RenderServer(ckpt, bucket=64, chunk_size=CHUNK, cache_dtype="fp32", device="cpu")
    out = {}
    for flag in (False, True):
        set_attention(cpu.model, softmax_bf16=flag)
        out[flag] = [{k: r[k] for k in ("tokens", "padded_to")} for r in cpu.render_batch(small)]
    set_attention(cpu.model, softmax_bf16=False)
    out["greedy"] = greedy_tokens(torch, cpu.model, small_inputs, "cpu").numpy()
    return out


def cpu_stream_references(cfg, stream_root, gate_windows, gate_window, gate_ctx, softmax_bf16_off):
    """The CPU path's greedy streamed windows of `cfg`'s model (random weights
    from SEED) on the streaming piece at `stream_root`, and its encoder
    pass's context and embeddings."""
    from scoreperformer_tpu_torch.inference import ScorePerformerGenerator, SPMuple2Messenger
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer

    dataset, collator = streaming_dataset(stream_root, write=False)
    model, _ = build_scoreperformer(cfg, device="cpu", seed=SEED)
    if softmax_bf16_off:
        set_attention(model, softmax_bf16=False)
    gen = ScorePerformerGenerator(model, dataset, collator, SPMuple2Messenger(dataset.tokenizer))
    gen.reset()
    gen.prepare_performance_notes(0, overlay_bars=0.0)
    windows = stream(gen, gate_windows, gate_window, gate_ctx, greedy=True)
    return {"windows": [{k: w[k] for k in ("tokens", "window_start")} for w in windows],
            "context": np.asarray(gen.perf_data.context), "embeddings": np.asarray(gen.perf_data.embeddings)}


def cpu_moe_references(ckpt, score, requests, stream_root):
    """From the MoE checkpoint at `ckpt`, on the CPU: the 32-bar `score`'s
    greedy rendition (pitch, velocity, start, end), the greedy served batch
    of `requests` (tokens) and the greedy streamed windows (tokens)."""
    from scoreperformer_tpu_torch.inference import (
        RenderServer, ScorePerformerGenerator, SPMuple2Messenger, render_performance,
    )

    server = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cpu")
    notes = render_performance(server.model, server.tokenizer, score, seed=SEED, device="cpu",
                               greedy=True).all_notes()
    out = {"render": [notes.pitch, notes.velocity, notes.start, notes.end],
           "served": [r["tokens"] for r in server.render_batch(requests)]}
    dataset, collator = streaming_dataset(stream_root, write=False)
    gen = ScorePerformerGenerator(server.model, dataset, collator, SPMuple2Messenger(dataset.tokenizer))
    gen.reset()
    gen.prepare_performance_notes(0, overlay_bars=0.0)
    out["streaming"] = [w["tokens"] for w in stream(gen, STREAM_GATE_WINDOWS, STREAM_GATE_WINDOW, STREAM_GATE_CTX,
                                                    greedy=True)]
    return out


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


def smoke_phase(torch, tokenizer, work, scores, inputs, root):
    """recipes/smoke.yaml's model shape on the card, its decoder 2 heads of
    16 with one KV head (random weights, use_flash off as in the recipe):
    one greedy render of an 8-bar score, and a greedy served batch of the
    first SMOKE_REQUESTS `scores` (with their render `inputs`) through a
    `RenderServer` on a port checkpoint; each gives the port's CPU path's tokens and launches
    `prefix_attend` and `write_kv_pair` once per decoder layer and step.
    Then the same shape with `use_flash` (`smoke_flash`, on the train phase's
    dataset at `root`). Returns the phase's record."""
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
    models = {"cuda": load_model_from_checkpoint(ckpt, device="cuda")[0]}
    with cpu_ref():
        models["cpu"] = load_model_from_checkpoint(ckpt, device="cpu")[0]
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
    with cpu_ref():
        on_cpu = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cpu").render_batch(requests)
    same = all(np.array_equal(a["tokens"], b["tokens"]) for a, b in zip(out, on_cpu))
    rec["served"] = {"requests": len(requests), "wall_s": wall, "notes": sum(r["notes"] for r in out),
                     "notes_not_performed": left_out, "launches": launches, "identical_to_cpu": same}
    print("smoke-shaped served batch", json.dumps(rec["served"]))
    if not same:
        raise AssertionError("the smoke-shaped served batch's greedy tokens on the card differ from the CPU server's")
    rec["flash"] = smoke_flash(torch, tokenizer, root, os.path.join(work, "flash"))
    return rec


def smoke_flash(torch, tokenizer, root, work):
    """recipes/smoke.yaml's model with `use_flash` and no attention dropout
    (`smoke_flash_config`: the flash kernels at d = 16 in all three stacks,
    one layer each) on the card: SMOKE_TRAIN_STEPS steps at the recipe's
    batch of 4 and 48 notes a window (8 bars) through `ExperimentComponents`
    and the `Trainer` on the dataset at `root`, 3 launches of each kernel a
    step; a batch-4 step against the CPU's (dropout off); the trained
    weights as a port checkpoint rendering an 8-bar score (the encoders' 2
    flash forwards, then the chunked decode) with the CPU's greedy tokens;
    then the model held in bf16, 1 + 2 steps on the bf16 instances and a
    step against the plain flash functions on the card (options_phase's
    gates). Returns the record."""
    from scoreperformer_tpu_torch.inference import load_model_from_checkpoint, render_performance
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.training import ExperimentComponents, save_checkpoint

    shutil.rmtree(work, ignore_errors=True)
    layers = 3  # one attention layer a stack

    def components(dtype=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = train_config(tokenizer, root, os.path.join(work, "run"), SMOKE_TRAIN_BATCH, 2)
        cfg["data"]["dataset"].update(max_seq_len=SMOKE_TRAIN_SEQ, bar_sliding_window=SMOKE_WINDOW_BARS)
        cfg["model"] = {"_name_": "ScorePerformer", **smoke_flash_config(tokenizer, SMOKE_TRAIN_SEQ)}
        comp = ExperimentComponents(cfg, device="cuda").init_components()
        if dtype is not None:
            comp.model.to(dtype)
        comp.trainer._prepare()
        return comp

    comp = components()
    n_warmup, n_timed = SMOKE_TRAIN_STEPS
    step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, comp.trainer, comp.train_dataset,
                                                          n_warmup, n_timed, flash=layers)
    rec = {"train": {**train_record(torch, step_ms, notes, launches, SMOKE_TRAIN_BATCH, SMOKE_TRAIN_SEQ + 2),
                     "last_loss": values["loss"]}}
    host_batch = {k: v.cpu().numpy() for k, v in batch.items()}
    model_config = json.loads(json.dumps(comp.model_config))
    gate = compare_train_step(torch, dropout_off(model_config), host_batch)
    rec["train"]["card_vs_cpu"] = {k: gate[k] for k in ("loss_err", "grad_err", "worst", "gradients")}
    print("smoke-shaped train steps with use_flash", json.dumps(rec["train"]))
    if not (gate["loss_err"] <= 1e-4 and gate["grad_err"] <= 1e-3):
        raise AssertionError(f"the smoke-shaped flash step on the card differs from the CPU's: {gate}")

    # the trained weights render an 8-bar score (positions for its notes: no
    # parameter depends on them)
    score, score_inputs, _ = smoke_render_score(tokenizer)
    n_steps = -(-(len(score_inputs["deadpan_ids"]) - 1) // CHUNK) * CHUNK
    ckpt = save_checkpoint(os.path.join(work, "checkpoint"), comp.model,
                           model_config={"_name_": "ScorePerformer", **smoke_flash_config(tokenizer, SERVE_BUCKET)})
    tokenizer.save(os.path.join(ckpt, "tokenizer.json"))
    del comp, batch
    models = {"cuda": load_model_from_checkpoint(ckpt, device="cuda")[0]}
    with cpu_ref():
        models["cpu"] = load_model_from_checkpoint(ckpt, device="cpu")[0]
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perf = render_performance(models["cuda"], tokenizer, score, seed=SEED, device="cuda", greedy=True)
    torch.cuda.synchronize()
    rec["render"] = {"bars": 8, "notes": perf.num_notes, "wall_s": time.perf_counter() - t0,
                     "launches": all_counts(fa, kv, pa),
                     "notes_not_performed": check_performance(tokenizer, score_inputs["score_ids"], perf,
                                                              "smoke-shaped flash render", all_performed=False)}
    check_launches("the smoke-shaped flash render", rec["render"]["launches"], decode_launches(n_steps, 1, 2))
    rec["render"]["identical_to_cpu"] = torch.equal(*(greedy_tokens(torch, m, score_inputs, dev)
                                                      for dev, m in models.items()))
    print("smoke-shaped render with use_flash", json.dumps(rec["render"]))
    if not rec["render"]["identical_to_cpu"]:
        raise AssertionError("the smoke-shaped flash render's greedy tokens on the card differ from the CPU path's")
    del models

    # the model held in bf16: the bf16 instances at d = 16
    comp = components(torch.bfloat16)
    step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, comp.trainer, comp.train_dataset, 1, 2,
                                                          dtype="bf16", flash=layers)
    rec["bf16_model"] = {**train_record(torch, step_ms, notes, launches, SMOKE_TRAIN_BATCH, SMOKE_TRAIN_SEQ + 2),
                         "last_loss": values["loss"]}
    # one more step profiled: the backward kernels' share of the device time
    prof = profile_device(torch, lambda: comp.trainer.train_step(batch, 3), ported=PORTED_TRAIN)
    if {k: prof["ported"][k]["count"] for k in PORTED_TRAIN} != {k: layers for k in PORTED_TRAIN}:
        raise AssertionError(f"the profiled bf16 smoke-shaped step ran the flash kernels {prof['ported']}")
    rec["bf16_model"]["profile"] = prof
    del comp, batch
    gate = compare_train_step(torch, dropout_off(model_config), host_batch, devices=("cuda", "cuda"),
                              precision="bf16", reference_plain_flash=True)
    rec["bf16_model"]["kernels_vs_plain_on_card"] = {k: gate[k] for k in ("loss_rel", "global_rel_l2", "worst")}
    print("smoke-shaped model held in bf16 with use_flash", json.dumps(rec["bf16_model"]))
    if not (gate["loss_rel"] <= 1e-2 and gate["global_rel_l2"] <= 5e-2):
        raise AssertionError(f"the bf16 smoke-shaped step's kernels differ from the plain flash functions: {gate}")
    return rec


def set_attention(model, **flags):
    """Set flags (softmax_bf16, use_flash) on every attention layer; the
    weights stay."""
    from scoreperformer_tpu_torch.models.attention import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            for name, value in flags.items():
                setattr(m, name, value)


def scale_1024_phase(torch, tokenizer, work, scores, inputs, refs):
    """recipes/scoreperformer/scale_1024.yaml's model at full width on the
    card (random weights from SEED), with `use_flash` in every stack
    (`scale_flash_config` with the recipe's dropout: the encoders' 10 layers
    take the flash forward at inference, the decoder decodes from its
    caches), through a `RenderServer` on a port checkpoint: the first
    SCALE_REQUESTS `scores` served greedy through
    `handle_batch` with the `auto` caches (int8 at dim 1024), every response
    ok; the share of tokens on which int8 agrees with fp32 caches (not
    gated); a profiled int8 batch; then four 4-bar requests through the
    card's server and the CPU's with fp32 caches, with softmax_bf16 off
    (gated: identical tokens) and on (the share of equal tokens: bf16
    rounds differently on the two devices); then one greedy
    `render_performance` of an 8-bar score and a 4-bar score's greedy tokens
    against the CPU path's (softmax_bf16 off). The CPU side runs in `refs`'
    worker from the checkpoint while the card works; its gates run at the
    phase's end. Returns the phase's record."""
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import RenderServer, prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.midi import read_midi, write_midi
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):  # host seconds of each step of the phase
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    cfg = scale_flash_config(tokenizer, dropout=0.1)
    layers = cfg["perf_decoder"]["transformer"]["depth"]
    encoder_layers = sum(cfg[key]["transformer"]["depth"] for key in ("score_encoder", "perf_encoder"))
    ckpt = save_port_checkpoint(tokenizer, cfg, work)
    small = [dict(score_midi=synthetic_score(np.random.RandomState(1000 + i), n_bars=4), greedy=True)
             for i in range(4)]
    small_inputs = prepare_render_inputs(tokenizer, small[0]["score_midi"])
    cpu_job = refs.submit(cpu_scale_1024_references, ckpt, small, small_inputs)
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
    expected = decode_launches(-(-(SERVE_BUCKET - 1) // CHUNK) * CHUNK, layers, encoder_layers)
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
    rec["profile"] = profile_decode(torch, lambda: box.update(int8=server.render_batch(requests)),
                                    "the scale_1024 served batch's profile", expected)
    print("profile scale_1024 served int8 batch", json.dumps(rec["profile"]))
    got = rec["profile"]["ported"]["prefix_attend"]
    print(f"scale_1024 served int8 batch: prefix_attend {got['ms']:.1f} device ms over {got['count']} launches "
          f"(the row-walking kernel this one replaced: 121.2 ms over 3,072 on an H100 at 700 W)")
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

    on_card = {}
    for flag in (False, True):
        set_attention(card.model, softmax_bf16=flag)
        t0 = time.perf_counter()
        on_card[flag] = card.render_batch(small)
        rec[f"card_render_s_softmax_bf16={flag}"] = time.perf_counter() - t0
    lap("card_renders")
    rec["launches"] = expected

    # the flash render: render_performance on the card, launches and notes;
    # greedy tokens of a 4-bar score against the CPU's, softmax_bf16 off
    score, score_inputs, _ = smoke_render_score(tokenizer)
    n_steps = -(-(len(score_inputs["deadpan_ids"]) - 1) // CHUNK) * CHUNK
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perf = render_performance(card.model, tokenizer, score, seed=SEED, device="cuda", greedy=True)
    torch.cuda.synchronize()
    rec["render"] = {"bars": 8, "notes": perf.num_notes, "wall_s": time.perf_counter() - t0,
                     "launches": all_counts(fa, kv, pa),
                     "notes_not_performed": check_performance(tokenizer, score_inputs["score_ids"], perf,
                                                              "scale_1024 flash render", all_performed=False)}
    check_launches("the scale_1024 flash render", rec["render"]["launches"],
                   decode_launches(n_steps, layers, encoder_layers))
    set_attention(card.model, softmax_bf16=False)
    card_greedy = greedy_tokens(torch, card.model, small_inputs, "cuda")
    print("scale_1024 render with use_flash", json.dumps(rec["render"]))
    lap("render")

    # the CPU server's and the CPU path's tokens, from the worker
    cpu = refs.result(cpu_job)
    rec["card_vs_cpu"] = {
        f"softmax_bf16={flag}": {
            "identical_requests": sum(np.array_equal(a["tokens"], b["tokens"])
                                      for a, b in zip(on_card[flag], cpu[flag])),
            "token_agreement": token_agreement(on_card[flag], cpu[flag], list(card.sample_dims)),
            "padded_to": cpu[flag][0]["padded_to"]} for flag in (False, True)}
    print("scale_1024, four 4-bar requests, card vs CPU server (fp32 caches)", json.dumps(rec["card_vs_cpu"]))
    if rec["card_vs_cpu"]["softmax_bf16=False"]["identical_requests"] != len(small):
        raise AssertionError("the scale_1024 model's greedy tokens on the card differ from the CPU server's")
    rec["render"]["identical_to_cpu"] = torch.equal(card_greedy, torch.as_tensor(cpu["greedy"]))
    print(f"scale_1024 4-bar greedy tokens, card vs CPU path: identical={rec['render']['identical_to_cpu']}")
    if not rec["render"]["identical_to_cpu"]:
        raise AssertionError("the scale_1024 flash render's greedy tokens on the card differ from the CPU path's")
    lap("card_vs_cpu")
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
    with cpu_ref():
        on_cpu = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cpu").render_batch(small)
    same = all(np.array_equal(a["tokens"], b["tokens"]) for a, b in zip(on_card, on_cpu))
    print(f"served batch of four 4-bar requests, card vs CPU server: identical tokens={same}")
    if not same:
        raise AssertionError("the card's server gives other greedy tokens than the CPU's")

    # 6. where a served batch's time goes
    requests = [dict(score_midi=sc, greedy=True) for sc in scores]
    rec["profile"] = profile_decode(torch, lambda: server.render_batch(requests),
                                    "the served batch's profile", expected)
    print("profile served greedy batch", json.dumps(rec["profile"]))
    rec["launches"] = expected
    return rec


def streaming_dataset(work, write=True):
    """scripts/exp_streaming_slo.py's piece: one synthetic score of
    STREAM_BARS bars with one performance (seed 7), in a dataset of
    STREAM_SEQ-note windows, and its collator; the piece written to `work`
    first unless `write` is false (the CPU reference worker reads it)."""
    from scoreperformer_tpu_torch.data import (
        LocalScorePerformanceDataset, MixedLMScorePerformanceCollator, build_synthetic_dataset,
    )

    if write:
        shutil.rmtree(work, ignore_errors=True)
        build_synthetic_dataset(work, n_scores=1, n_perfs_per_score=1, n_bars=STREAM_BARS, seed=7,
                                with_directions=False)
    dataset = LocalScorePerformanceDataset(root=work, max_seq_len=STREAM_SEQ, bar_sliding_window=8,
                                           fit_to_zero_bar=True, add_sos_eos=True, preload=True,
                                           auxiliary_data_keys=["bars"])
    return dataset, MixedLMScorePerformanceCollator(mask_ignore_token_ids=COLLATOR["mask_ignore_token_ids"],
                                                    mask_ignore_token_dims=COLLATOR["mask_ignore_token_dims"])


def stream(gen, n_windows, window, ctx, seeds=None, **kw):
    """`n_windows` windows of `generate_performance_notes` from the piece's
    start (prepared already): each window's tokens, host wall seconds and
    the decoder's window start after it. Window w samples from seed SEED + w,
    or every window from `seeds` when it is given."""
    import torch

    out, clock = [], 0.0
    for w in range(n_windows):
        seed = SEED + w if seeds is None else seeds
        t0 = time.perf_counter()
        tokens, _ = gen.generate_performance_notes(start_time=clock, time_window=window,
                                                   time_window_overflow=STREAM_OVERFLOW, max_context_len=ctx,
                                                   seed=seed, **kw)
        if gen.device.type == "cuda":
            torch.cuda.synchronize()
        out.append({"tokens": tokens, "wall_s": time.perf_counter() - t0, "window_start": gen._last_window_start})
        clock += window
        if gen.perf_data.reached_eos:
            break
    return out


def check_stream_vocab(gen, windows, what):
    """Every generated id lies inside its stream's vocabulary, and no MASK is left."""
    sizes = np.asarray(list(gen.model.config.num_tokens.values()))
    for w, rec in enumerate(windows):
        tokens = rec["tokens"]
        if tokens is not None and ((tokens < 0).any() or (tokens >= sizes).any() or (tokens == 1).any()):
            raise AssertionError(f"{what}, window {w}: ids outside their streams' vocabularies or MASK left")


def same_stream_tokens(a, b):
    return len(a) == len(b) and all(
        (x["tokens"] is None and y["tokens"] is None)
        or (x["tokens"] is not None and y["tokens"] is not None and np.array_equal(x["tokens"], y["tokens"]))
        for x, y in zip(a, b))


def streaming_phase(torch, dataset, collator, cfg, label, n_windows, gate_windows, gate_ctx, gate_window,
                    flash_per_chunk, smi, refs, stream_root, gate_softmax_bf16_off=False, sampled_parity=False):
    """The streaming generator on the card, exp_streaming_slo.py's regime:
    the piece prepared (the encoder pass, counted in chunks), `warmup`, then
    `n_windows` windows of STREAM_WINDOW s (STREAM_OVERFLOW s overflow) with
    top-k sampling at temperature 1.0, a seed a window, in a
    STREAM_CTX-row cache: wall times after STREAM_WARMUP windows, notes a
    window, SLO misses, the decoder's counters; the kernel launches of the
    whole run against what the counters predict (one `write_kv_pair` a
    decoder layer a consume call and a decode step, `flash_per_chunk` flash
    forwards an encoder chunk); one more window profiled. Gates: every id
    in its stream's vocabulary;
    `gate_windows` greedy windows (of `gate_window` s over a `gate_ctx`-row
    cache) on the card equal to the port's CPU path on the same weights,
    with softmax_bf16 off on both when `gate_softmax_bf16_off`; with
    `sampled_parity`, one seed samples the same tokens through blocks of 16
    as through the per-note path (the same blocks, each refused by
    `decode_block`) over twice `gate_windows` windows. The CPU path's
    windows come from `refs`' worker, on the piece at `stream_root`; their
    gate runs in `refs.check_all`. Returns the phase's record."""
    from unittest import mock

    from scoreperformer_tpu_torch.inference import ScorePerformerGenerator, SPMuple2Messenger, StreamingDecoder
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):  # host seconds of each step of the phase
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    def generator(device):
        model, _ = build_scoreperformer(cfg, device=device, seed=SEED)
        return ScorePerformerGenerator(model, dataset, collator, SPMuple2Messenger(dataset.tokenizer))

    cpu_job = refs.submit(cpu_stream_references, cfg, stream_root, gate_windows, gate_window, gate_ctx,
                          gate_softmax_bf16_off)
    gen = generator("cuda")
    layers = cfg["perf_decoder"]["transformer"]["depth"]
    chunks = []  # (t, valid keys) of each encoder pass
    encode = gen.model.encode_embeddings

    def counted_encode(perf, perf_mask, *args):
        chunks.append((int(perf.shape[1]), int(perf_mask.sum())))
        return encode(perf, perf_mask, *args)

    gen.model.encode_embeddings = counted_encode
    rec = {"regime": label, "card": smi, "parameters": sum(p.numel() for p in gen.model.parameters()),
           "notes": int(len(dataset.performances[0])), "windows": n_windows, "warmup_windows": STREAM_WARMUP,
           "window_s": STREAM_WINDOW, "overflow_s": STREAM_OVERFLOW, "max_context_len": STREAM_CTX,
           "phase_s": phase_s}
    lap("build")
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen.prepare_performance_notes(0, overlay_bars=0.0)
    torch.cuda.synchronize()
    rec["prepare_s"] = time.perf_counter() - t0
    rec["encoder_chunks"] = [list(c) for c in chunks]
    t0 = time.perf_counter()
    gen.warmup(max_context_len=STREAM_CTX, greedy=False, temperature=1.0)
    torch.cuda.synchronize()
    rec["warmup_s"] = time.perf_counter() - t0
    lap("prepare_and_warmup")
    windows = stream(gen, n_windows, STREAM_WINDOW, STREAM_CTX, greedy=False, temperature=1.0)
    launches = all_counts(fa, kv, pa)
    stats = dict(gen._decoder.stats)
    lap("windows")
    check_stream_vocab(gen, windows, f"{label} streaming")
    steady = np.asarray([w["wall_s"] for w in windows[STREAM_WARMUP:]]) * 1e3
    notes = np.asarray([0 if w["tokens"] is None else len(w["tokens"]) for w in windows[STREAM_WARMUP:]])
    rec.update({
        "window_ms": {"median": float(np.median(steady)), "p95": float(np.percentile(steady, 95)),
                      "max": float(steady.max()), "all": [round(w["wall_s"] * 1e3, 3) for w in windows]},
        "notes_per_window": {"mean": float(notes.mean()), "max": int(notes.max()), "total": int(notes.sum())},
        "slo_misses": int((steady > STREAM_WINDOW * 1e3).sum()), "measured_windows": int(len(steady)),
        "window_starts": sorted({w["window_start"] for w in windows}), "decoder_stats": stats,
    })
    expected = {k: 0 for k in launches}
    expected["write_kv_pair"] = layers * (stats["consume_calls"] + stats["block_steps"])
    expected["flash_attention_fwd"] = flash_per_chunk * len(chunks)
    rec["launches"] = launches
    check_launches(f"the {label} streaming run", launches, expected)
    print(f"{label} streaming ({smi})", json.dumps({k: v for k, v in rec.items() if k != "window_ms"}))
    print(f"{label} streaming window wall ms ({smi}): median {rec['window_ms']['median']:.3f}, "
          f"p95 {rec['window_ms']['p95']:.3f}, max {rec['window_ms']['max']:.3f}; "
          f"{rec['slo_misses']} of {len(steady)} windows over {STREAM_WINDOW} s")

    # where a window's time goes: the next window under the profiler, with
    # its decode steps and consume calls from the decoder's counters
    before = dict(gen._decoder.stats)
    rec["profile"] = profile_device(torch, lambda: gen.generate_performance_notes(
        start_time=n_windows * STREAM_WINDOW, time_window=STREAM_WINDOW, time_window_overflow=STREAM_OVERFLOW,
        max_context_len=STREAM_CTX, seed=SEED + n_windows, greedy=False, temperature=1.0),
        ported=("write_rows", "flash_fwd"))
    rec["profile"]["decode_steps"] = gen._decoder.stats["block_steps"] - before["block_steps"]
    rec["profile"]["consume_calls"] = gen._decoder.stats["consume_calls"] - before["consume_calls"]
    lap("profiled_window")
    print(f"profile {label} streaming window", json.dumps(rec["profile"]))

    if sampled_parity:
        # one seed for every window: the same blocks, decoded as blocks or,
        # each block refused, note by note
        def sampled_run():
            gen.reset()
            gen.prepare_performance_notes(0, overlay_bars=0.0)
            return stream(gen, 2 * gate_windows, gate_window, STREAM_CTX, seeds=SEED, greedy=False, block_size=16)

        block = sampled_run()

        def refuse(self, *args, **kwargs):
            self.stats["block_refusals"] += 1

        with mock.patch.object(StreamingDecoder, "decode_block", refuse):
            per_note = sampled_run()
        check_stream_vocab(gen, block + per_note, f"{label} sampled parity")
        rec["sampled_block_vs_per_note"] = {
            "identical": same_stream_tokens(block, per_note),
            "notes": sum(0 if w["tokens"] is None else len(w["tokens"]) for w in block)}
        lap("sampled_parity")
        print(f"{label} sampled tokens, blocks of 16 vs the per-note path, one seed:",
              json.dumps(rec["sampled_block_vs_per_note"]))
        if not rec["sampled_block_vs_per_note"]["identical"]:
            raise AssertionError(f"{label}: sampled tokens through blocks differ from the per-note path's")

    # greedy windows, the card against the port's CPU path on the same
    # weights (the worker's, `cpu_stream_references`)
    if gate_softmax_bf16_off:
        set_attention(gen.model, softmax_bf16=False)
    gen.reset()
    gen.prepare_performance_notes(0, overlay_bars=0.0)
    card = stream(gen, gate_windows, gate_window, gate_ctx, greedy=True)
    check_stream_vocab(gen, card, f"{label} greedy gate")
    context, embeddings = np.asarray(gen.perf_data.context), np.asarray(gen.perf_data.embeddings)
    rec["greedy_card_vs_cpu"] = {
        "windows": len(card), "window_s": gate_window, "max_context_len": gate_ctx,
        "notes": sum(0 if w["tokens"] is None else len(w["tokens"]) for w in card),
        "window_starts": sorted({w["window_start"] for w in card}), "softmax_bf16_off": gate_softmax_bf16_off}
    lap("greedy_card")
    if gate_windows >= 12 and max(rec["greedy_card_vs_cpu"]["window_starts"]) == 0:
        raise AssertionError(f"{label}: the greedy gate's windows never shifted the context window")

    def gate(cpu):
        emb_err = max(float(np.abs(a - b).max()) for a, b in ((context, cpu["context"]),
                                                                (embeddings, cpu["embeddings"])))
        rec["greedy_card_vs_cpu"].update(identical=same_stream_tokens(card, cpu["windows"]),
                                         embeddings_max_abs_err=emb_err)
        print(f"{label} greedy windows, card vs CPU:", json.dumps(rec["greedy_card_vs_cpu"]))
        if not rec["greedy_card_vs_cpu"]["identical"]:
            raise AssertionError(f"{label}: the card's greedy streaming tokens differ from the CPU path's")
        if not emb_err <= 1e-3:
            raise AssertionError(f"{label}: the encoder pass differs between the card and the CPU by {emb_err}")

    refs.later(f"{label} greedy streamed windows against the CPU path's", cpu_job, gate)
    del gen
    torch.cuda.empty_cache()
    return rec


# the Performer family: recipes/performer.yaml resolved over recipes/default.yaml
# (its data, collator, model and evaluator nodes), written out because the
# card's machine may have no PyYAML; tests/test_torch_recipes.py holds them to
# the recipe
PERFORMER_DATASET = dict(
    _name_="PerformanceDataset", root="???", max_seq_len=256, max_bar=256, bar_sliding_window=16,
    fit_to_zero_bar=True, add_sos_eos=True, sample=True, seed=23, augment_performance=True,
    pitch_shift_range=[-3, 3], velocity_shift_range=[-12, 12], tempo_shift_range=[0, 0],
)
PERFORMER_COLLATOR = dict(_name_="LMPerformanceCollator")
PERFORMER_MODEL = {
    "_name_": "Performer", "_version_": "v0.1.0", "mode": "clm",
    "transformer": {
        "dim": 256, "max_seq_len": 258,
        "token_embeddings": {"_target_": "simple", "emb_dims": 128, "mode": "cat", "emb_norm": True,
                             "discrete": False, "continuous": True, "continuous_dense": True,
                             "discrete_ids": [0, 1, 2, 3]},
        "emb_norm": True, "use_abs_pos_emb": False,
        "transformer": {"_target_": "decoder", "depth": 4, "heads": 4,
                        "attention": {"dim_head": 64, "one_kv_head": True, "dropout": 0.1, "alibi_pos_bias": True,
                                      "alibi_learned": True},
                        "feed_forward": {"mult": 4, "glu": True, "swish": True, "dropout": 0.1}},
        "lm_head": {"_target_": "lm-tied"},
    },
}
PERFORMER_EVALUATOR = dict(_name_="ScorePerformerEvaluator", weighted_distance=True)
# ar_generate from the trained weights: (a) chunked, 16 prompts of 4 notes
# continued to 256 (253 steps, padded to 256), top-k 0.9 at T = 1; (b) the
# ring, one prompt continued to 400 past the 258-row window; (c) greedy
# tokens against the CPU's on 48 steps, the ring at a 32-row window so that
# it wraps; (d) one top-p and one top-a run of 60 steps, each draw inside the
# filter's support. mlm_unmask: 4 sequences of 64 notes with 12 positions
# masked in 4 streams, an mlm Performer at the recipe's widths
GEN_BATCH, GEN_T0, GEN_SEQ, RING_SEQ, GREEDY_STEPS, GREEDY_RING_WINDOW, FILTER_STEPS = 16, 4, 256, 400, 48, 32, 60
MLM_BATCH, MLM_SEQ, MLM_MASKED = 4, 64, 12


def performer_config(root, out_dir, batch_size, max_steps, use_flash=False):
    """The experiment config of the Performer phase: recipes/performer.yaml's
    nodes on the dataset at `root`, the trainer's run settings as
    `train_config`'s; with `use_flash`, the flash kernels and no attention
    dropout (the kernels have none: with it, the JAX module and the port both
    take the plain path while training)."""
    model = json.loads(json.dumps(PERFORMER_MODEL))
    if use_flash:
        model["transformer"]["transformer"]["attention"].update(use_flash=True, dropout=0.0)
    return {
        "data": {"dataset": {**PERFORMER_DATASET, "root": root}, "collator": dict(PERFORMER_COLLATOR)},
        "model": model, "evaluator": dict(PERFORMER_EVALUATOR),
        "trainer": {"output_dir": out_dir, "seed": 23, "batch_size": batch_size, "eval_batch_size": batch_size,
                    "epochs": 500, "max_steps": max_steps, "log_steps": 5, "eval_strategy": "no",
                    "save_strategy": "no", "disable_progress": True, "num_workers": 4,
                    "optimization": dict(OPTIMIZATION)},
    }


def ar_launches(t0, steps, chunk=None, layers=DECODER_LAYERS):
    """The launches of one `ar_generate`: one `write_kv_pair` a decoder layer
    for the prefill (prompts of 2 or more) and one a layer and step, the
    steps padded to a multiple of C on the chunked path, where every padded
    step also runs one `prefix_attend` a layer; none on the ring."""
    padded = steps if chunk is None else -(-steps // chunk) * chunk
    return {"write_kv": 0, "write_kv_pair": layers * ((t0 > 1) + padded),
            "prefix_attend": 0 if chunk is None else layers * padded,
            **{f"{name}{suffix}": 0 for name in FLASH for suffix in ("", "_bf16", "_one_pass")}}


def recording(fn, calls):
    """`fn`, recording each call's input and output logits in `calls`."""
    def filter_fn(logits, **kw):
        out = fn(logits, **kw)
        calls.append((logits.clone(), out.clone()))
        return out
    return filter_fn


def check_filtered_support(gen, num, calls, fn, kwargs, sizes, what):
    """Every id of the rows' live steps (before EOS) lies in its stream's
    vocabulary and in the support of the filter that ar_generate applied to
    that step's logits, recomputed here with the plain filter on the
    recorded input (ar_generate filters stream by stream: call k is step
    k // S, stream k % S). Returns the number of draws checked."""
    import torch

    S = len(sizes)
    gen, num = gen.cpu(), num.cpu()
    if not ((gen >= 0) & (gen < torch.as_tensor(sizes))).all():
        raise AssertionError(f"{what}: ids outside their streams' vocabularies")
    checked = 0
    for k, (logits, filtered) in enumerate(calls):
        step, s = divmod(k, S)
        again = fn(logits, **kwargs)
        if not (again.isneginf() == filtered.isneginf()).all():
            raise AssertionError(f"{what}: the filter recomputed at step {step}, stream {s} keeps another set")
        for row in range(gen.shape[0]):
            n = int(num[row])
            if step >= gen.shape[1] or step >= n or (step == n - 1 and gen[row, step, 0] == 3):
                continue  # padded tail, after the stop, or the EOS row
            if not filtered[row, int(gen[row, step, s])].isfinite():
                raise AssertionError(f"{what}: step {step}, stream {s}, row {row} drew id "
                                     f"{int(gen[row, step, s])} outside the filter's support")
            checked += 1
    return checked


def performer_phase(torch, smi):
    """The standalone Performer on the card, on the train phase's dataset:
    1. recipes/performer.yaml through `ExperimentComponents` and the
       `Trainer` (PerformanceDataset windows of 256 notes with SOS/EOS,
       LMPerformanceCollator, batch 128 x 258): 2 + 8 steps, one profiled;
       again with use_flash (no attention dropout), 4 launches of each fp32
       flash kernel a step;
    2. a batch-4 step on the card against the CPU's (dropout off), with and
       without the flash kernels;
    3. `ar_generate` from the trained weights: chunked (16 prompts from the
       dataset's windows, 253 steps, top-k), the ring (one prompt past the
       258-row window), each with its launches; one chunked generation
       profiled; greedy tokens against the CPU's on 48 steps at both paths;
       a top-p and a top-a run, every draw inside its filter's support;
    4. `mlm_unmask` with an mlm Performer (encoder, untied head, the
       recipe's widths, flash forward, random weights): single-run and
       iterative greedy tokens against the CPU's;
    5. the kernels against their plain versions at the shapes of these
       paths.
    Returns the phase's record."""
    from scoreperformer_tpu_torch.models.factory import build_performer
    from scoreperformer_tpu_torch.models.wrappers import ar_generate, mlm_unmask
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.ops import sampling
    from scoreperformer_tpu_torch.training import ExperimentComponents

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    root, work = os.path.join(build, "chip_smoke_train", "data"), os.path.join(build, "chip_smoke_performer")
    shutil.rmtree(work, ignore_errors=True)
    rec = {"card": smi, "phase_s": phase_s}

    # ---- 1. train performer.yaml, then with the flash kernels ----
    runs = {}
    for label, use_flash in (("plain", False), ("flash", True)):
        comp = ExperimentComponents(performer_config(root, os.path.join(work, label), TRAIN_BATCH, 2, use_flash),
                                    device="cuda").init_components()
        trainer = comp.trainer
        trainer._prepare()
        torch.cuda.reset_peak_memory_stats()
        step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset,
                                                              TRAIN_WARMUP, TRAIN_TIMED, flash=4 if use_flash else 0)
        run = train_record(torch, step_ms, notes, launches)
        run.update(windows=len(comp.train_dataset), parameters=sum(p.numel() for p in comp.model.parameters()),
                   last_loss=values["loss"])
        prof = profile_device(torch, lambda: trainer.train_step(batch, TRAIN_WARMUP + TRAIN_TIMED),
                              ported=PORTED_TRAIN)
        run["profile"] = {k: v for k, v in prof.items() if k != "top"}
        counts = {name: prof["ported"][name]["count"] for name in PORTED_TRAIN}
        if counts != {name: 4 if use_flash else 0 for name in PORTED_TRAIN}:
            raise AssertionError(f"the profiled Performer step ({label}) ran the flash kernels {counts} times")
        print(f"performer train steps ({label})", json.dumps(run))
        runs[label] = run
        host_batch = next(trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0))
        if use_flash:
            lengths = host_batch["mask"][:, :-1].sum(1).tolist()  # the decoder's keys after the CLM shift
        else:
            model, dataset, model_config = comp.model, comp.train_dataset, comp.model_config
            stream_names = list(dataset.tokenizer.types_idx)
            del trainer
        lap(f"train_{label}")
    rec["train"] = runs
    del comp, trainer, batch
    torch.cuda.empty_cache()

    # ---- 2. a batch-4 step on the card against the CPU's ----
    rec["card_vs_cpu"] = {}
    for label, use_flash in (("plain", False), ("flash", True)):
        cfg = performer_config(root, "", TRAIN_BATCH, 2, use_flash)["model"]
        for key in ("attention", "feed_forward"):  # dropout off: the two sides draw other masks
            cfg["transformer"]["transformer"][key]["dropout"] = 0.0
        cfg = {**model_config, "transformer": {**model_config["transformer"],
                                               "transformer": cfg["transformer"]["transformer"]}}
        gate = compare_train_step(torch, cfg, host_batch)
        rec["card_vs_cpu"][label] = {k: gate[k] for k in ("loss_err", "grad_err", "gradients")}
        print(f"performer train step at batch 4 ({label}), card vs CPU: {json.dumps(rec['card_vs_cpu'][label])}")
        if not (gate["loss_err"] <= 1e-4 and gate["grad_err"] <= 1e-3):
            raise AssertionError(f"the Performer's step on the card ({label}) differs from the CPU's: {gate}")
    lap("card_vs_cpu")

    # ---- 3. ar_generate from the trained weights ----
    model.eval()
    prompts = torch.as_tensor(np.asarray(host_batch["perf"])[:GEN_BATCH, :GEN_T0], dtype=torch.int64,
                              device="cuda")
    sizes = list(model.config.num_tokens.values())
    gens = {}
    for label, b, seq_len, kw in (("chunked", GEN_BATCH, GEN_SEQ, {"filter_kwargs": {"thres": 0.9}}),
                                  ("ring", 1, RING_SEQ, {"filter_kwargs": {"thres": 0.9}})):
        steps = seq_len + 1 - GEN_T0
        chunk = CHUNK if label == "chunked" else None
        for attempt in ("warm", "timed"):
            reset_counts(fa, kv, pa)
            g = torch.Generator(device="cuda").manual_seed(SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen, num = ar_generate(model, prompts[:b], seq_len, g, stream_names=stream_names, **kw)
            t_host = time.perf_counter() - t0
            gen, num = gen.cpu(), num.cpu()
            wall = time.perf_counter() - t0
            launches = all_counts(fa, kv, pa)
        check_launches(f"ar_generate ({label})", launches, ar_launches(GEN_T0, steps, chunk))
        if not ((gen >= 0) & (gen < torch.as_tensor(sizes)) & (gen != 1)).all():
            raise AssertionError(f"ar_generate ({label}): ids outside their vocabularies, or MASK")
        if label == "ring" and seq_len + 1 <= model.config.transformer.max_seq_len:
            raise AssertionError("the ring generation does not pass the window")
        gens[label] = {"batch": b, "steps": steps, "padded_steps": steps if chunk is None else -(-steps // chunk) * chunk,
                       "wall_ms": wall * 1e3, "steps_per_s": steps / wall, "host_ms_per_step": t_host * 1e3 / steps,
                       "wall_ms_per_step": wall * 1e3 / steps, "num_generated": num.tolist(), "launches": launches}
        print(f"performer ar_generate ({label})", json.dumps(gens[label]))
    prof = profile_decode(torch, lambda: ar_generate(model, prompts, GEN_SEQ, torch.Generator(device="cuda").manual_seed(SEED),
                                                     stream_names=stream_names, filter_kwargs={"thres": 0.9}),
                          "the chunked ar_generate's profile", ar_launches(GEN_T0, GEN_SEQ + 1 - GEN_T0, CHUNK))
    gens["chunked"]["profile"] = {k: v for k, v in prof.items() if k != "top"}
    print("profile performer ar_generate (chunked)", json.dumps(prof))
    lap("ar_generate")

    # (c) greedy: the card's tokens against the CPU's, chunked and ring (a 32-row window, so that it wraps)
    with cpu_ref():
        cpu_model, _ = build_performer({k: v for k, v in model_config.items() if not k.startswith("_")},
                                       device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu_model.eval()
    greedy = {}
    for label, b, kw in (("chunked", GEN_BATCH, {}), ("ring", 4, {"max_seq_len": GREEDY_RING_WINDOW})):
        seq_len = GEN_T0 - 1 + GREEDY_STEPS
        out = [ar_generate(model, prompts[:b], seq_len, greedy=True, stream_names=stream_names, **kw)]
        with cpu_ref():
            out.append(ar_generate(cpu_model, prompts[:b].cpu(), seq_len, greedy=True, stream_names=stream_names,
                                   **kw))
        same = torch.equal(out[0][0].cpu(), out[1][0]) and torch.equal(out[0][1].cpu(), out[1][1])
        greedy[label] = {"batch": b, "steps": GREEDY_STEPS, "identical": same, "num_generated": out[0][1].tolist()}
        print(f"performer greedy ar_generate ({label}), card vs CPU", json.dumps(greedy[label]))
        if not same:
            raise AssertionError(f"greedy ar_generate ({label}) on the card differs from the CPU's")
    rec["greedy_card_vs_cpu"] = greedy
    # (d) top-p and top-a: every draw inside its filter's support
    filters = {}
    for name, kwargs in (("top_p", {"thres": 0.9}), ("top_a", {})):
        fn, calls = getattr(sampling, name), []
        gen, num = ar_generate(model, prompts, GEN_T0 - 1 + FILTER_STEPS, torch.Generator(device="cuda").manual_seed(SEED),
                               filter_fn=recording(fn, calls), filter_kwargs=kwargs, stream_names=stream_names,
                               fix_errors=False)
        checked = check_filtered_support(gen, num, calls, fn, kwargs, sizes, f"ar_generate with {name}")
        filters[name] = {"draws_checked": checked, "num_generated": num.tolist()}
        print(f"performer ar_generate with {name}", json.dumps(filters[name]))
    gens["filters"] = filters
    rec["ar_generate"] = gens
    del cpu_model, calls
    lap("ar_generate_checks")

    # ---- 4. mlm_unmask: an mlm Performer at the recipe's widths ----
    mlm_cfg = json.loads(json.dumps({k: v for k, v in model_config.items() if not k.startswith("_")}))
    mlm_cfg["mode"] = "mlm"
    mlm_cfg["transformer"]["transformer"]["_target_"] = "encoder"
    mlm_cfg["transformer"]["transformer"]["attention"]["use_flash"] = True
    mlm_cfg["transformer"]["lm_head"] = {"_target_": "lm"}
    rng = np.random.RandomState(SEED)
    x = np.asarray(host_batch["perf"])[:MLM_BATCH, :MLM_SEQ].copy()
    positions = np.sort(rng.choice(np.arange(1, MLM_SEQ), MLM_MASKED, replace=False))
    x[:, positions[:, None], [3, 5, 7, 8]] = 1  # Velocity, Tempo, RelOnsetDev, RelPerfDuration
    mask = np.ones(x.shape[:2], bool)
    mask[-1, MLM_SEQ - 10:] = False
    mlm = {}
    for label, single_run in (("single_run", True), ("iterative", False)):
        out = {}
        for dev in ("cuda", "cpu"):
            with cpu_ref() if dev == "cpu" else contextlib.nullcontext():
                m, _ = build_performer(mlm_cfg, device=dev, seed=SEED)
                reset_counts(fa, kv, pa)
                t0 = time.perf_counter()
                out[dev] = mlm_unmask(m.eval(), torch.as_tensor(x, device=dev), single_run=single_run,
                                      mask=torch.as_tensor(mask, device=dev), greedy=True).cpu()
            if dev == "cuda":
                launches, wall = all_counts(fa, kv, pa), time.perf_counter() - t0
        forwards = 1 if single_run else MLM_MASKED
        expected = {**{k: 0 for k in launches}, "flash_attention_fwd": DECODER_LAYERS * forwards}
        check_launches(f"mlm_unmask ({label})", launches, expected)
        same = torch.equal(out["cuda"], out["cpu"])
        mlm[label] = {"shape": list(x.shape), "masked_positions": MLM_MASKED, "wall_ms": wall * 1e3,
                      "identical": same, "launches": launches, "mask_left": int((out["cuda"] == 1).sum())}
        print(f"performer mlm_unmask ({label}), card vs CPU", json.dumps(mlm[label]))
        # the single run takes the plain argmax, which may pick MASK itself (as in JAX); the iterative
        # fill never draws a special id
        if not same or (not single_run and mlm[label]["mask_left"]):
            raise AssertionError(f"mlm_unmask ({label}): card tokens differ from the CPU's or MASK left")
    rec["mlm_unmask"] = mlm
    del model
    torch.cuda.empty_cache()
    lap("mlm_unmask")

    # ---- 5. the kernels at this slice's shapes ----
    # the chunked run's cache; the ring's window, at the slot of its last step
    cap = max(GEN_SEQ + 1, GEN_T0 - 2 + gens["chunked"]["padded_steps"])
    window = model_config["transformer"]["max_seq_len"]
    shapes = {
        "write_kv_pair": [check_write_kv(torch, kv, CHUNK, 1, GEN_BATCH, 64, 5, torch.float32, False, pair=True),
                          check_write_kv(torch, kv, window, 1, 1, 64, RING_SEQ % window, torch.float32, False,
                                         pair=True),
                          check_write_kv(torch, kv, cap, GEN_T0 - 1, GEN_BATCH, 64, 0, torch.float32, False,
                                         pair=True)],
        "prefix_attend": [check_prefix_attend(torch, pa, GEN_BATCH, cap, base, timed=False)
                          for base in range(GEN_T0 - 2, cap - CHUNK + 1, CHUNK)],
        "flash_attention_fwd": [check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded="performer",
                                            timed=False, lengths=lengths),
                                check_flash(torch, fa, MLM_BATCH, MLM_SEQ, causal=False, padded="mlm", timed=False,
                                            lengths=mask.sum(1).tolist())],
    }
    dkv, dq, _ = check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded="performer",
                                 timed=False, lengths=lengths)
    shapes["flash_attention_bwd_dkv"], shapes["flash_attention_bwd_dq"] = [dkv], [dq]
    for name, recs in shapes.items():
        for r in recs:
            print(f"{name}, performer", json.dumps(r))
    rec["kernels"] = shapes
    lap("kernels")
    return rec


def moe_train_config(tokenizer, root, out_dir, batch_size, max_steps):
    """recipes/scoreperformer/moe.yaml's experiment on the prepared corpus at
    `root`: base.yaml's dataset with direction labels, its 4 direction
    classifier heads, moe.yaml's model, the train phase's run settings."""
    cfg = paper_config(tokenizer, root, out_dir, batch_size, max_steps)
    cfg["model"] = {"_name_": "ScorePerformer", **moe_config(tokenizer),
                    "classifiers": json.loads(json.dumps(PAPER_CLASSIFIERS))}
    return cfg


def moe_stacks(model):
    """{stack: [layer indices of its MoE feed-forwards]} of a ScorePerformer."""
    from scoreperformer_tpu_torch.models.moe import MoEFeedForward

    stacks = {"score_encoder": model.score_encoder, "perf_encoder": model.perf_encoder,
              "perf_decoder": model.decoder}
    return {name: [i for i, (_, block) in enumerate(m.transformer.layers) if isinstance(block, MoEFeedForward)]
            for name, m in stacks.items()}


@contextlib.contextmanager
def router_margins(torch, models):
    """Forward hooks on the MoE layers of `models`: each call appends, per
    model, the smallest margin over its tokens between the last routing
    probability chosen and the first one left out (where a routing can flip
    between two devices)."""
    from scoreperformer_tpu_torch.models.moe import MoEFeedForward

    margins, hooks = [[] for _ in models], []
    for record, model in zip(margins, models):
        for m in model.modules():
            if isinstance(m, MoEFeedForward):
                def hook(mod, args, out, record=record):
                    probs = torch.softmax(args[0].float() @ mod.router.float(), dim=-1)
                    top = probs.sort(dim=-1, descending=True).values
                    record.append(float((top[..., mod.top_k - 1] - top[..., mod.top_k]).min()))
                hooks.append(m.register_forward_hook(hook))
    try:
        yield margins
    finally:
        for h in hooks:
            h.remove()


def same_greedy(torch, what, pair, outs):
    """The card's and the CPU's greedy tokens `outs` (each a tensor, or a
    list of arrays, None for none) are the same; if not, `pair()` gives
    (the two sides' models, `run`) and `run(0)` (the card) and `run(1)` (the
    CPU) run again with those models' MoE layers hooked, and the smallest
    top-k router margins of each side's MoE calls are printed before the
    gate fails."""
    flat = [np.concatenate([np.asarray(x).reshape(-1) for x in (o if isinstance(o, list) else [o]) if x is not None]
                           or [np.zeros(0)]) for o in outs]
    n = min(len(flat[0]), len(flat[1]))
    if len(flat[0]) == len(flat[1]) and np.array_equal(flat[0], flat[1]):
        return True
    first = int(np.flatnonzero(flat[0][:n] != flat[1][:n])[0]) if (flat[0][:n] != flat[1][:n]).any() else n
    models, run = pair()
    with router_margins(torch, models) as margins:
        run(0)
        run(1)
    print(f"{what}: card and CPU differ first at flat token {first}; smallest router margins of the card's "
          f"MoE calls {sorted(margins[0])[:8]}, the CPU's {sorted(margins[1])[:8]}")
    raise AssertionError(f"{what}: the card's greedy tokens differ from the CPU path's")


def moe_phase(torch, tokenizer, smi, score, inputs, serve_scores, serve_inputs, stream_data, refs, stream_root):
    """recipes/scoreperformer/moe.yaml on the card (5 MoE layers: 1 in the
    score encoder, 2 in the performance encoder, 2 in the decoder):
    1. trained as written (base.yaml's widths, dropout and 4 direction
       classifier heads, moe.yaml's feed-forward) on the paper phase's
       prepared corpus at batch 128 x 258: 2 + 8 steps with `loss/moe_aux`
       and `stats/moe_drop`, peak memory, one step profiled; a batch-4 step
       (dropout off) within 1e-4 and 1e-3 of the CPU's, aux included;
    2. from those weights (a port checkpoint): the 32-bar render, 16 served
       requests and 12 greedy streamed windows (1.2 s over a 64-row cache),
       each with the CPU path's greedy tokens (from `refs`' worker,
       `cpu_moe_references`, gated in `refs.check_all`) and the dense
       formula's `write_kv_pair` and `prefix_attend` launches; renditions with the
       score's pitches and finite times (10-step weights may leave any share
       of the notes "not performed": counted, not gated);
    3. an 8-bar score decoded with the classic layout and every
       `mixedlm_unmask` variant, each with the classic tokens and its own
       launches (static_prefix's first chunk launches no `prefix_attend`);
    4. the tokenizer ops on the served renditions, card against CPU;
    5. `prefix_attend` against its plain version at the variants' caps (a
       static prefix at cap = base, each stage of `capacity_stages` at its
       first and last chunk) and at the served batch's
       b = 16, and `write_kv_pair` into the served batch's fresh buffers.
    Returns the phase's record."""
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import (
        RenderServer, ScorePerformerGenerator, SPMuple2Messenger, load_model_from_checkpoint, prepare_render_inputs,
        render_performance,
    )
    from scoreperformer_tpu_torch.models.factory import build_model
    from scoreperformer_tpu_torch.models.wrappers import mixedlm_unmask
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.ops.tokenizer_ops import TokenizerOps
    from scoreperformer_tpu_torch.training import ExperimentComponents, save_checkpoint

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    root, work = os.path.join(build, "chip_smoke_paper", "data"), os.path.join(build, "chip_smoke_moe")
    shutil.rmtree(work, ignore_errors=True)
    rec = {"card": smi, "phase_s": phase_s}
    layers = DECODER_LAYERS

    # ---- 1. train moe.yaml as written ----
    comp = ExperimentComponents(moe_train_config(tokenizer, root, os.path.join(work, "run"), TRAIN_BATCH, 2),
                                device="cuda").init_components()
    trainer, model = comp.trainer, comp.model
    trainer._prepare()
    stacks = moe_stacks(model)
    moe_shapes = sorted({(tuple(m.wi.shape), tuple(m.wo.shape)) for m in model.modules() if hasattr(m, "router")})
    if [len(v) for v in stacks.values()] != [1, 2, 2]:
        raise AssertionError(f"moe.yaml's model has MoE layers {stacks}, expected 1, 2 and 2")
    lap("build")
    torch.cuda.reset_peak_memory_stats()
    step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset,
                                                          TRAIN_WARMUP, TRAIN_TIMED, flash=0)
    train = train_record(torch, step_ms, notes, launches)
    train.update(parameters=sum(p.numel() for p in model.parameters()), moe_layers=stacks,
                 moe_wi_wo_shapes=[list(map(list, x)) for x in moe_shapes],
                 last_step={k: v for k, v in values.items() if k in ("loss", "loss/moe_aux", "stats/moe_drop")
                            or k.startswith("clf")})
    if not ("loss/moe_aux" in values and 0.0 <= values["stats/moe_drop"] <= 1.0):
        raise AssertionError(f"the MoE train step logged {sorted(values)}")
    lap("train_steps")
    prof = profile_device(torch, lambda: trainer.train_step(batch, TRAIN_WARMUP + TRAIN_TIMED), ported=PORTED_TRAIN)
    train["profile"] = {k: v for k, v in prof.items() if k != "top"}
    print("profile MoE train step", json.dumps(prof))
    print(f"MoE train steps ({smi})", json.dumps(train))
    rec["train"] = train
    host_batch = {k: v.cpu().numpy() for k, v in batch.items()}  # the last step's batch
    model_config = json.loads(json.dumps(comp.model_config))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del comp, trainer, model, batch
    torch.cuda.empty_cache()
    lap("profiled_step")

    # a batch-4 step against the CPU's, dropout off (the two draw other masks)
    gate = compare_train_step(torch, dropout_off(model_config), host_batch)
    rec["card_vs_cpu"] = {k: gate[k] for k in ("loss_err", "grad_err", "worst", "gradients")}
    print("MoE train step at batch 4, card vs CPU (aux included):", json.dumps(rec["card_vs_cpu"]))
    if not (gate["loss_err"] <= 1e-4 and gate["grad_err"] <= 1e-3):
        raise AssertionError(f"the MoE step on the card differs from the CPU's: {gate}")
    lap("card_vs_cpu")

    # ---- 2. the trained weights as a port checkpoint: render, serve, stream ----
    serve_cfg = json.loads(json.dumps(model_config))
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        serve_cfg[key]["max_seq_len"] = SERVE_BUCKET + 2
    serve_cfg["perf_encoder"]["max_segments"] = SERVE_BUCKET + 4
    cpu_model, _ = build_model("ScorePerformer", {k: v for k, v in serve_cfg.items() if not k.startswith("_")},
                               device="cpu", seed=SEED)
    cpu_model.load_state_dict(state)
    ckpt = save_checkpoint(os.path.join(work, "checkpoint"), cpu_model, model_config=serve_cfg)
    tokenizer.save(os.path.join(ckpt, "tokenizer.json"))
    del cpu_model
    requests = [dict(score_midi=sc, greedy=True) for sc in serve_scores[:MOE_REQUESTS]]
    cpu_job = refs.submit(cpu_moe_references, ckpt, score, requests, stream_root)
    card_model = load_model_from_checkpoint(ckpt, device="cuda")[0]

    T = len(inputs["deadpan_ids"])
    n_steps = -(-(T - 1) // CHUNK) * CHUNK

    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perf = render_performance(card_model, tokenizer, score, seed=SEED, device="cuda", greedy=True)
    torch.cuda.synchronize()
    rec["render"] = {"bars": N_BARS, "notes": perf.num_notes, "wall_s": time.perf_counter() - t0,
                     "launches": all_counts(fa, kv, pa),
                     "notes_not_performed": check_performance(tokenizer, inputs["score_ids"], perf, "MoE render",
                                                              all_performed=False, max_left_out=1.0)}
    check_launches("the MoE render", rec["render"]["launches"], decode_launches(n_steps, layers, 0))
    notes = perf.all_notes()
    card_outs = {"render": [notes.pitch, notes.velocity, notes.start, notes.end]}
    print(f"MoE render ({smi})", json.dumps(rec["render"]))
    lap("render")

    # ---- 3. every mixedlm_unmask variant on an 8-bar score ----
    xv = prepare_render_inputs(tokenizer, synthetic_score(np.random.RandomState(SEED + 3), n_bars=MOE_VARIANT_BARS))
    Tv = len(xv["deadpan_ids"])
    nv = -(-(Tv - 1) // CHUNK) * CHUNK
    with torch.inference_mode():
        x = {k: torch.as_tensor(np.asarray(xv[k])[None], dtype=torch.int64, device="cuda")
             for k in ("deadpan_ids", "score_ids", "bars", "beats", "onsets", "tokens_in", "masked_all")}
        mask = torch.ones_like(x["bars"], dtype=torch.bool)
        score_emb, style_emb, _ = card_model.encode_embeddings(x["deadpan_ids"], mask, x["score_ids"], mask,
                                                               x["bars"], x["beats"], x["onsets"])
    variants = {}
    for name, kw in [("classic", {"chunk_size": None})] + list(MOE_VARIANTS.items()):
        reset_counts(fa, kv, pa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = mixedlm_unmask(card_model, x["tokens_in"], x["masked_all"], style_embeddings=style_emb,
                                context=score_emb, greedy=True, **kw).cpu()
        wall = time.perf_counter() - t0
        got = all_counts(fa, kv, pa)
        if name == "classic":
            classic, expected = tokens, {**{k: 0 for k in got}, "write_kv_pair": layers * (Tv - 1)}
        else:
            expected = {**{k: 0 for k in got}, "write_kv_pair": layers * nv,
                        "prefix_attend": layers * (nv - (CHUNK if kw.get("static_prefix") else 0))}
        check_launches(f"mixedlm_unmask ({name})", got, expected)
        variants[name] = {"wall_s": wall, "launches": got, "identical_to_classic": torch.equal(tokens, classic)}
        if not variants[name]["identical_to_classic"]:
            raise AssertionError(f"mixedlm_unmask ({name}) on the card differs from the classic layout's tokens")
    rec["variants"] = {"bars": MOE_VARIANT_BARS, "notes": Tv, "steps": nv, "runs": variants}
    print("MoE mixedlm_unmask variants", json.dumps(rec["variants"]))
    lap("variants")

    bucket = -(-max(len(s["deadpan_ids"]) for s in serve_inputs[:MOE_REQUESTS]) // 128) * 128
    server = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cuda")
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = server.render_batch(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(fa, kv, pa)
    check_launches("the MoE served batch", launches, decode_launches(-(-(bucket - 1) // CHUNK) * CHUNK, layers, 0))
    left_out = sum(check_performance(tokenizer, serve_inputs[i]["score_ids"], r["perf"], f"MoE served request {i}",
                                     all_performed=False, max_left_out=1.0) for i, r in enumerate(out))
    card_outs["served"] = [r["tokens"] for r in out]
    rec["served"] = {"requests": len(requests), "bucket": bucket, "wall_s": wall, "notes": sum(r["notes"] for r in out),
                     "notes_not_performed": left_out, "launches": launches}
    print(f"MoE served batch ({smi})", json.dumps(rec["served"]))
    del server
    lap("served")

    dataset, collator = stream_data

    def streamed(model):
        gen = ScorePerformerGenerator(model, dataset, collator, SPMuple2Messenger(dataset.tokenizer))
        gen.reset()
        gen.prepare_performance_notes(0, overlay_bars=0.0)
        return stream(gen, STREAM_GATE_WINDOWS, STREAM_GATE_WINDOW, STREAM_GATE_CTX, greedy=True), gen

    reset_counts(fa, kv, pa)
    windows, gen = streamed(card_model)
    card_outs["streaming"] = [w["tokens"] for w in windows]
    launches, stats = all_counts(fa, kv, pa), dict(gen._decoder.stats)
    check_stream_vocab(gen, windows, "MoE greedy streaming")
    del gen
    expected = {**{k: 0 for k in launches}, "write_kv_pair": layers * (stats["consume_calls"] + stats["block_steps"])}
    check_launches("the MoE streaming run", launches, expected)
    rec["streaming"] = {
        "windows": len(windows), "window_s": STREAM_GATE_WINDOW, "max_context_len": STREAM_GATE_CTX,
        "notes": sum(0 if w["tokens"] is None else len(w["tokens"]) for w in windows),
        "window_ms": [round(w["wall_s"] * 1e3, 3) for w in windows],
        "window_starts": sorted({w["window_start"] for w in windows}), "decoder_stats": stats, "launches": launches}
    print(f"MoE greedy streaming ({smi})", json.dumps(rec["streaming"]))
    if max(rec["streaming"]["window_starts"]) == 0:
        raise AssertionError("the MoE streaming gate's windows never shifted the context window")
    lap("streaming")

    # the CPU's render, served batch and streamed windows come from the
    # worker; on a mismatch both sides run again (the CPU's here), with the
    # router margins of their MoE calls (`same_greedy`)
    def model_pair():
        return [card_model, load_model_from_checkpoint(ckpt, device="cpu")[0].eval()]

    def render_pair():
        models = model_pair()
        return models, lambda i: (lambda n: [n.pitch, n.velocity, n.start, n.end])(render_performance(
            models[i], tokenizer, score, seed=SEED, device=("cuda", "cpu")[i], greedy=True).all_notes())

    def served_pair():
        servers = [RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device=d) for d in ("cuda", "cpu")]
        return [s.model for s in servers], lambda i: [r["tokens"] for r in servers[i].render_batch(requests)]

    def streamed_pair():
        models = model_pair()
        return models, lambda i: [w["tokens"] for w in streamed(models[i])[0]]

    def gate(cpu):
        for key, what, pair in (("render", "the MoE render", render_pair),
                                ("served", "the MoE served batch", served_pair),
                                ("streaming", "the MoE streamed windows", streamed_pair)):
            rec[key]["identical_to_cpu"] = same_greedy(torch, what, pair, outs=[card_outs[key], cpu[key]])
        print("MoE render, served batch and streamed windows, card vs CPU: identical")

    refs.later("the MoE render, served batch and streamed windows against the CPU path's", cpu_job, gate)

    # ---- 4. the tokenizer ops on the served renditions, card against CPU ----
    ops = TokenizerOps(tokenizer)
    worst = {"ticks": 0.0, "times": 0.0}
    for r, x_in in zip(out, serve_inputs):
        res = {}
        for dev in ("cuda", "cpu"):
            tok = torch.as_tensor(r["tokens"], device=dev)  # the CPU's share here is milliseconds
            res[dev] = [t.cpu() for t in (ops.note_on_ticks(tok, tokenizer.max_beat_res),
                                          *ops.spmuple2_decode_times(tok, tokenizer.max_beat_res),
                                          ops.score_tokens_as_performance(torch.as_tensor(x_in["score_ids"], device=dev)))]
        (ticks, t0_, t1_, perf_mask, deadpan), (cticks, ct0, ct1, cmask, cdeadpan) = res["cuda"], res["cpu"]
        worst["ticks"] = max(worst["ticks"], float((ticks - cticks).abs().max() / cticks.abs().max().clamp_min(1.0)))
        worst["times"] = max(worst["times"], max(float((a - b).abs().max() / b.abs().max().clamp_min(1.0))
                                                 for a, b in ((t0_, ct0), (t1_, ct1))))
        if not (torch.equal(perf_mask, cmask) and torch.equal(deadpan, cdeadpan)
                and np.array_equal(deadpan.numpy(), np.asarray(x_in["deadpan_ids"]))):
            raise AssertionError("the tokenizer ops' masks or deadpan tokens differ between the card and the CPU")
    stacked = torch.as_tensor(np.stack([out[0]["tokens"]] * 4))
    batched = [ops.spmuple2_decode_times_batch(stacked.to(dev), tokenizer.max_beat_res) for dev in ("cuda", "cpu")]
    worst["batched_times"] = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1.0))
                                 for a, b in zip(batched[0][:2], batched[1][:2]))
    rec["tokenizer_ops"] = {"performances": len(out), "max_rel_err": worst}
    print("MoE tokenizer ops, card vs CPU:", json.dumps(rec["tokenizer_ops"]))
    if not max(worst.values()) <= 1e-5:
        raise AssertionError(f"the tokenizer ops on the card differ from the CPU's by {worst}")
    torch.cuda.empty_cache()
    lap("tokenizer_ops")

    # ---- 5. the kernels at this phase's shapes ----
    n_chunks = nv // CHUNK
    bounds = sorted({(g * n_chunks) // 4 for g in range(5)})
    stage_cases = [(c1 * CHUNK, c * CHUNK) for c0, c1 in zip(bounds[:-1], bounds[1:]) for c in sorted({c0, c1 - 1})]
    shapes = {
        "prefix_attend": [dict(check_prefix_attend(torch, pa, 1, base, base, timed=False),
                               path="static_prefix") for base in range(CHUNK, nv, CHUNK)]
        + [dict(check_prefix_attend(torch, pa, 1, cap, base, timed=False),
                path="capacity_stages_4") for cap, base in stage_cases]
        + [dict(check_prefix_attend(torch, pa, MOE_REQUESTS, SERVE_BUCKET, base, timed=False), path="moe_served")
           for base in (0, CHUNK, SERVE_BUCKET // 2, SERVE_BUCKET - CHUNK)],
        "write_kv_pair": [dict(check_write_kv(torch, kv, CHUNK, 1, MOE_REQUESTS, 64, idx, torch.float32, False,
                                              pair=True), path="moe_served") for idx in (0, 5, CHUNK - 1)],
    }
    for name, recs in shapes.items():
        for r in recs:
            print(f"{name}, MoE", json.dumps(r))
    rec["kernels"] = shapes
    lap("kernels")
    return rec


PARALLEL_RANKS = 2  # processes of the data, model and expert checks; data x model takes 4


def parallel_gates(one, got, what, grad_tol=1e-3, param_tol=1e-4, loss_tol=1e-4):
    """A multi-rank run held to the one-process run of the same payload:
    each step's loss within `loss_tol`, every gradient of the first step
    within `grad_tol` of that gradient's largest value, and every parameter
    after the steps within `param_tol` of that parameter's largest value.
    Also reported: the parameters' error as one relative L2 over all of
    them, and the elements past `param_tol` of their tensor's largest
    value. Returns the errors."""
    def rel(a, b):
        return max(((a[n] - w).abs().max() / w.abs().max().clamp_min(1e-12)).item() for n, w in b.items())

    if set(got["grads"]) != set(one["grads"]) or set(got["params"]) != set(one["params"]):
        raise AssertionError(f"{what}: the ranks' step reaches other tensors than the one-process step")
    diff = math.sqrt(sum(((got["params"][n] - w).float().norm() ** 2).item() for n, w in one["params"].items()))
    total = math.sqrt(sum((w.float().norm() ** 2).item() for w in one["params"].values()))
    worst = max((((got["params"][n] - w).abs().max() / w.abs().max().clamp_min(1e-12)).item(), n)
                for n, w in one["params"].items())
    errs = {"loss_err": max(abs(g["loss"] - o["loss"]) for g, o in zip(got["metrics"], one["metrics"])),
            "grad_err": rel(got["grads"], one["grads"]), "param_rel_l2": diff / total,
            "param_err": worst[0], "param_worst": worst[1],
            "param_elements_past_tol": sum(int(((got["params"][n] - w).abs() > param_tol * w.abs().max()).sum())
                                           for n, w in one["params"].items()),
            "param_elements": sum(w.numel() for w in one["params"].values())}
    if not (errs["loss_err"] <= loss_tol and errs["grad_err"] <= grad_tol and errs["param_err"] <= param_tol):
        raise AssertionError(f"{what}: the multi-rank steps differ from the one-process steps: {errs}")
    return errs


def parallel_phase(torch, tokenizer, smi, inputs, refs):
    """Training on several processes (`scoreperformer_tpu_torch.parallel`):
    the flagship with `use_flash` at batch 128 x 258 (2 adamw steps on the
    training phase's dataset) on data = 2 with ZeRO, model = 2 (2 query
    heads a rank) and data = 2 x model = 2 (4 ranks), and moe.yaml as written
    at expert = 2 (2 experts a rank, on the paper phase's corpus), each held
    to the one-process steps of the same global batch: loss within 1e-4,
    gradients within 1e-3 and the parameters after 2 steps within 1e-4 of
    each tensor's largest value (`parallel_gates`), moe.yaml's
    `loss/moe_aux` and `stats/moe_drop` within 1e-5; 10 launches of each flash kernel a step
    on every rank. Processes start through `parallel.launch`: with two cards
    or more, one a rank over nccl; with one card, a world-size-1 nccl group
    (a step and each collective on the card) and the multi-rank checks as
    processes sharing the card over gloo (their times measure contention,
    not scaling). The data = 2 run saves a sharded and an async checkpoint
    (ZeRO on, the optimizer's state in them) and a gathered one; the first
    two restore in one process and at model = 2 to every saved tensor, and
    the gathered `params.pt` renders the 32-bar score with the CPU path's
    greedy tokens. Then the flash kernels at the model axis's shape (b 128,
    h 2, hk 1, t 258 padded and 257 causal, d 64) and `prefix_attend` at
    moe.yaml's served batch (b 16, cap 384) against their plain versions.
    Returns the phase's record."""
    from scoreperformer_tpu_torch.inference import load_model_from_checkpoint
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.parallel.launch import launch
    from scoreperformer_tpu_torch.parallel.workers import run_one_process, train_worker
    from scoreperformer_tpu_torch.training import ExperimentComponents, load_checkpoint

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    work = os.path.join(build, "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= PARALLEL_RANKS else "gloo"
    rec = {"card": smi, "cards": cards, "backend": backend, "phase_s": phase_s,
           "ranks_a_card": 1 if backend == "nccl" else PARALLEL_RANKS}

    def payload_of(config, steps=2, **trainer):
        comp = ExperimentComponents(config, device="cpu")
        comp.build_datasets(), comp.build_collator(), comp.build_model(), comp.build_trainer()
        host = next(iter(comp.trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0)))
        cfg = {k: v for k, v in comp.model_config.items() if k != "_name_"}
        return {"model_name": comp.model_config["_name_"], "model_config": cfg,
                "state_dict": {k: v.detach().clone() for k, v in comp.model.state_dict().items()},
                "batch": {k: np.asarray(v) for k, v in host.items()}, "steps": steps,
                "trainer": {"seed": 23, "optimization": dict(OPTIMIZATION), **trainer}}

    def run(name, payload, n, ranks_backend=backend):
        path = os.path.join(work, f"{name}.pt")
        torch.save({**payload, "device": "cuda", "output_dir": os.path.join(work, name)}, path)
        t0 = time.perf_counter()
        out = launch(train_worker, n, (path,), backend=ranks_backend, device="cuda")
        lap(name)
        print(f"parallel {name}: {n} ranks over {ranks_backend} in {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    # ---- the payloads and the one-process references ----
    root = os.path.join(build, "chip_smoke_train", "data")
    flag = payload_of(train_config(tokenizer, root, os.path.join(work, "flagship"), TRAIN_BATCH, 2))
    torch.cuda.empty_cache()
    one_flag = run_one_process(flag, device="cuda")
    moe = payload_of(moe_train_config(tokenizer, os.path.join(build, "chip_smoke_paper", "data"),
                                      os.path.join(work, "moe"), TRAIN_BATCH, 2))
    one_moe = run_one_process(moe, device="cuda")
    torch.cuda.empty_cache()
    lap("one_process")
    for what, one in (("flagship", one_flag), ("moe.yaml", one_moe)):
        if not all(np.isfinite(m["loss"]) for m in one["metrics"]):
            raise AssertionError(f"{what}: non-finite one-process loss {one['metrics']}")

    # ---- one card: a world-size-1 nccl group runs a step and each collective on the card ----
    if backend == "gloo":  # in this process: spawning one costs more than the step
        import torch.distributed as dist

        path = os.path.join(work, "nccl_world1.pt")
        torch.save({**flag, "steps": 1, "probe_collectives": True, "device": "cuda",
                    "output_dir": os.path.join(work, "nccl_world1")}, path)
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(work, 'nccl_store')}", world_size=1, rank=0)
        try:
            nccl = train_worker(0, 1, path)
        finally:
            dist.destroy_process_group()
        lap("nccl_world1")
        if any(v != "ok" for v in nccl["collectives"].values()):
            raise AssertionError(f"nccl on one rank: {nccl['collectives']}")
        if abs(nccl["metrics"][0]["loss"] - one_flag["metrics"][0]["loss"]) > 1e-4:
            raise AssertionError("the world-size-1 nccl step differs from the one-process step")
        rec["nccl_world1"] = {"collectives": nccl["collectives"], "step_ms": nccl["step_ms"],
                              "backend": nccl["backend"]}

    # ---- data = 2 with ZeRO: checkpoints; model = 2; data = 2 x model = 2; expert = 2 ----
    saves = [{"name": "sharded", "sharded": True}, {"name": "async", "async": True}, {"name": "gathered"}]
    runs = {
        "data2_zero": run("data2_zero", {**flag, "trainer": {**flag["trainer"], "mesh_data": 2, "zero_sharding": True},
                                         "probe_collectives": True, "profile": True, "checkpoints": saves}, 2),
        # (data2_zero has saved its checkpoints when model2 starts: model2
        # restores the sharded one last)
        "model2": run("model2", {**flag, "trainer": {**flag["trainer"], "mesh_model": 2}, "profile": True,
                                 "check_restore": os.path.join(work, "data2_zero", "sharded")}, 2),
        "data2_model2": run("data2_model2", {**flag, "trainer": {**flag["trainer"], "mesh_data": 2, "mesh_model": 2},
                                             "profile": True}, 4),
        # sequence parallelism: the encoders' 258 positions split over the
        # model axis, the decoder's 257 do not (JAX's no-op rule)
        "data2_model2_sp": run("data2_model2_sp", {**flag, "trainer": {**flag["trainer"], "mesh_data": 2,
                                                                       "mesh_model": 2, "sequence_parallel": True},
                                                   "profile": True}, 4),
        "moe_expert2": run("moe_expert2", {**moe, "trainer": {**moe["trainer"], "mesh_expert": 2}, "profile": True}, 2),
    }
    # each collective of the ranks' backend on CUDA tensors, its result read
    # at once on the current stream: the port stages none through host
    # memory, so each it calls must be "ok"
    rec["collectives_on_cuda"] = runs["data2_zero"][0]["collectives"]
    print(f"parallel: {backend}'s collectives on CUDA tensors", json.dumps(rec["collectives_on_cuda"]),
          "; none staged through host memory")
    if any(rec["collectives_on_cuda"][k] != "ok" for k in ("all_reduce", "all_gather")):
        raise AssertionError(f"{backend} gives wrong results of the port's collectives on CUDA tensors")
    steps = {}
    for name, ranks in runs.items():
        one = one_moe if name.startswith("moe") else one_flag
        got = ranks[0]
        errs = parallel_gates(one, got, name)
        if name.startswith("moe"):
            for key in ("loss/moe_aux", "stats/moe_drop"):
                err = max(abs(g[key] - o[key]) for g, o in zip(got["metrics"], one["metrics"]))
                if not err <= 1e-5:
                    raise AssertionError(f"{name}: {key} differs from the one-process value by {err}")
                errs[f"{key}_err"] = err
        flash = 0 if name.startswith("moe") else 10  # moe.yaml sets no use_flash
        for r in ranks:
            want = {k: flash * len(r["step_ms"]) for k in FLASH}
            if r["launches"] != want:
                raise AssertionError(f"{name} rank {r['rank']}: flash launches {r['launches']}, expected {want}")
        steps[name] = {
            "ranks": len(ranks), "backend": got["backend"], "mesh": got["mesh"], **errs,
            "step_ms": [r["step_ms"] for r in ranks], "peak_gb": [r["peak_gb"] for r in ranks],
            "profiled_step": [r["profiled_step"] for r in ranks], "launches_a_rank": ranks[0]["launches"],
            "one_process_step_ms": (one_moe if name.startswith("moe") else one_flag)["step_ms"],
            "one_process_peak_gb": (one_moe if name.startswith("moe") else one_flag)["peak_gb"],
        }
    rec["steps"] = steps

    # ---- the checkpoints: restored in one process and at model = 2; the gathered one renders ----
    saved = runs["data2_zero"][0]
    ckpts = saved["checkpoints"]
    for name in ("sharded", "async"):
        loaded = load_checkpoint(ckpts[name])
        for key, want in (("params", saved["params"]), ("mu", saved["opt_state"]["mu"]),
                          ("nu", saved["opt_state"]["nu"])):
            got = loaded["params"] if key == "params" else loaded["opt_state"][key]
            bad = [n for n in want if not torch.equal(got[n], want[n])]
            if bad or set(got) != set(want):
                raise AssertionError(f"{name} checkpoint restored in one process: {key} differs at {bad[:3]}")
    if ckpts["sharded"] != os.path.join(work, "data2_zero", "sharded"):
        raise AssertionError(f"the sharded checkpoint was saved at {ckpts['sharded']}")
    restored = runs["model2"][0]["restored"]
    bad = [n for n in saved["params"] if not torch.equal(restored["params"][n], saved["params"][n])]
    bad += [f"mu/{n}" for n in saved["opt_state"]["mu"]
            if not torch.equal(restored["opt_state"]["mu"][n], saved["opt_state"]["mu"][n])]
    if bad:
        raise AssertionError(f"the sharded checkpoint restored at model = 2 differs at {bad[:3]}")
    lap("checkpoint_restores")
    reset_counts(fa, kv, pa)
    model, _ = load_model_from_checkpoint(os.path.join(ckpts["gathered"], "params.pt"), device="cuda")
    card = greedy_tokens(torch, model, inputs, "cuda")
    launches = all_counts(fa, kv, pa)
    lap("render_card")
    # the CPU path's tokens from the worker, gated in `refs.check_all`
    def gate(cpu):
        if not torch.equal(card, torch.as_tensor(cpu)):
            raise AssertionError("the render from the gathered checkpoint differs from the CPU path's greedy tokens")

    refs.later("the render from the gathered checkpoint against the CPU path's greedy tokens",
               refs.submit(cpu_greedy_from_checkpoint, os.path.join(ckpts["gathered"], "params.pt"), inputs), gate)
    n_steps = -(-(len(inputs["deadpan_ids"]) - 1) // CHUNK) * CHUNK
    check_launches("render from the gathered checkpoint", launches, decode_launches(n_steps))
    rec["checkpoints"] = {"restored": ["sharded in one process", "async in one process", "sharded at model = 2"],
                          "render_launches": launches, "render_tokens": list(card.shape)}
    del model

    # ---- the kernels at the model axis's shape and prefix_attend at moe.yaml's served batch ----
    kernels = {"flash_attention_fwd": [check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, False, True, False, h=2),
                                       check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, True, False, False, h=2)]}
    dkv, dq, _ = check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, False, True, False, h=2)
    check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, True, False, False, h=2)
    kernels.update(flash_attention_bwd_dkv=[dkv], flash_attention_bwd_dq=[dq])
    kernels["prefix_attend"] = [check_prefix_attend(torch, pa, SMOKE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, False)]
    rec["kernels"] = kernels
    lap("kernels")
    return rec


PIPE_MICROBATCHES = 4  # M of the GPipe runs: 2 stages over the decoder trunk's 4 units
# the train step's adamw without clipping: a stage holds part of the parameters, so no rank sees the global norm
PIPE_OPTIMIZATION = dict(lr=2e-4, optimizer="adamw", optimizer_params={"weight_decay": 1e-6})
PIPE_RUNS = {"data2_pipe2": {"data": 2, "pipe": 2}, "data2_pipe2_model2_sp": {"data": 2, "pipe": 2, "model": 2}}


def trunk_inputs(torch, tokenizer):
    """The flagship decoder trunk's config and weights (the model at full
    width from SEED, `use_flash`) and its input, mask and AdaNorm style rows
    from the flagship's forward at the train step's batch (128 x 258: 257
    causal decoder positions), taken by a hook on the trunk."""
    from scoreperformer_tpu_torch.training import ExperimentComponents

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    comp = ExperimentComponents(train_config(tokenizer, os.path.join(build, "chip_smoke_train", "data"),
                                             os.path.join(build, "chip_smoke_pipeline", "flagship"), TRAIN_BATCH, 2),
                                device="cpu")
    comp.build_datasets(), comp.build_collator(), comp.build_model(), comp.build_trainer()
    host = next(iter(comp.trainer._iter_batches(comp.train_dataset, TRAIN_BATCH, True, 0)))
    model = comp.model.to("cuda").eval()
    trunk, seen = model.decoder.transformer, {}

    def grab(module, args, kwargs):
        seen.update(x=args[0], mask=kwargs.get("mask"), style=kwargs.get("style_embeddings"))

    hook = trunk.register_forward_pre_hook(grab, with_kwargs=True)
    with torch.no_grad():
        model(**{k: torch.as_tensor(np.asarray(v)).to("cuda") for k, v in host.items()})
    hook.remove()
    inputs = {k: v.detach().cpu().clone() for k, v in seen.items()}
    state = {k: v.detach().cpu().clone() for k, v in trunk.state_dict().items()}
    config = trunk.config
    del model, comp
    torch.cuda.empty_cache()
    return config, state, inputs


def trunk_gates(one, got, what, rel=1e-4, abs_tol=1e-5):
    """A pipelined run held to the one-process trunk: the first loss within
    `rel` relative, every gradient (parameters, x, style rows) within
    abs_tol + rel x its largest value, the second step's loss below the
    first. Returns the errors."""
    grads = dict(one["grads"], x=one["x_grad"], style=one["style_grad"])
    mine = dict(got["grads"], x=got["x_grad"], style=got["style_grad"])
    if set(grads) != set(mine):
        raise AssertionError(f"{what}: the pipelined step reaches other tensors than the one-process step")
    errs = {"loss_rel_err": abs(got["losses"][0] - one["losses"][0]) / abs(one["losses"][0])}
    worst = max(((mine[n] - w).abs().max().item() / (abs_tol + rel * w.abs().max().item()), n)
                for n, w in grads.items())
    errs.update(grad_err_over_gate=worst[0], grad_worst=worst[1],
                grad_max_abs_err=max((mine[n] - w).abs().max().item() for n, w in grads.items()))
    if not (errs["loss_rel_err"] <= rel and worst[0] <= 1.0):
        raise AssertionError(f"{what}: the pipelined trunk differs from the one-process trunk: {errs}")
    if not got["losses"][1] < got["losses"][0]:
        raise AssertionError(f"{what}: the second step's loss {got['losses'][1]} is not below the first "
                             f"{got['losses'][0]}")
    return errs


def pipeline_phase(torch, tokenizer, smi):
    """GPipe over a `pipe` axis (`scoreperformer_tpu_torch.parallel.pipeline`)
    with the flagship decoder trunk at full width (dim 256, 4 units, 4
    heads of 64, one KV head, learned ALiBi, GLU-swish, AdaNorm style,
    `use_flash`) on its inputs at the train step's batch (128 x 257 causal
    positions): 2 adamw steps with ZeRO over `data` on JAX's dry-run loss
    (the final norm, then (h**2).sum()) at data 2 x pipe 2 (M 4) and data 2
    x pipe 2 x model 2 with sequence parallelism (the decoder's 257
    positions do not split over model 2: JAX's no-op rule, so the stack
    runs as without it), one launch of 8 ranks sharing the card over gloo
    (4 idle in the first run). Gates: the loss and every gradient (the
    trunk's, the final norm's, x's, the style rows') within 1e-4 relative
    (1e-5 absolute) of the one-process trunk on the card, the second
    step's loss below the first, and exactly 2 units x M = 8 launches of
    each flash kernel a step on every rank (bubble ticks are skipped).
    Then one more step with the collectives timed, the flash kernels at a
    microbatch's shape (b 16, h 4 and h 2, t 257 causal) against their
    plain versions, and `python -m scoreperformer_tpu_torch.parallel.dryrun
    --ranks 8` on the card (its four OK lines). Returns the phase's record."""
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.parallel.launch import launch
    from scoreperformer_tpu_torch.parallel.workers import pipeline_runs_worker, run_trunk_one_process

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    config, state, inputs = trunk_inputs(torch, tokenizer)
    lap("trunk_inputs")
    base = {"config": config, "state_dict": state, "x": inputs["x"], "mask": inputs["mask"],
            "style": inputs["style"], "microbatches": PIPE_MICROBATCHES, "steps": 2, "inputs_grad": True,
            "optimization": PIPE_OPTIMIZATION, "zero_sharding": True, "profile": True, "device": "cuda"}
    one = run_trunk_one_process(base, device="cuda")
    torch.cuda.empty_cache()
    lap("one_process")
    paths = []
    for name, mesh in PIPE_RUNS.items():
        paths.append(os.path.join(work, f"{name}.pt"))
        torch.save({**base, "mesh": mesh, "sequence_parallel": "model" in mesh}, paths[-1])
    ranks = max(int(np.prod(list(m.values()))) for m in PIPE_RUNS.values())
    got = launch(pipeline_runs_worker, ranks, (paths,), backend="gloo", device="cuda")
    lap("pipelined_runs")
    stages = 2
    bubble = (stages - 1) / (PIPE_MICROBATCHES + stages - 1)
    units = config.depth // stages
    want = {k: units * PIPE_MICROBATCHES for k in FLASH}
    rec = {"card": smi, "microbatches": PIPE_MICROBATCHES, "stages": stages, "bubble_share": bubble,
           "trunk": {"dim": config.dim, "depth": config.depth, "heads": config.heads,
                     "x": list(inputs["x"].shape), "style": list(inputs["style"].shape)},
           "one_process": {"losses": one["losses"], "step_ms": one["step_ms"], "peak_gb": one["peak_gb"]},
           "phase_s": phase_s, "runs": {}}
    for i, (name, mesh) in enumerate(PIPE_RUNS.items()):
        members = [r[i] for r in got if r[i] is not None]
        errs = trunk_gates(one, members[0], name)
        for r in members:
            if any(step != want for step in r["launches"]):
                raise AssertionError(f"{name} rank {r['rank']}: flash launches {r['launches']}, expected {want} "
                                     "a step")
        rec["runs"][name] = {
            "mesh": mesh, "ranks": len(members), **errs, "losses": members[0]["losses"],
            "step_ms": [r["step_ms"] for r in members], "peak_gb": [r["peak_gb"] for r in members],
            "profiled_step": [r["profiled_step"] for r in members], "launches_a_step": members[0]["launches"][0]}
        print(f"pipeline {name} ({smi}): bubble share {bubble:.3f} (S={stages}, M={PIPE_MICROBATCHES}); "
              + "; ".join(f"rank {r['rank']} {r['coords']}: step ms {[round(t, 1) for t in r['step_ms']]}, "
                          f"collective share {r['profiled_step']['collective_share']:.3f} of "
                          f"{r['profiled_step']['ms']:.1f} ms, peak {r['peak_gb']:.2f} GB" for r in members),
              flush=True)
    print(f"pipeline one process ({smi}): step ms {[round(t, 1) for t in one['step_ms']]}, "
          f"peak {one['peak_gb']:.2f} GB", flush=True)

    # ---- the kernels at a microbatch's shape (4 heads a stage; 2 a rank with model 2) ----
    rows = TRAIN_BATCH // 2 // PIPE_MICROBATCHES
    kernels = {"flash_attention_fwd": [check_flash(torch, fa, rows, TRAIN_SEQ + 1, True, False, False, h=h)
                                       for h in (4, 2)]}
    bwd = [check_flash_bwd(torch, fa, rows, TRAIN_SEQ + 1, True, False, False, h=h) for h in (4, 2)]
    kernels.update(flash_attention_bwd_dkv=[b[0] for b in bwd], flash_attention_bwd_dq=[b[1] for b in bwd])
    rec["kernels"] = kernels
    lap("kernels")

    # ---- the dry run's four parts, on the card ----
    out = subprocess.run([sys.executable, "-m", "scoreperformer_tpu_torch.parallel.dryrun", "--ranks", "8"],
                         capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    oks = [line for line in out.stdout.splitlines() if line.startswith("dryrun ") and " OK" in line]
    lap("dryrun")
    if out.returncode != 0 or len(oks) != 4:
        raise AssertionError(f"parallel.dryrun --ranks 8 failed (rc {out.returncode}):\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    for line in oks:
        print(f"{line} ({smi})", flush=True)
    rec["dryrun"] = {"ok_lines": oks, "s": phase_s["dryrun"]}
    return rec


# the head-shapes phase: the flagship with every stack at 6 heads of 48 over
# one KV head, a head dim the kernels are not built for (taken at the built
# width 64, zero-padded) and a head count that does not divide the dQ
# kernel's 64-row blocks (blocks of 64 positions of one head) and that
# `prefix_attend` pads to 8 query heads a launch; its greedy render held to
# the CPU on an 8-bar score; the kernels first at 6 and 12 heads over one KV
# head at the built width 64, then at head dims 8, 48 and 96, (heads, KV
# heads, t, causal, padded) a case; the phase's budget in seconds
# the precision phase: the one-pass kernels' checks on the card, (b, t,
# causal, padded, h, d, kv heads, lengths): the flagship's encoders and
# decoder (the first timed, fp32), recipes/smoke.yaml's d = 16 and
# scale_1024's decoder (d = 128) at their train shapes, and the edges (d =
# 32, rows with no valid key, one KV head per query head, t around the
# tiles, keys that start late); each in fp32 and bf16
PRECISION_CHECKS = [
    (TRAIN_BATCH, TRAIN_SEQ + 2, False, True, 4, 64, 1, None),
    (TRAIN_BATCH, TRAIN_SEQ + 1, True, True, 4, 64, 1, None),
    (4, 49, True, True, 2, 16, 1, None), (4, 50, False, True, 2, 16, 1, None),
    (8, 1025, True, True, 8, 128, 1, None), (8, 1026, False, True, 8, 128, 1, None),
    (3, 77, True, "empty", 4, 32, 1, None), (4, 130, False, True, 4, 64, 4, None),
    (2, 300, True, "empty", 4, 64, 4, None),
    (2, 1, False, False, 4, 64, 1, None), (2, 17, True, False, 4, 64, 1, None),
    (2, 65, False, False, 4, 64, 1, None), (2, 129, True, False, 4, 64, 1, None),
    (3, 200, True, "late", 4, 64, 1, [(70, 200), (5, 90), (130, 131)]),
]
PRECISION_TRAIN_STEPS = (2, 4)  # warm-up and timed steps at batch 128 under "medium"
# the one-pass kernels' batch-4 step against the plain flash functions on
# the card: the fp32 step's loss gate, 1e-4, and the gradients as one vector
# within one bf16 ulp, 2^-7, in relative L2. The fp32 step's gradient gate
# (1e-3 of each gradient's largest value) cannot hold here: one pass
# computes delta from the forward's rounded P and dS from the backward's
# unrounded one, so on a row whose P sits on one key dS is that rounding's
# residue, which one bf16 tie flipped on one side moves wholly. The learned
# ALiBi slopes' and the decoder's to_q/to_k gradients sum such rows: on the
# H100 (`chip_probe_precision.py::step_spread`) kernels and plain versions
# differ there by 0.207 of a gradient's largest value, two plain steps by
# 0.069 (the MMD subsample's atomics, 2.0e-5 at "highest"), and the
# kernels and plain versions at "highest" by 2.9e-4. Each gradient's error
# is recorded beside.
ONE_PASS_STEP_GATES = {"loss_err": 1e-4, "global_rel_l2": 2.0**-7}
ALIBI_SLOPES = "rel_pos.learned_logslopes"


def precision_phase(torch, tokenizer, root, score, model_config, host_batch, smi, fp32_conversions):
    """The flash attention's "default" precision as the TPU's one-pass
    numerics, on the card: under torch.set_float32_matmul_precision("medium")
    (restored to "highest" after)
    1. the one-pass kernels against their one-pass plain versions at
       PRECISION_CHECKS, fp32 and bf16 (`check_flash_one_pass`), the
       flagship's encoder shape timed;
    2. the flagship (use_flash) trained through `ExperimentComponents` and
       the `Trainer` on the train phase's dataset at `root`, batch 128 x 258:
       PRECISION_TRAIN_STEPS steps with 10 launches of each one-pass kernel
       a step, one more profiled (the GEMM kernels cuBLAS takes under
       "medium"; busy ms beside the fp32 step's), whose dtype conversions
       (`CONVERSION_KERNEL`) over the fp32 step's `fp32_conversions` (the
       train phase's profile) hold none of the wrappers' rounding copies
       (gated under CONVERSIONS_OVER_FP32_LIMIT);
    3. the 32-bar `score` rendered greedy: 6 one-pass forwards (the
       encoders), the chunked decode's launches, `check_performance`;
    4. a batch-4 step of `model_config` on the card against the same step
       with the plain flash functions in the one-pass mode (the same GEMMs
       on both sides, so the kernels alone differ), 10 launches of each
       one-pass kernel: loss within the fp32 step's 1e-4 and the gradients
       as one vector within one bf16 ulp (2^-7) in relative L2
       (`ONE_PASS_STEP_GATES`; each gradient's error recorded); the model held in bf16
       likewise, at the bf16 model's gates (loss 1e-2 relative, gradients
       5e-2 relative L2 as one vector);
    5. recorded, not gated: the "medium" step's loss and gradients against
       the "highest" step's on the card.
    Returns the phase's record."""
    from scoreperformer_tpu_torch.inference import prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa
    from scoreperformer_tpu_torch.training import ExperimentComponents

    phase_s, last = {}, [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        phase_s[step] = now - last[0]
        last[0] = now

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_precision")
    shutil.rmtree(work, ignore_errors=True)
    rec = {"card": smi, "phase_s": phase_s}
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        if not fa.precision_is_one_pass("default"):
            raise AssertionError("\"default\" under \"medium\" does not take the one-pass route")
        # 1. the kernels
        checks = [check_flash_one_pass(torch, fa, b, t, c, p, timed=i == 0 and dt == "fp32", h=h, d=d, hk=hk,
                                       dtype=dt, lengths=lengths)
                  for i, (b, t, c, p, h, d, hk, lengths) in enumerate(PRECISION_CHECKS) for dt in ("fp32", "bf16")]
        for recs in checks:
            for name, r in zip(FLASH, recs):
                print(f"{name}_one_pass", json.dumps(r))
        rec["main"] = checks[0]
        rec["checks"] = len(checks)
        rec["worst_over_bound"] = max(max(r["err_over_bound"].values()) for recs in checks for r in recs)
        lap("kernels")

        # 2. train steps under "medium"
        comp = ExperimentComponents(train_config(tokenizer, root, os.path.join(work, "run"), TRAIN_BATCH, 2),
                                    device="cuda").init_components()
        trainer = comp.trainer
        trainer._prepare()
        torch.cuda.reset_peak_memory_stats()
        step_ms, launches, batch, notes, values = train_steps(torch, fa, kv, pa, trainer, comp.train_dataset,
                                                              *PRECISION_TRAIN_STEPS, dtype="one_pass")
        rec["train"] = {**train_record(torch, step_ms, notes, launches), "last_loss": values["loss"]}
        prof = profile_device(torch, lambda: trainer.train_step(batch, sum(PRECISION_TRAIN_STEPS)),
                              ported=PORTED_TRAIN, top=16, counted=(CONVERSION_KERNEL,))
        kernels = {k for n in PORTED_TRAIN for k in prof["ported"][n]["kernels"]}
        if {k: prof["ported"][k]["count"] for k in PORTED_TRAIN} != {k: 10 for k in PORTED_TRAIN} or not all(
                one_pass_instance(k) for k in kernels):
            raise AssertionError(f"the profiled step under \"medium\" ran the flash kernels {prof['ported']}")
        rec["train"]["profile"] = prof
        # no wrapper copies: the count within a few of the fp32 step's
        # (CONVERSIONS_OVER_FP32_LIMIT)
        conversions = prof["counted"][CONVERSION_KERNEL]["count"]
        limit = CONVERSIONS_OVER_FP32_LIMIT
        rec["train"]["conversions"] = {"medium": conversions, "fp32_step": fp32_conversions,
                                       "limit_over_fp32": limit}
        if conversions - fp32_conversions >= limit:
            raise AssertionError(f"the profiled step under \"medium\" ran {conversions} dtype conversions, the fp32 "
                                 f"step {fp32_conversions}: the wrappers' rounding copies are back (limit +{limit})")
        print(f"precision: train steps under \"medium\" ({smi})", json.dumps(rec["train"]))
        del comp, trainer, batch
        torch.cuda.empty_cache()
        lap("train_steps")

        # 3. the render
        inputs = prepare_render_inputs(tokenizer, score)
        n_steps = -(-(len(inputs["deadpan_ids"]) - 1) // CHUNK) * CHUNK
        model, _ = build_scoreperformer(flagship_config(tokenizer, len(inputs["deadpan_ids"])), device="cuda",
                                        seed=SEED)
        model.eval()
        reset_counts(fa, kv, pa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perf = render_performance(model, tokenizer, score, seed=SEED, device="cuda", greedy=True)
        torch.cuda.synchronize()
        rec["render"] = {"bars": N_BARS, "notes": perf.num_notes, "wall_s": time.perf_counter() - t0,
                         "launches": all_counts(fa, kv, pa)}
        check_launches("the render under \"medium\"", rec["render"]["launches"],
                       {**decode_launches(n_steps, flash=0), "flash_attention_fwd_one_pass": 2 + 4})
        check_performance(tokenizer, inputs["score_ids"], perf, "the render under \"medium\"")
        print(f"precision: render under \"medium\" ({smi})", json.dumps(rec["render"]))
        del model
        torch.cuda.empty_cache()
        lap("render")

        # 4. batch-4 steps, the kernels against the plain flash functions on the card
        for name, dtype, gates in (("fp32", "fp32", ONE_PASS_STEP_GATES),
                                   ("bf16_model", "bf16", {"loss_rel": 1e-2, "global_rel_l2": 5e-2})):
            reset_counts(fa, kv, pa)
            gate = compare_train_step(torch, model_config, host_batch, devices=("cuda", "cuda"), precision=dtype,
                                      reference_plain_flash=True, by_name=True)
            errs = gate.pop("grad_errs")
            gate["slope_grad_errs"] = {n: e for n, e in errs.items() if n.endswith(ALIBI_SLOPES)}
            gate["grad_err_but_slopes"] = max(e for n, e in errs.items() if not n.endswith(ALIBI_SLOPES))
            gate["largest_grad_errs"] = dict(sorted(errs.items(), key=lambda x: -x[1])[:8])
            launches = all_counts(fa, kv, pa)
            rec[f"{name}_step_vs_plain"] = {**gate, "launches": launches}
            print(f"precision: batch-4 step ({name}) under \"medium\", kernels vs plain on the card",
                  json.dumps(rec[f"{name}_step_vs_plain"]))
            check_launches(f"the batch-4 {name} step under \"medium\"", launches,
                           {k: 10 if k in {f + "_one_pass" for f in FLASH} else 0 for k in launches})
            if not all(gate[k] <= tol for k, tol in gates.items()):
                raise AssertionError(f"the one-pass kernels' {name} step differs from the plain versions': {gate}")
        lap("steps_vs_plain")

        # 5. recorded: "medium" against "highest", both on the card
        gate = compare_train_step(torch, model_config, host_batch, devices=("cuda", "cuda"),
                                  reference_matmul="highest", by_name=True)
        rec["medium_vs_highest"] = {k: gate[k] for k in ("loss_rel", "grad_err", "grad_rel_l2", "worst",
                                                          "global_rel_l2", "gradients")}
        rec["medium_vs_highest"]["slope_grad_errs"] = {n: e for n, e in gate["grad_errs"].items()
                                                       if n.endswith(ALIBI_SLOPES)}
        print("precision: batch-4 step under \"medium\" against \"highest\" (recorded, not gated)",
              json.dumps(rec["medium_vs_highest"]))
        lap("medium_vs_highest")
    finally:
        torch.set_float32_matmul_precision(saved)
    shutil.rmtree(work, ignore_errors=True)
    return rec


def one_pass_instance(kernel):
    """Whether a profiled flash kernel's name is a one-pass instance (P or
    dS one bf16 term): `flash_fwd_bf16<64, 1, float>` and the like."""
    return re.search(r"_bf16<\d+, 1,", kernel) is not None


HEAD_SHAPES_MODEL = (6, 48)
HEAD_SHAPES_BUDGET_S = 60.0
HEAD_SHAPES_GATE_BARS = 8
HEAD_SHAPES_BUILT = [(h, 1, t, c, p) for h in (6, 12) for t, c, p in ((65, True, True), (129, False, "empty"))]
HEAD_SHAPES_PADDED = [(6, 1, 77, True, True), (12, 1, 37, False, "empty"), (3, 3, 129, True, "empty")]


def with_heads(model_config, heads, dim_head):
    """A copy of a ScorePerformer config with every stack at `heads` heads of
    `dim_head`."""
    import copy

    cfg = copy.deepcopy(model_config)
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        stack = cfg[key]["transformer"]
        stack["heads"] = heads
        stack["attention"] = {**stack["attention"], "dim_head": dim_head}
    return cfg


def head_shapes_gate(refs, tokenizer, score):
    """The head-shapes phase's flagship config (6 heads of 48 over one KV
    head), its greedy gate's render inputs (an 8-bar score) and the worker's
    job computing the CPU path's tokens on them, submitted ahead of the
    phase so that the card need not wait for it."""
    from scoreperformer_tpu_torch.data import synthetic_score
    from scoreperformer_tpu_torch.inference import prepare_render_inputs

    heads, dim_head = HEAD_SHAPES_MODEL
    T = len(prepare_render_inputs(tokenizer, score)["deadpan_ids"])
    cfg = flagship_config(tokenizer, T, heads=heads, dim_head=dim_head)
    inputs = prepare_render_inputs(tokenizer, synthetic_score(np.random.RandomState(SEED + 3),
                                                              n_bars=HEAD_SHAPES_GATE_BARS))
    return cfg, inputs, refs.submit(cpu_greedy_from_config, cfg, inputs, phase="head_shapes")


def head_shapes_phase(torch, tokenizer, score, model_config, host_batch, scores, inputs, work, refs, gate):
    """Head shapes the kernels are not built for, on the card: the three flash
    kernels (fp32 and bf16) and `prefix_attend` (fp32, bf16, int8) held to
    their plain versions on the unpadded inputs within their gates, first at
    6 and 12 heads over one KV head at a built width, then at head dims 8,
    48 and 96; then the flagship at 6 heads of 48 over one KV head in every
    stack: greedy tokens on the card equal to the CPU path's on an 8-bar
    score (`gate`: the config, the inputs and the job of `refs`' worker that
    `head_shapes_gate` submitted), the 32-bar `score` rendered on the card alone, the first
    SMOKE_REQUESTS `scores` (with their render `inputs`) served greedy
    through `handle_batch` from a port checkpoint under `work`, and a
    batch-4 train step of `model_config` at this head shape (the first
    sequences of `host_batch`) against the CPU's, each with its launches
    counted. Returns the phase's record, its seconds in `phase_s`."""
    from scoreperformer_tpu_torch.inference import RenderServer, prepare_render_inputs, render_performance
    from scoreperformer_tpu_torch.midi import read_midi, write_midi
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.ops import flash_attention as fa
    from scoreperformer_tpu_torch.ops import kv_cache as kv
    from scoreperformer_tpu_torch.ops import prefix_attend as pa

    t_phase = time.perf_counter()
    heads, dim_head = HEAD_SHAPES_MODEL
    rec = {"model": {"heads": heads, "dim_head": dim_head, "kv_heads": 1,
                     "kernel_width": fa.kernel_head_dim(dim_head)}}

    # the kernels, at the built width first, then at padded ones
    t0 = time.perf_counter()
    cases = [(h, 64, hk, t, c, p) for h, hk, t, c, p in HEAD_SHAPES_BUILT] + [
        (h, d, hk, t, c, p) for d in (8, 48, 96) for h, hk, t, c, p in HEAD_SHAPES_PADDED]
    kernels = []
    for h, d, hk, t, causal, padded in cases:
        fwd = check_flash(torch, fa, 2, t, causal=causal, padded=padded, timed=False, h=h, d=d, hk=hk)
        dkv, dq, _ = check_flash_bwd(torch, fa, 2, t, causal=causal, padded=padded, timed=False, h=h, d=d, hk=hk)
        bf16 = check_flash_bf16(torch, fa, 2, t, causal=causal, padded=padded, timed=False, h=h, d=d, hk=hk)
        kernels.append({"shape": fwd["shape"], "kv_heads": hk, "causal": causal, "padded": padded,
                        "fp32_err": {"fwd": fwd["max_abs_err"], "dkv": dkv["max_abs_err"], "dq": dq["max_abs_err"]},
                        "bf16_err": {name: r["max_abs_err"] for name, r in zip(("fwd", "dkv", "dq"), bf16)}})
    prefix = [check_prefix_attend(torch, pa, 5, 100, base, timed=False, dtype=dt, h=h, d=d, kvh=kvh)
              for d in (48, 96) for (h, kvh), base in zip(((3, 1), (6, 1), (12, 1), (12, 12)), (77, 100, 0, 33))
              for dt in ("fp32", "bf16", "int8")]
    rec["kernels"] = {"flash": kernels, "prefix_attend": prefix, "s": time.perf_counter() - t0}
    print(f"head shapes: {len(cases)} flash shapes (fp32 and bf16, both passes) and {len(prefix)} prefix_attend "
          f"cases at their plain versions in {rec['kernels']['s']:.1f} s")

    # the flagship at 6 heads of 48: greedy tokens on the card and the CPU
    # (the worker's, `head_shapes_gate`)
    cfg, gate_inputs, cpu_job = gate
    T = len(prepare_render_inputs(tokenizer, score)["deadpan_ids"])
    models = {"cuda": build_scoreperformer(cfg, device="cuda", seed=SEED)[0].eval()}
    t0 = time.perf_counter()
    same = torch.equal(greedy_tokens(torch, models["cuda"], gate_inputs, "cuda"),
                       torch.as_tensor(refs.result(cpu_job)))
    rec["greedy_gate"] = {"bars": HEAD_SHAPES_GATE_BARS, "identical_to_cpu": same, "s": time.perf_counter() - t0}
    print(f"head shapes: {HEAD_SHAPES_GATE_BARS}-bar greedy render tokens, card vs CPU: identical={same}")
    if not same:
        raise AssertionError("the flagship at 6 heads of 48: greedy tokens on the card differ from the CPU path's")

    # the 32-bar score on the card alone
    n_steps = -(-(T - 1) // CHUNK) * CHUNK
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perf = render_performance(models["cuda"], tokenizer, score, seed=SEED, device="cuda", greedy=True)
    torch.cuda.synchronize()
    rec["render"] = {"bars": N_BARS, "notes": perf.num_notes, "wall_s": time.perf_counter() - t0,
                     "launches": all_counts(fa, kv, pa)}
    check_launches("the render at 6 heads of 48", rec["render"]["launches"], decode_launches(n_steps))
    check_performance(tokenizer, prepare_render_inputs(tokenizer, score)["score_ids"], perf,
                      "the render at 6 heads of 48")
    del models

    # a served batch from a port checkpoint
    ckpt = save_port_checkpoint(tokenizer, flagship_config(tokenizer, SERVE_BUCKET, heads=heads, dim_head=dim_head),
                                work)
    server = RenderServer(ckpt, bucket=128, chunk_size=CHUNK, device="cuda")
    reqs = [{"id": i, "score_b64": base64.b64encode(write_midi(sc, None)).decode("ascii"), "greedy": True}
            for i, sc in enumerate(scores[:SMOKE_REQUESTS])]
    reset_counts(fa, kv, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resps = server.handle_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_counts(fa, kv, pa)
    bad = [r for r in resps if not r.get("ok")]
    if bad:
        raise AssertionError(f"the served batch at 6 heads of 48: {len(bad)} responses not ok, first {bad[0]}")
    check_launches("the served batch at 6 heads of 48", launches,
                   decode_launches(-(-(SERVE_BUCKET - 1) // CHUNK) * CHUNK))
    for i, r in enumerate(resps):
        check_performance(tokenizer, inputs[i]["score_ids"], read_midi(base64.b64decode(r["midi_b64"])),
                          f"served request {i} at 6 heads of 48")
    rec["served"] = {"requests": len(reqs), "wall_s": wall, "notes": sum(r["notes"] for r in resps),
                     "launches": launches}
    del server
    shutil.rmtree(work, ignore_errors=True)

    # a batch-4 train step on the card against the CPU's
    reset_counts(fa, kv, pa)
    t0 = time.perf_counter()
    gate = compare_train_step(torch, with_heads(model_config, heads, dim_head), host_batch)
    launches = all_counts(fa, kv, pa)
    rec["train_step"] = {**gate, "launches": launches, "s": time.perf_counter() - t0}
    print(f"head shapes: train step at batch 4, card vs CPU: loss error {gate['loss_err']:.3g}, largest gradient "
          f"error over its largest value {gate['grad_err']:.3g} ({gate['gradients']} gradients)")
    if not (gate["loss_err"] <= 1e-4 and gate["grad_err"] <= 1e-3):
        raise AssertionError(f"the train step at 6 heads of 48 differs from the CPU's: {gate}")
    check_launches("the train step at 6 heads of 48", launches,
                   {k: 10 if k in FLASH else 0 for k in launches})
    rec["phase_s"] = time.perf_counter() - t_phase
    if rec["phase_s"] > HEAD_SHAPES_BUDGET_S:
        print(f"head shapes phase: {rec['phase_s']:.1f} s, over its budget of {HEAD_SHAPES_BUDGET_S:.0f} s")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    refs = CpuReferences()
    try:
        return smoke(torch, refs, t_script)
    finally:
        refs.close()


def smoke(torch, refs, t_script) -> int:
    """Every phase in turn, the CPU references that need no result of the
    card computed by `refs`' worker beside them."""
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
    begin_phase("build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {sorted(str(p) for p in libs.values())}")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "C7518" in line:
                print(f"ptxas {path.stem}: {line.strip()}")
    # the six libraries' SASS, read at once (a cuobjdump each): the fp32
    # forward's library holds only the fp32 flash_fwd instances; the one-pass
    # instances (P and dS one bf16 term) hold bf16 HGMMA and no TF32
    # instruction of any kind
    sass_checks = (
        ("flash_attention_fwd", ("flash_fwd",), TF32_HGMMA, TF32_HMMA),
        ("flash_attention_bwd", ("flash_bwd_dkv", "flash_bwd_dq"), TF32_HGMMA, TF32_HMMA),
        ("flash_attention_fwd_bf16", ("flash_fwd_bf16",), BF16_HGMMA, TF32_HMMA),
        ("flash_attention_bwd_bf16", ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"), BF16_HGMMA, TF32_HMMA),
        ("flash_attention_fwd_one_pass", ("flash_fwd_bf16",), BF16_HGMMA, ("TF32",)),
        ("flash_attention_bwd_one_pass", ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"), BF16_HGMMA, ("TF32",)))
    with concurrent.futures.ThreadPoolExecutor(len(sass_checks)) as pool:
        ((fwd_gmma, fwd_gmma_dims), (tf32_gmma, tf32_gmma_dims), (hgmma, hgmma_dims), (hgmma_bwd, hgmma_bwd_dims),
         (one_pass_gmma, one_pass_gmma_dims), (one_pass_bwd, one_pass_bwd_dims)) = pool.map(
            lambda c: tensor_core_counts(libs[c[0]], c[1], fa.KERNEL_HEAD_DIMS, instruction=c[2], forbidden=c[3]),
            sass_checks)
    hgmma.update(hgmma_bwd)
    hgmma_dims.update(hgmma_bwd_dims)
    one_pass_gmma.update(one_pass_bwd)
    one_pass_gmma_dims.update(one_pass_bwd_dims)
    print(f"bf16 warpgroup instructions (HGMMA) in the one-pass instances' SASS, and no TF32 instruction, by "
          f"kernel: {json.dumps(one_pass_gmma)}; by kernel and head dim: {json.dumps(one_pass_gmma_dims)}")
    # the one-pass forward by head dim and operand dtype: ptxas's registers,
    # spills and static shared memory, and the dynamic shared memory of a
    # launch at the flagship's t (258) and scale_1024's (1026); no spill and
    # no serialized wgmma (C7518), with the rounding of its operands in it
    one_pass_log = libs["flash_attention_fwd_one_pass"].with_suffix(".log").read_text()
    one_pass_ptxas = ptxas_entries(one_pass_log, "flash_fwd_bf16")
    for entry in one_pass_ptxas:
        entry["operands"] = "fp32" if re.search(r"flash_fwd_bf16ILi\d+ELi1EffE", entry["function"]) else "bf16"
        entry["dynamic_smem"] = {t: one_pass_fwd_smem(entry["d"], entry["operands"], t) for t in (258, 1026)}
        print("ptxas flash_fwd_bf16 one-pass by head dim",
              json.dumps({k: v for k, v in entry.items() if k not in ("function", "warpgroups")}))
    if len(one_pass_ptxas) != 2 * len(fa.KERNEL_HEAD_DIMS) or any(e.get("spill_stores") for e in one_pass_ptxas) \
            or "C7518" in one_pass_log:
        raise AssertionError("ptxas spilled registers in the one-pass forward, serialized its wgmmas (C7518), or "
                             f"built {len(one_pass_ptxas)} instances")
    print(f"TF32 warpgroup instructions (HGMMA) in the fp32 forward's SASS, and no TF32 HMMA, by kernel: "
          f"{json.dumps(fwd_gmma)}; by kernel and head dim: {json.dumps(fwd_gmma_dims)}")
    print(f"TF32 warpgroup instructions (HGMMA) in the fp32 backward's SASS, and no TF32 HMMA, by kernel: "
          f"{json.dumps(tf32_gmma)}; by kernel and head dim: {json.dumps(tf32_gmma_dims)}")
    # the fp32 forward by head dim: ptxas's registers, spills and static
    # shared memory, and the dynamic shared memory of a launch at the
    # flagship's t (258) and scale_1024's (1026)
    fwd_ptxas = ptxas_entries(libs["flash_attention_fwd"].with_suffix(".log").read_text(), "flash_fwd")
    for entry in fwd_ptxas:
        entry["dynamic_smem"] = {t: fp32_fwd_smem(entry["d"], entry["warpgroups"], t) for t in (258, 1026)}
        print("ptxas flash_fwd by head dim", json.dumps({k: v for k, v in entry.items() if k != "function"}))
    if any(e.get("spill_stores") for e in fwd_ptxas) or "C7518" in libs["flash_attention_fwd"].with_suffix(".log").read_text():
        raise AssertionError("ptxas spilled registers in the fp32 forward, or serialized its wgmmas (C7518)")
    print(f"bf16 warpgroup instructions (HGMMA) in the bf16 forward's and backward's SASS, and no TF32 HMMA, "
          f"by kernel: {json.dumps(hgmma)}; by kernel and head dim: {json.dumps(hgmma_dims)}")
    print(f"build and SASS checks: {time.perf_counter() - t0:.1f} s")
    end_phase("build")

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
    begin_phase("kernels")
    t_kernels = time.perf_counter()
    # write_kv and write_kv_pair (every case both ways, timed at the
    # render's step, the served batch's step and a 2 MB write): the render's
    # fresh buffers; the served batch's, fp32 rows into fp32 (fp32 and int8
    # caches) or bf16 ones, at slots inside the chunk and clamped; the
    # scale_1024 served batch's (32 rows of 128); a cast into bf16; rows of a
    # length that is no multiple of 16 bytes (one element a unit)
    kv_cases = [(CHUNK, 1, 1, 64, idx, dt, idx == 5 and dt == torch.float32)
                for idx in (0, 5, CHUNK - 1, CHUNK + 3, -1) for dt in (torch.float32, torch.bfloat16)] + [
        (CHUNK, 1, SERVE_REQUESTS, 64, idx, dt, False)
        for idx in (0, 5, CHUNK - 1, CHUNK + 3, -1) for dt in (torch.float32, torch.bfloat16)] + [
        (CHUNK, 1, SCALE_REQUESTS, 128, 7, torch.float32, False), (CHUNK, 1, SCALE_REQUESTS, 128, -1, torch.bfloat16, False),
        (272, 16, 512, 64, 100, torch.float32, False), (272, 16, 512, 64, 300, torch.float32, False),
        (272, 16, 512, 64, 40, torch.bfloat16, False), (T, 1, 1, 64, T + 7, torch.float32, False),
        (10, 2, 3, 5, -3, torch.float32, False), (10, 2, 3, 5, 4, torch.bfloat16, False),
    ]
    kv_recs = [check_write_kv(torch, kv, cap, n, b, dim, idx, dt, timed, pair)
               for pair in (False, True) for cap, n, b, dim, idx, dt, timed in kv_cases]
    kv_main, pair_main = (next(r for r in kv_recs if r["name"] == name and "ms" in r)
                          for name in ("write_kv", "write_kv_pair"))
    fa_main = check_flash(torch, fa, 1, T, causal=False, padded=False, timed=True)
    fa_recs = [
        check_flash(torch, fa, 32, 258, causal=c, padded=p, timed=False)
        for c in (False, True) for p in (False, True)
    ] + [
        check_flash(torch, fa, 2, 77, causal=True, padded=True, timed=False, d=32),
        # rows with no valid key: v averaged over the JAX wrapper's padded keys
        check_flash(torch, fa, 2, 37, causal=False, padded="empty", timed=False),
        check_flash(torch, fa, 2, 300, causal=True, padded="empty", timed=False),
        # the training step's shapes: 6 encoder layers, then 4 causal decoder layers
        check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=True, timed=False),
        check_flash(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded=True, timed=False),
        # the served encoders: the served batch's valid lengths; a batch of
        # 112 padded to 128 with rows at valid_len 1; the warmup's batch
        check_flash(torch, fa, SERVE_REQUESTS, SERVE_BUCKET, causal=False, padded="served", timed=False,
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
    bwd_causal = check_flash_bwd(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded=True, timed=False)
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
    print("flash_attention_bwd_pair", json.dumps(bwd_main[2]))
    # the bf16 instances of the three flash kernels (a model held in bf16
    # feeds them): at the training step's shapes, timed, and at the edges
    # (d=32, whose scale is no power of two, one KV head per query head,
    # rows with no valid key, t around the tiles)
    bf16_main = check_flash_bf16(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 2, causal=False, padded=True, timed=True)
    bf16_causal = check_flash_bf16(torch, fa, TRAIN_BATCH, TRAIN_SEQ + 1, causal=True, padded=True, timed=False)
    bf16_recs = [
        check_flash_bf16(torch, fa, 3, 77, causal=True, padded="empty", timed=False, d=32),
        check_flash_bf16(torch, fa, 2, 77, causal=False, padded=True, timed=False, d=32),
        check_flash_bf16(torch, fa, 4, 130, causal=False, padded=True, timed=False, hk=4),
        check_flash_bf16(torch, fa, 2, 300, causal=True, padded="empty", timed=False, hk=4),
    ] + [
        check_flash_bf16(torch, fa, 2, t, causal=c, padded=False, timed=False)
        for t in (15, 17, 63, 65, 129) for c in (False, True)
    ]
    for recs in [bf16_main, bf16_causal] + bf16_recs:
        for name, rec in zip(FLASH, recs):
            print(f"{name}_bf16", json.dumps(rec))
    # the three flash kernels at head dims 128 and 16, fp32 and bf16: the
    # edges, then the scale regime's and the smoke-shaped paths' shapes
    # (timed by chip_probe_recipe_shapes.py)
    t0 = time.perf_counter()
    head_dims = check_flash_head_dims(torch, fa, timed=False)
    for rec in head_dims["fwd"]:
        print("flash_attention_fwd, head dims 16 and 128", json.dumps(rec))
    for dkv_rec, dq_rec, _ in head_dims["bwd"]:
        print("flash_attention_bwd_dkv, head dims 16 and 128", json.dumps(dkv_rec))
        print("flash_attention_bwd_dq, head dims 16 and 128", json.dumps(dq_rec))
    for recs in head_dims["bf16"]:
        for name, rec in zip(FLASH, recs):
            print(f"{name}_bf16, head dims 16 and 128", json.dumps(rec))
    for rec in head_dims["timed"]:
        print("flash kernels at a new path's shape", json.dumps(rec))
    print(f"flash kernels at head dims 16 and 128: {time.perf_counter() - t0:.1f} s")
    # the prefix attend of the chunked decode: the served batch (timed in
    # fp32, bf16 and int8, halfway through its decode), the TPU script's
    # shape, the render's (b=1, the 32-bar score's cache), and the edges:
    # the first chunk (base 0, no slot read), the last, d=32, one KV head
    # per query head
    cap_render = max(n_steps, T)
    pa_main = check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, timed=True)
    pa_recs = [
        check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, timed=False, dtype=dt)
        for dt in ("bf16", "int8")
    ] + [
        check_prefix_attend(torch, pa, 512, 256, 256 - CHUNK, timed=False),
        check_prefix_attend(torch, pa, 1, cap_render, cap_render // 2, timed=False),
    ] + [
        check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dt)
        for b, cap in ((512, 256), (1, cap_render), (SERVE_REQUESTS, SERVE_BUCKET))
        for base in (0, CHUNK, 128, cap - CHUNK) for dt in ("fp32", "bf16", "int8")
    ] + [
        check_prefix_attend(torch, pa, 3, 100, 77, timed=False, dtype=dt, d=32) for dt in ("fp32", "int8")
    ] + [
        check_prefix_attend(torch, pa, 5, 100, base, timed=False, dtype=dt, kvh=4)
        for base in (0, 60) for dt in ("fp32", "bf16", "int8")
    ] + [
        # around the tiles: a base below one tile, one that no tile divides,
        # n_valid = cap (every slot), splits of uneven tile counts
        check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, base, timed=False, dtype=dt)
        for base in (5, 100, SERVE_BUCKET) for dt in ("fp32", "bf16", "int8")
    ] + [
        check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dt, h=h, d=d, kvh=kvh)
        for b, cap, base, h, d, kvh, dt in ((7, 300, 300, 2, 16, 1, "bf16"), (3, 300, 299, 2, 16, 2, "int8"),
                                            (2, 1000, 999, 4, 32, 1, "fp32"), (9, 200, 161, 8, 64, 8, "bf16"))
    ]
    # the recipes' other decoder head dims, one KV head: recipes/smoke.yaml's
    # 2 heads of 16 at the served shape; scale_1024's 8 heads of 128 over a
    # cache of 1024, in fp32 and in int8 (its served caches; timed by
    # chip_probe_recipe_shapes.py); bases from the first chunk to the last
    pa_dims = [
        check_prefix_attend(torch, pa, SERVE_REQUESTS, SERVE_BUCKET, SERVE_BUCKET // 2, timed=False, h=2, d=16),
        check_prefix_attend(torch, pa, 64, 1024, 512, timed=False, h=8, d=128),
        check_prefix_attend(torch, pa, 64, 1024, 512, timed=False, dtype="int8", h=8, d=128),
    ] + [
        check_prefix_attend(torch, pa, b, cap, base, timed=False, dtype=dt, h=h, d=d)
        for b, cap, h, d in ((SERVE_REQUESTS, SERVE_BUCKET, 2, 16), (64, 1024, 8, 128))
        for base in (0, CHUNK, cap // 2, cap - CHUNK) for dt in ("fp32", "bf16", "int8")
    ] + [
        # scale_1024's decoder at b = 1 (16-block clusters in fp32) and with
        # bases that no tile divides, n_valid = cap
        check_prefix_attend(torch, pa, b, 1024, base, timed=False, dtype=dt, h=8, d=128)
        for b, base in ((1, 1024), (1, 517), (3, 517), (64, 1024)) for dt in ("fp32", "bf16", "int8")
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
    print(f"kernel checks: {time.perf_counter() - t_kernels:.1f} s")
    end_phase("kernels")

    # ---- the main path: the flagship renders the score on the card ----
    begin_phase("flagship")
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
    prof = profile_decode(torch, lambda: render_performance(model, tokenizer, score, seed=SEED,
                                                            device="cuda", greedy=True),
                          "the render's profile", decode_launches(n_steps))
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
                                ported=PORTED_TRAIN, counted=(CONVERSION_KERNEL,))
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
    with cpu_ref():
        cpu_model, _ = build_scoreperformer(cfg, device="cpu", seed=SEED)
        cpu_model.eval()
    with torch.inference_mode():
        args = [inputs[k] for k in ("deadpan_ids", "score_ids", "bars", "beats", "onsets")]
        def enc(m, dev):
            x = [torch.as_tensor(np.asarray(a)[None], dtype=torch.int64, device=dev) for a in args]
            mask = torch.ones(1, T, dtype=torch.bool, device=dev)
            return m.encode_embeddings(x[0], mask, x[1], mask, *x[2:])
        gpu_emb = enc(model, "cuda")
        with cpu_ref():
            cpu_emb = enc(cpu_model, "cpu")
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
    gate = compare_train_step(torch, model_config, host_batch)
    loss_err, grad_err, n_grads = gate["loss_err"], gate["grad_err"], gate["gradients"]
    print(f"train step at batch 4, card vs CPU: loss error {loss_err:.3g}, largest gradient error over "
          f"its largest value {grad_err:.3g} ({n_grads} gradients)")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3):
        raise AssertionError(f"the card's train step differs from the CPU's: loss {loss_err}, gradients {grad_err}")
    del model, cpu_model
    torch.cuda.empty_cache()
    end_phase("flagship")

    # ---- the trainer's options: bf16_compute and a bf16 model, remat, scale_1024, lamb/lion/adafactor ----
    begin_phase("options")
    t0 = time.perf_counter()
    options = options_phase(torch, tokenizer, root, os.path.join(work, "options"))
    print(f"options phase: {time.perf_counter() - t0:.1f} s")
    end_phase("options")
    print("options", json.dumps({k: v for k, v in options.items() if k not in ("bf16_compute", "bf16_model")}))

    # ---- the paper's recipe: MIDI and MusicXML prepared, direction classifiers trained ----
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    begin_phase("paper")
    t0 = time.perf_counter()
    paper = paper_phase(torch, tokenizer, os.path.join(build, "chip_smoke_paper"))
    print(f"paper recipe phase: {time.perf_counter() - t0:.1f} s")
    end_phase("paper")
    print("paper recipe", json.dumps({k: v for k, v in paper.items() if k != "profile"}))
    if paper["train"]["launches"]["prefix_attend"] or paper["train"]["launches"]["write_kv_pair"]:
        raise AssertionError(f"the paper recipe's train steps launched decode kernels: {paper['train']['launches']}")

    # ---- the serving path: a RenderServer on a port checkpoint serves 128 requests ----
    begin_phase("serving")
    t0 = time.perf_counter()
    served = serve_phase(torch, tokenizer, flagship_config(tokenizer, SERVE_BUCKET),
                         os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_serve"),
                         serve_scores, serve_inputs)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s")
    end_phase("serving")
    served_launches = served["greedy"]["launches"]

    # ---- the recipes' other decoder head dims: smoke.yaml's d = 16, scale_1024's d = 128 ----
    begin_phase("smoke")
    t0 = time.perf_counter()
    smoke = smoke_phase(torch, tokenizer, os.path.join(build, "chip_smoke_smoke"), serve_scores, serve_inputs, root)
    print(f"smoke-shaped phase: {time.perf_counter() - t0:.1f} s")
    end_phase("smoke")
    begin_phase("scale_1024")
    t0 = time.perf_counter()
    scale = scale_1024_phase(torch, tokenizer, os.path.join(build, "chip_smoke_scale_1024"), serve_scores,
                             serve_inputs, refs)
    shutil.rmtree(os.path.join(build, "chip_smoke_scale_1024"), ignore_errors=True)  # a 1.1 GB checkpoint
    print(f"scale_1024 phase: {time.perf_counter() - t0:.1f} s")
    end_phase("scale_1024")
    print("scale_1024 served", json.dumps({k: v for k, v in scale.items() if k != "profile"}))

    # ---- the scale regime with the flash kernels: train at 1024 and 2048 notes, bf16 ----
    begin_phase("scale_flash")
    t0 = time.perf_counter()
    scale_flash = scale_flash_phase(torch, tokenizer, os.path.join(build, "chip_smoke_scale_flash"), smi)
    print(f"scale flash phase: {time.perf_counter() - t0:.1f} s")
    end_phase("scale_flash")
    print("scale flash", json.dumps({k: v for k, v in scale_flash.items() if k not in ("seq_1024", "seq_2048")}))

    # ---- streaming: the generator window by window, flagship and scale_1024 ----
    begin_phase("streaming")
    t0 = time.perf_counter()
    stream_root = os.path.join(build, "chip_smoke_stream")
    stream_data = streaming_dataset(stream_root)
    stream_flag = streaming_phase(torch, *stream_data, flagship_config(tokenizer, STREAM_SEQ), "flagship",
                                  STREAM_WINDOWS, STREAM_GATE_WINDOWS, STREAM_GATE_CTX, STREAM_GATE_WINDOW, 2 + 4,
                                  smi, refs, stream_root, sampled_parity=True)
    stream_scale = streaming_phase(torch, *stream_data, scale_1024_config(tokenizer), "scale_1024",
                                   STREAM_SCALE_WINDOWS, STREAM_SCALE_GATE_WINDOWS, STREAM_CTX, STREAM_WINDOW, 0,
                                   smi, refs, stream_root, gate_softmax_bf16_off=True)
    # the kernels at the streaming shapes: the decoder's row writes of each
    # consume chunk (128, 64, 8, 1 rows) and decode step into the 256-row
    # cache, at the flagship's kv width (64) and scale_1024's (128), one
    # start clamped; the flash forward at each encoder chunk's shape (b=1,
    # non-causal, its valid keys), the first timed
    stream_kv = [check_write_kv(torch, kv, STREAM_CTX, n, 1, d, idx, torch.float32, False, pair=True)
                 for d in (64, 128) for n, idx in ((128, 0), (64, 128), (8, 192), (1, 250))] + [
        check_write_kv(torch, kv, STREAM_CTX, 8, 1, 64, STREAM_CTX - 4, torch.float32, False, pair=True)]
    stream_fa = [check_flash(torch, fa, 1, t, causal=False, padded="stream", timed=False, lengths=[valid])
                 for t, valid in stream_flag["encoder_chunks"]]
    for rec in stream_kv:
        print("write_kv_pair, streaming", json.dumps(rec))
    for rec in stream_fa:
        print("flash_attention_fwd, streaming", json.dumps(rec))
    print(f"streaming phase: {time.perf_counter() - t0:.1f} s")
    end_phase("streaming")

    # ---- the Performer family: train performer.yaml, ar_generate, mlm_unmask ----
    begin_phase("performer")
    t0 = time.perf_counter()
    performer = performer_phase(torch, smi)
    print(f"performer phase: {time.perf_counter() - t0:.1f} s")
    end_phase("performer")
    print("performer", json.dumps({k: v for k, v in performer.items() if k != "kernels"}))

    # ---- Mixture-of-Experts: moe.yaml trained, rendered, served, streamed; the decode variants ----
    begin_phase("moe")
    t0 = time.perf_counter()
    moe = moe_phase(torch, tokenizer, smi, score, inputs, serve_scores, serve_inputs, stream_data, refs, stream_root)
    print(f"MoE phase: {time.perf_counter() - t0:.1f} s")
    end_phase("moe")
    print("moe", json.dumps({k: v for k, v in moe.items() if k != "kernels"}))

    # ---- training on several processes: data, model and expert axes, ZeRO, checkpoints ----
    begin_phase("parallel")
    t0 = time.perf_counter()
    parallel = parallel_phase(torch, tokenizer, smi, inputs, refs)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    end_phase("parallel")
    print(f"parallel: {parallel['cards']} card(s); multi-rank checks over {parallel['backend']}, "
          f"{parallel['ranks_a_card']} rank(s) a card"
          + ("; a world-size-1 nccl group ran a step and each collective" if "nccl_world1" in parallel else ""))
    print("parallel", json.dumps({k: v for k, v in parallel.items() if k != "kernels"}))
    sp, no_sp = parallel["steps"]["data2_model2_sp"], parallel["steps"]["data2_model2"]
    print(f"sequence parallel ({smi}): data 2 x model 2 peak GB a rank {[round(g, 2) for g in sp['peak_gb']]} "
          f"with it, {[round(g, 2) for g in no_sp['peak_gb']]} without; second-step ms "
          f"{[round(r[-1], 1) for r in sp['step_ms']]} against {[round(r[-1], 1) for r in no_sp['step_ms']]}; "
          f"gradient error {sp['grad_err']:.3g} against {no_sp['grad_err']:.3g}", flush=True)

    # ---- GPipe over a pipe axis: the flagship decoder trunk; the dry run ----
    begin_phase("pipeline")
    t0 = time.perf_counter()
    pipeline = pipeline_phase(torch, tokenizer, smi)
    print(f"pipeline phase: {time.perf_counter() - t0:.1f} s")
    end_phase("pipeline")
    print("pipeline", json.dumps({k: v for k, v in pipeline.items() if k != "kernels"}))

    # the head-shapes phase's CPU greedy tokens, in the worker while the
    # precision phase runs
    head_gate = head_shapes_gate(refs, tokenizer, score)

    # ---- the flash attention's "default" precision as the TPU's one pass ----
    begin_phase("precision")
    precision = precision_phase(torch, tokenizer, root, score, model_config, host_batch, smi,
                                prof_train["counted"][CONVERSION_KERNEL]["count"])
    end_phase("precision")
    print("precision", json.dumps({k: v for k, v in precision.items() if k not in ("main", "train")}))

    # ---- head shapes the kernels are not built for: 6 heads of 48 over one KV head ----
    begin_phase("head_shapes")
    shapes = head_shapes_phase(torch, tokenizer, score, model_config, host_batch, serve_scores, serve_inputs,
                               os.path.join(build, "chip_smoke_head_shapes"), refs, head_gate)
    end_phase("head_shapes")
    print(f"head shapes phase: {shapes['phase_s']:.1f} s (budget {HEAD_SHAPES_BUDGET_S:.0f} s); the script "
          f"{time.perf_counter() - t_script:.1f} s so far")
    print("head shapes", json.dumps(shapes))

    launches = renders["greedy"][1]
    paths = {"render_greedy": launches, "train_steps": train_launches,
             "bf16_compute_train_steps": options["bf16_compute"]["launches"],
             "bf16_model_train_steps": options["bf16_model"]["launches"],
             "scale_1024_train_steps": options["scale_1024"]["launches"],
             "paper_recipe_train_steps": paper["train"]["launches"], "served_batch": served_launches,
             "smoke_render": smoke["render"]["launches"], "smoke_served": smoke["served"]["launches"],
             "smoke_flash_train_steps": smoke["flash"]["train"]["launches"],
             "smoke_flash_render": smoke["flash"]["render"]["launches"],
             "smoke_flash_bf16_model_train_steps": smoke["flash"]["bf16_model"]["launches"],
             "scale_1024_served": scale["int8"]["launches"], "scale_1024_flash_render": scale["render"]["launches"],
             "scale_flash_train_steps_1024": scale_flash["seq_1024"]["launches"],
             "scale_flash_eval_pass_1024": scale_flash["seq_1024"]["eval_pass"]["launches"],
             "scale_flash_train_steps_2048": scale_flash["seq_2048"]["launches"],
             "scale_flash_bf16_model_train_steps_1024": scale_flash["bf16_model"]["launches"],
             "streaming_flagship": stream_flag["launches"],
             "streaming_scale_1024": stream_scale["launches"],
             "performer_train_steps": performer["train"]["plain"]["launches"],
             "performer_flash_train_steps": performer["train"]["flash"]["launches"],
             "performer_ar_generate_chunked": performer["ar_generate"]["chunked"]["launches"],
             "performer_ar_generate_ring": performer["ar_generate"]["ring"]["launches"],
             "performer_mlm_unmask_single_run": performer["mlm_unmask"]["single_run"]["launches"],
             "performer_mlm_unmask_iterative": performer["mlm_unmask"]["iterative"]["launches"],
             "moe_train_steps": moe["train"]["launches"], "moe_render": moe["render"]["launches"],
             "moe_served": moe["served"]["launches"], "moe_streaming": moe["streaming"]["launches"],
             **{f"moe_unmask_{name}": run["launches"] for name, run in moe["variants"]["runs"].items()},
             "parallel_render_from_gathered_checkpoint": parallel["checkpoints"]["render_launches"],
             **{f"parallel_{name}_train_steps_a_rank": {**{k: 0 for k in launches}, **run["launches_a_rank"]}
                for name, run in parallel["steps"].items()},
             **{f"pipeline_{name}_step_a_rank": {**{k: 0 for k in launches}, **run["launches_a_step"]}
                for name, run in pipeline["runs"].items()},
             "precision_medium_train_steps": precision["train"]["launches"],
             "precision_medium_render": precision["render"]["launches"],
             "precision_medium_batch4_step": precision["fp32_step_vs_plain"]["launches"],
             "precision_medium_bf16_model_batch4_step": precision["bf16_model_step_vs_plain"]["launches"],
             "head_shapes_render": shapes["render"]["launches"], "head_shapes_served": shapes["served"]["launches"],
             "head_shapes_train_step": shapes["train_step"]["launches"]}
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
         **{k: fa_main[k] for k in bound_keys + ("bound_tc_ms", "eager_ms", "over_library", "over_bound_tc")},
         "tf32_hgmma_in_sass": fwd_gmma["flash_fwd"], "tf32_hgmma_by_head_dim": fwd_gmma_dims["flash_fwd"],
         "ptxas_by_head_dim": [{k: v for k, v in e.items() if k != "function"} for e in fwd_ptxas]},
    ] + [
        {"name": name, "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": replaces, "launches": train_launches[name],
         **{k: rec[k] for k in bound_keys + ("bound_tc_ms", "eager_ms")}, "tf32_hgmma_in_sass": tf32_gmma[kernel],
         "tf32_hgmma_by_head_dim": tf32_gmma_dims[kernel]}
        for name, kernel, replaces, rec in (
            ("flash_attention_bwd_dkv", "flash_bwd_dkv", "scoreperformer_tpu/ops/flash_attention.py:135", bwd_main[0]),
            ("flash_attention_bwd_dq", "flash_bwd_dq", "scoreperformer_tpu/ops/flash_attention.py:192", bwd_main[1]),
        )
    ] + [
        # the bf16 instances, as the flagship held in bf16 launches them in
        # its train steps (bf16_compute keeps JAX's fp32 activations, so its
        # steps launch the fp32 instances)
        {"name": f"{name}_bf16", "route": "cuda", "source": f"scoreperformer_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": options["bf16_model"]["launches"][f"{name}_bf16"],
         **{k: rec[k] for k in bound_keys + ("bound_tc_ms", "bound_fp32_ms", "bf16_passes", "over_library",
                                             "pair_over_library", "bf16_ulps", "library_timing") if k in rec},
         "shape": rec["shape"], "dtype": "bf16", **sass}
        for name, source, replaces, rec, sass in (
            ("flash_attention_fwd", "flash_attention_fwd_bf16.cu", "scoreperformer_tpu/ops/flash_attention.py:49",
             bf16_main[0], {"bf16_hgmma_in_sass": hgmma["flash_fwd_bf16"],
                            "bf16_hgmma_by_head_dim": hgmma_dims["flash_fwd_bf16"]}),
            ("flash_attention_bwd_dkv", "flash_attention_bwd_bf16.cu", "scoreperformer_tpu/ops/flash_attention.py:135",
             bf16_main[1], {"bf16_hgmma_in_sass": hgmma["flash_bwd_dkv_bf16"],
                            "bf16_hgmma_by_head_dim": hgmma_dims["flash_bwd_dkv_bf16"]}),
            ("flash_attention_bwd_dq", "flash_attention_bwd_bf16.cu", "scoreperformer_tpu/ops/flash_attention.py:192",
             bf16_main[2], {"bf16_hgmma_in_sass": hgmma["flash_bwd_dq_bf16"],
                            "bf16_hgmma_by_head_dim": hgmma_dims["flash_bwd_dq_bf16"]}),
        )
    ] + [
        # the one-pass instances (the TPU's "default" numerics, under
        # torch.set_float32_matmul_precision("medium")), as the flagship's
        # fp32 train steps launch them (`instances`: their names in the
        # profiled step); `ms` each kernel on the fp32 operands, which it
        # rounds itself (no wrapper copies: `operands`)
        {"name": f"{name}_one_pass", "route": "cuda", "source": f"scoreperformer_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": precision["train"]["launches"][f"{name}_one_pass"],
         **{k: rec[k] for k in bound_keys + ("bf16_passes", "over_library", "pair_over_library", "err_over_bound",
                                             "library_timing") if k in rec},
         "shape": rec["shape"], "dtype": rec["dtype"], "operands": operands,
         "instances": precision["train"]["profile"]["ported"][ported]["kernels"],
         "bf16_hgmma_in_sass": one_pass_gmma[kernel], "bf16_hgmma_by_head_dim": one_pass_gmma_dims[kernel]}
        for name, source, replaces, rec, kernel, ported, operands in (
            ("flash_attention_fwd", "flash_attention_fwd_one_pass.cu", "scoreperformer_tpu/ops/flash_attention.py:49",
             precision["main"][0], "flash_fwd_bf16", "flash_fwd",
             "fp32, rounded to bf16 in the kernel, q after the scale"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd_one_pass.cu",
             "scoreperformer_tpu/ops/flash_attention.py:135", precision["main"][1], "flash_bwd_dkv_bf16",
             "flash_bwd_dkv", "fp32, rounded to bf16 in the kernel"),
            ("flash_attention_bwd_dq", "flash_attention_bwd_one_pass.cu",
             "scoreperformer_tpu/ops/flash_attention.py:192", precision["main"][2], "flash_bwd_dq_bf16",
             "flash_bwd_dq", "fp32, rounded to bf16 in the kernel"),
        )
    ] + [
        {"name": "prefix_attend", "route": "cuda", "source": "scoreperformer_tpu_torch/csrc/prefix_attend.cu",
         "replaces": "scripts/exp_pallas_decode_attend.py:51", "launches": launches["prefix_attend"],
         **{k: pa_main[k] for k in bound_keys + ("eager_ms",)}},
    ]
    shape_keys = ("shape", "cap", "base", "index", "causal", "max_abs_err") + timed + ("bound_by", "over_bound_tc")
    # every flash instance at head dims 16 and 128 (and scale_1024's
    # encoders at 64), at the shapes of the paths that launch them (timed by
    # chip_probe_recipe_shapes.py)
    part = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dkv": "dkv", "flash_attention_bwd_dq": "dq"}
    for rec in kernels:
        name = rec["name"].removesuffix("_bf16")
        if name in part:
            recs = [(r["path"], r["bf16"][part[name]] if rec["name"].endswith("_bf16") else r[part[name]])
                    for r in head_dims["timed"] if "bf16" in r or not rec["name"].endswith("_bf16")]
            rec["head_dim_shapes"] = [{"path": what, **{k: r[k] for k in shape_keys + (
                "kv_heads", "bound_tc_ms", "over_library", "pair_over_library") if k in r}}
                                      for what, r in recs]
    # the other paths' shapes are held to the plain versions in their phases
    # above and timed by chip_probe_recipe_shapes.py
    for rec in kernels:
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in paths.items()}
    # the worker's CPU references, joined where their gates read them
    begin_phase("cpu_reference_gates")
    refs.check_all()
    end_phase("cpu_reference_gates")
    print("phases", json.dumps({"phase_s": PHASE_S, "cpu_ref_s": CPU_REF_S, "cpu_wait_s": CPU_WAIT_S,
                                "cpu_ref_s_sum": sum(CPU_REF_S.values()),
                                "cpu_wait_s_sum": sum(CPU_WAIT_S.values())}))
    print(f"CPU references: {sum(CPU_REF_S.values()):.1f} s of host time, the script waited "
          f"{sum(CPU_WAIT_S.values()):.1f} s of it for the worker's")
    print(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

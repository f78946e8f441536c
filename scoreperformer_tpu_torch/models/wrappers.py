"""Decode loops: MixedLM unmasking, autoregressive generation, MLM unmasking.

Counterpart of `mixedlm_unmask`, `ar_generate` and `mlm_unmask` in
scoreperformer_tpu/models/wrappers.py. The JAX package compiles each loop
into one `lax.scan`; here it is a Python loop of eager steps over static KV
caches that each step updates in place, with no host sync inside the loop.
In `mixedlm_unmask`, position `j` consumes the already final token `j` and
predicts `j + 1`; positions at or past `valid_len` are left as they are.

Two layouts give the same tokens, as in the JAX package:
- `chunk_size=None`: each layer's cache is written at slot `j` per step;
- `chunk_size=C` (default 16): per chunk of C steps the new rows go to small
  fresh buffers, the big prefix cache stays frozen, and the fresh rows merge
  into it once per chunk. The step count is padded to a multiple of C; the
  padded tail steps read and rewrite position T-1 (XLA's dynamic_slice and
  dynamic_update_slice clamp their start) and change nothing. Each step's
  attention over the frozen prefix runs through `ops.prefix_attend`.

The caches may be fp32, bf16 or int8 (`cache_dtype`). An int8 prefix holds
rows quantized once per chunk at the merge (`attention.quantize_kv_rows`),
with fp32 fresh buffers; it needs the chunked layout.

The chunked layout's variants of the JAX package (wrappers.py:422-590) give
the same tokens and keep its cache shapes, so each step attends over the
prefix capacity the JAX variant gives it:
- `static_prefix`: chunk c attends over the prefix sliced to its `c * C`
  written rows (`prefix_attend` at cap = base; the first chunk has no prefix
  and takes the fresh chunk's softmax alone);
- `capacity_stages=G`: G stages whose caches hold the rows of their chunks
  (`c1 * C`), each stage's caches copied into the next, larger ones at the
  boundary, int8 row scales included;
- `chunk_tokens`: each chunk carries a (C+1, b, S) row buffer whose row 0 is
  the token at `base` and whose rows merge into the token tensor (padded to
  `n_chunks * C + 1`) once a chunk; a step's target comes from the
  pre-decode tokens;
- `unrolled_chunks`: the same chunk loop (the JAX package unrolls its outer
  scan; here the loop is Python already). It takes the carried tokens, as
  does `static_prefix`, which takes precedence over the other variants.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.sampling import apply_temperature, categorical, top_k
from .attention import quantize_kv_rows

NEG_INF = -1e9


def logits_by_column(model, logits: Dict[str, torch.Tensor]) -> List[Tuple[int, str, torch.Tensor]]:
    """Per-stream logits keyed by the token column order of `num_tokens`."""
    keys = list(model.config.num_tokens)
    if set(keys) != set(logits):
        raise ValueError(f"logits for {sorted(logits)}, streams {keys}")
    return [(s, key, logits[key]) for s, key in enumerate(keys)]


def batched_column_mask(sizes, pad_token_id: int, mask_token_id: int, forbid_ids=None) -> torch.Tensor:
    """(S, Vmax) additive mask for the stacked logits: NEG_INF on the columns
    past each stream's vocabulary, on PAD and MASK, and on forbidden ids."""
    vmax = max(sizes)
    col = np.arange(vmax)
    out = np.zeros((len(sizes), vmax), np.float32)
    for s, V in enumerate(sizes):
        invalid = (col >= V) | (col == pad_token_id) | (col == mask_token_id)
        if forbid_ids and s in forbid_ids:
            invalid |= np.isin(col, torch.as_tensor(forbid_ids[s]).cpu().numpy())
        out[s, invalid] = NEG_INF
    return torch.from_numpy(out)


def batched_top_k(logits: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Per-stream top-k over stacked (b, S, Vmax) logits: stream s keeps
    every logit at or above its own ks[s]-th largest, as `top_k` would on
    the stream alone (padded columns sit below every real one). `ks` is an
    (S,) int64 tensor on the logits' device."""
    b, S, _ = logits.shape
    ranked = torch.sort(logits, dim=-1, descending=True).values
    kth = ranked.gather(-1, (ks - 1).view(1, S, 1).expand(b, S, 1))
    return torch.where(logits < kth, NEG_INF, logits)


def _stacked(columns, vmax: int) -> torch.Tensor:
    """(b, S, Vmax) of per-stream (b, V_s) logits, padded with NEG_INF."""
    return torch.stack([F.pad(l, (0, vmax - l.shape[-1]), value=NEG_INF) for _, _, l in columns], dim=1)


def _sample_stream(generator, logits, temperature, filter_fn, filter_kwargs, greedy):
    if greedy:
        return torch.argmax(logits, dim=-1)
    filtered = apply_temperature(filter_fn(logits, **(filter_kwargs or {})), temperature)
    return categorical(filtered, generator)


@torch.inference_mode()
def mixedlm_unmask(
    model,
    tokens: torch.Tensor,
    tokens_masked: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    style_embeddings: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    valid_len: Optional[torch.Tensor] = None,
    temperature=1.0,
    filter_fn: Callable = top_k,
    filter_kwargs: Optional[Dict] = None,
    greedy: bool = False,
    mask_token_id: int = 1,
    pad_token_id: int = 0,
    forbid_ids: Optional[Dict[int, torch.Tensor]] = None,
    cache_dtype=torch.float32,
    chunk_size: Optional[int] = 16,
    fresh_dtype=None,
    static_prefix: bool = False,
    chunk_tokens: bool = False,
    unrolled_chunks: bool = False,
    capacity_stages: int = 1,
    sample_dims: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Chord-wise MixedLM unmasking. `tokens` (b, T, S) holds MASK at the
    positions/streams to predict; `tokens_masked` is the fully masked
    parallel stream. Returns a new tensor with the masks filled.

    `sample_dims` restricts filtering and sampling to the streams the caller
    masked (ignored when greedy, as in the JAX package); other streams pass
    their target token through. Sampling draws from `generator`, which must
    live on the tokens' device. `temperature` is a number or a (b,) tensor on
    that device, one value per row.

    `cache_dtype` is torch.float32, torch.bfloat16 or torch.int8; the fresh
    buffers of the chunked layout take `fresh_dtype`, by default the cache's
    type, fp32 under an int8 cache (the JAX package's `_fresh_dtype`).

    Without `sample_dims`, greedy and top-k decoding pick from all streams at
    once: the logits are stacked into one zero-padded (b, S, Vmax) tensor and
    one argmax, or one top-k and one draw, serves every stream (the JAX
    package's batched stack, `wrappers.py:234-296`). Eager PyTorch pays per
    launch, so this replaces S filter-and-draw chains by one; greedy tokens
    are the same either way.

    `static_prefix`, `capacity_stages`, `chunk_tokens` and `unrolled_chunks`
    select the chunked layout's variants (module docstring); the classic
    layout ignores them, as in the JAX package."""
    if cache_dtype == torch.int8 and chunk_size is None:
        raise ValueError("mixedlm_unmask: int8 caches need the chunked decode (quantization lives in the chunk merge)")
    if not greedy and generator is None:
        raise ValueError("mixedlm_unmask: sampling needs a torch.Generator")
    b, T, S = tokens.shape
    dev = tokens.device
    if sample_dims is not None:
        sample_dims = None if greedy else tuple(int(s) for s in sample_dims)
    use_batched = sample_dims is None and (greedy or filter_fn is top_k)
    if use_batched:
        sizes = list(model.config.num_tokens.values())
        vmax = max(sizes)
        col_mask = batched_column_mask(sizes, pad_token_id, mask_token_id, forbid_ids).to(dev)
        thres, kfix = (filter_kwargs or {}).get("thres", 0.9), (filter_kwargs or {}).get("k")
        ks = torch.tensor(
            [max(1, min(int(kfix) if kfix else math.ceil((1 - thres) * V), V)) for V in sizes], device=dev
        )

    C = None if chunk_size is None else int(chunk_size)
    n_steps = T - 1 if C is None else -(-(T - 1) // C) * C
    n_chunks = None if C is None else n_steps // C
    staged = C is not None and not static_prefix and not unrolled_chunks and int(capacity_stages or 1) > 1
    # the chunked layout pads the step count; the caches hold every step
    # (the staged variant makes its own, stage by stage)
    caches = None if staged else model.init_decoder_cache(b, max(n_steps, T), dtype=cache_dtype, device=dev)
    # step j's cache position as a device view: no host-to-device copy per step
    positions = torch.arange(max(n_steps, 1), dtype=torch.int64, device=dev)

    tokens = tokens.clone()
    unmask_mask = tokens == mask_token_id
    if valid_len is None:
        valid_len = torch.full((b,), T, dtype=torch.int64, device=dev)
    forbid = {s: torch.as_tensor(ids, device=dev) for s, ids in (forbid_ids or {}).items()}

    def predict(step_caches, j, seq_j, target_src):
        """Consume `seq_j` (b, 1, S), token j (already final), and return the
        row that position j+1 takes: the prediction where it is masked and
        below `valid_len`, else its token in `target_src`."""
        j1 = min(j + 1, T - 1)  # dynamic_slice clamping
        hidden = model.decode_step(
            seq_j,
            masked_tokens=tokens_masked[:, j1 : j1 + 1],
            style_embeddings=style_embeddings[:, j1 : j1 + 1] if style_embeddings is not None else None,
            context=context[:, j1 : j1 + 1] if context is not None else None,
            caches=step_caches,
            cache_index=positions[j : j + 1],
        )
        columns = logits_by_column(model, model.decoder.apply_lm_head(hidden[:, 0]))
        target = target_src[:, min(j + 1, target_src.shape[1] - 1)]
        if use_batched:
            lg = _stacked(columns, vmax) + col_mask
            if greedy:
                samples = torch.argmax(lg, dim=-1)
            else:
                samples = categorical(apply_temperature(batched_top_k(lg, ks), temperature), generator)
        else:
            samples = []
            for s, _, lg in columns:
                if sample_dims is not None and s not in sample_dims:
                    samples.append(target[:, s])
                    continue
                lg = lg.clone()
                lg[:, pad_token_id] = NEG_INF
                lg[:, mask_token_id] = NEG_INF
                if s in forbid:
                    lg[:, forbid[s]] = NEG_INF
                samples.append(_sample_stream(generator, lg, temperature, filter_fn, filter_kwargs, greedy))
            samples = torch.stack(samples, dim=-1)
        fill = unmask_mask[:, j1] & ((j + 1) < valid_len)[:, None]
        return torch.where(fill, samples, target)

    def step(step_caches, j):
        """The carried tokens: consume token j, write position j+1 in place
        (a padded tail step rewrites position T-1 with its current token)."""
        jr = min(j, T - 1)
        tokens[:, min(j + 1, T - 1)] = predict(step_caches, j, tokens[:, jr : jr + 1], tokens)

    if C is None:
        for j in range(n_steps):
            step(caches, j)
        return tokens

    if fresh_dtype is None:
        fresh_dtype = torch.float32 if cache_dtype == torch.int8 else cache_dtype
    layers = caches if caches is not None else model.init_decoder_cache(b, 0, dtype=cache_dtype, device=dev)
    fresh = [
        {"fk": torch.zeros((C,) + layer["k"].shape[1:], dtype=fresh_dtype, device=dev),
         "fv": torch.zeros((C,) + layer["v"].shape[1:], dtype=fresh_dtype, device=dev)}
        if layer is not None else None
        for layer in layers
    ]
    rows = chunk_tokens and not static_prefix and not unrolled_chunks
    if rows:  # the row buffers merge into tokens padded so that the last merge fits
        tokens0, tokens = tokens, F.pad(tokens, (0, 0, 0, max(0, n_chunks * C + 1 - T)))
        ftok = torch.zeros((C + 1, b, S), dtype=tokens.dtype, device=dev)

    def run_chunk(prefix, base):
        """The C steps of the chunk at `base` over the frozen `prefix` (a
        static prefix's slice of `base` rows, or whole caches), then its
        fresh rows merged into `prefix`'s full caches in place."""
        view = prefix
        if static_prefix:
            view = [{key: t[:base] for key, t in layer.items()} if layer is not None else None for layer in prefix]
        for f in fresh:
            if f is not None:
                f["fk"].zero_()
                f["fv"].zero_()
        merged = [{**layer, **f, "base": base} if layer is not None else None for layer, f in zip(view, fresh)]
        if rows:
            ftok[0] = tokens[:, base]
            for kk in range(C):
                ftok[kk + 1] = predict(merged, base + kk, ftok[kk][:, None], tokens0)
            tokens[:, base + 1 : base + C + 1] = ftok[1:].transpose(0, 1)
        else:
            for j in range(base, base + C):
                step(merged, j)
        for layer, f in zip(prefix, fresh):
            if layer is None:
                continue
            for key in ("k", "v"):
                fresh_rows = f["f" + key]
                if "k_s" in layer:  # int8: quantize the chunk's rows once, with their scales
                    fresh_rows, layer[key + "_s"][base : base + C] = quantize_kv_rows(fresh_rows.float())
                layer[key][base : base + C].copy_(fresh_rows)

    if not staged:
        for c in range(n_chunks):
            run_chunk(caches, c * C)
        return tokens[:, :T]
    G = int(capacity_stages)
    bounds = sorted({(g * n_chunks) // G for g in range(G + 1)})
    prefix = None
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        stage = model.init_decoder_cache(b, c1 * C, dtype=cache_dtype, device=dev)
        if prefix is not None:  # the smaller caches into the larger ones, row scales included
            for new, old in zip(stage, prefix):
                if new is not None:
                    for key, t in old.items():
                        new[key][: t.shape[0]].copy_(t)
        for c in range(c0, c1):
            run_chunk(stage, c * C)
        prefix = stage
    return tokens[:, :T]


@torch.inference_mode()
def ar_generate(
    model,
    start_tokens: torch.Tensor,
    seq_len: int,
    generator: Optional[torch.Generator] = None,
    style_embeddings: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    filter_fn: Callable = top_k,
    filter_kwargs: Optional[Dict] = None,
    greedy: bool = False,
    stream_names: Optional[List[str]] = None,
    fix_errors: bool = True,
    eos_token_id: int = 3,
    pad_token_id: int = 0,
    max_bar: Optional[int] = None,
    max_seq_len: Optional[int] = None,
    chunk_size: Optional[int] = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive generation with per-stream constraints (the JAX
    package's `ar_generate`, reference wrappers.py:200-270).

    Continues the (b, t0, S) prompt to `seq_len + 1` positions and returns
    (generated (b, seq_len + 1 - t0, S), num_generated (b,)), both on the
    prompt's device. Step k consumes token `t0 + k - 2` (the reference's CLM
    shift never consumes the latest token) and predicts position `t0 + k`;
    style and context are read one position later. With `fix_errors`, the
    Bar stream cannot go back (ids in [4, last bar) are forbidden), Tempo
    copies forward inside a bar, judged by this step's Bar sample, and
    TimeSig always copies forward; ids 0-1 (PAD, MASK) are never drawn. EOS
    on the Bar stream, or a Bar above `max_bar`, pads the row's other
    streams, and every later row of that sequence is PAD; `num_generated` is
    the first such step plus one, else the step count.

    `max_seq_len` (default: the decoder's) bounds the attention context. A
    generation that fits it, from a prompt of 2 or more, runs the chunked
    layout of `mixedlm_unmask` when `chunk_size` is set: the step count is
    padded to a multiple of C, the first chunk starts at position t0 - 2,
    and padded tail steps rewrite the last row unchanged. Otherwise the
    caches are rings of `max_seq_len` slots, and past the window the oldest
    position is overwritten each step.

    Greedy decoding gives the JAX package's tokens. Sampling draws from
    `generator` (on the prompt's device), one stacked draw a step for top-k
    and one a stream for other filters; it cannot reproduce `jax.random`."""
    b, t0, S = start_tokens.shape
    dev = start_tokens.device
    if not greedy and generator is None:
        raise ValueError("ar_generate: sampling needs a torch.Generator")
    stream_names = list(stream_names or [str(i) for i in range(S)])
    name_to_idx = {n: i for i, n in enumerate(stream_names)}
    bar_idx = name_to_idx.get("Bar", 0)
    if fix_errors and "Tempo" in name_to_idx and "Bar" in name_to_idx and name_to_idx["Bar"] > name_to_idx["Tempo"]:
        # the same-bar Tempo copy-forward reads this step's Bar sample
        raise ValueError("ar_generate: Bar must precede Tempo in the stream order for copy-forward")
    tempo_idx = name_to_idx.get("Tempo") if fix_errors else None
    timesig_idx = name_to_idx.get("TimeSig") if fix_errors else None
    has_bar = "Bar" in name_to_idx

    if max_seq_len is None:  # the decoder's window: a ScorePerformer's perf_decoder, a Performer's transformer
        dec_cfg = getattr(model.config, "perf_decoder", None) or getattr(model.config, "transformer", None)
        max_seq_len = getattr(dec_cfg, "max_seq_len", None)
    total = seq_len + 1
    cache_len = total if max_seq_len is None else min(total, int(max_seq_len))
    if t0 > cache_len:
        raise ValueError(f"ar_generate: the prompt ({t0}) must fit the context window ({cache_len})")
    num_steps = total - t0
    C = int(chunk_size) if chunk_size is not None and cache_len == total and t0 >= 2 else None
    n_padded = num_steps if C is None else -(-num_steps // C) * C
    if C is not None:
        cache_len = max(cache_len, (t0 - 2) + n_padded)
    caches = model.init_decoder_cache(b, cache_len, device=dev)
    # cache positions as device views: no host-to-device copy a step
    positions = torch.arange(max(t0 + n_padded, 1), dtype=torch.int64, device=dev)

    buf = torch.zeros((b, total, S), dtype=start_tokens.dtype, device=dev)
    buf[:, :t0] = start_tokens
    if t0 > 1:  # prefill with tokens [0, t0 - 2]
        model.decode_step(
            start_tokens[:, : t0 - 1],
            style_embeddings=style_embeddings[:, 1:t0] if style_embeddings is not None else None,
            context=context[:, 1:t0] if context is not None else None,
            caches=caches, cache_index=positions[0:1],
        )

    sizes = list(model.config.num_tokens.values())
    vmax = max(sizes)
    col = torch.arange(vmax, device=dev)
    # NEG_INF on each stream's padded columns and on PAD and MASK (ids 0-1)
    invalid = torch.stack([(col >= V) | (col < 2) for V in sizes])
    batched_k = filter_fn is top_k
    if batched_k:
        thres, kfix = (filter_kwargs or {}).get("thres", 0.9), (filter_kwargs or {}).get("k")
        ks = torch.tensor([max(1, min(int(kfix) if kfix else math.ceil((1 - thres) * V), V)) for V in sizes],
                          device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    dones = []

    def clamp(i, n):  # dynamic_slice's start of one row: from the end if negative, then clamped
        return min(max(i + n if i < 0 else i, 0), n - 1)

    def step(step_caches, k):
        L = t0 + k  # consume token L - 2, predict position L
        consume = L - 2
        cj, sj = clamp(consume, total), consume + 1
        hidden = model.decode_step(
            buf[:, cj : cj + 1],
            style_embeddings=style_embeddings[:, clamp(sj, style_embeddings.shape[1])][:, None]
            if style_embeddings is not None else None,
            context=context[:, clamp(sj, context.shape[1])][:, None] if context is not None else None,
            caches=step_caches, cache_index=positions[consume : consume + 1] if consume >= 0 else positions[0:1] - 1,
        )
        if k >= num_steps:  # a padded chunk-tail step: its rows are written, its prediction is not kept
            return
        lg = _stacked(logits_by_column(model, model.decoder.apply_lm_head(hidden[:, 0])), vmax)  # (b, S, Vmax)
        last = buf[:, clamp(L - 1, total)]
        last_bar = last[:, bar_idx]
        forbid = invalid.expand(b, S, vmax)
        if fix_errors and has_bar:  # the Bar stream cannot go back
            bar_forbid = (col >= 4) & (col < last_bar[:, None])
            forbid = forbid.clone()
            forbid[:, bar_idx] |= bar_forbid
        lg = lg.masked_fill(forbid, NEG_INF)
        if greedy:
            samples = torch.argmax(lg, dim=-1)
        elif batched_k:
            samples = categorical(apply_temperature(batched_top_k(lg, ks), temperature), generator)
        else:
            samples = torch.stack([
                categorical(apply_temperature(filter_fn(lg[:, s, :V], **(filter_kwargs or {})), temperature),
                            generator)
                for s, V in enumerate(sizes)], dim=-1)
        samples = samples.to(buf.dtype)
        if tempo_idx is not None:
            same_bar = samples[:, bar_idx] == last_bar if has_bar else torch.ones_like(done)
            samples[:, tempo_idx] = torch.where(same_bar, last[:, tempo_idx], samples[:, tempo_idx])
        if timesig_idx is not None:
            samples[:, timesig_idx] = last[:, timesig_idx]

        bar = samples[:, bar_idx]
        is_eos = bar == eos_token_id
        if max_bar is not None:
            is_eos = is_eos | (bar > max_bar)
        pad_row = torch.full_like(samples, pad_token_id)
        pad_row[:, bar_idx] = bar
        samples = torch.where(is_eos[:, None], pad_row, samples)
        buf[:, L] = torch.where(done[:, None], torch.full_like(samples, pad_token_id), samples)
        done.logical_or_(is_eos)
        dones.append(done.clone())

    if C is None:
        for k in range(num_steps):
            step(caches, k)
    else:
        fresh = [{"fk": torch.zeros((C,) + layer["k"].shape[1:], dtype=layer["k"].dtype, device=dev),
                  "fv": torch.zeros((C,) + layer["v"].shape[1:], dtype=layer["v"].dtype, device=dev)}
                 if layer is not None else None for layer in caches]
        for c in range(n_padded // C):
            base = (t0 - 2) + c * C
            for f in fresh:
                if f is not None:
                    f["fk"].zero_()
                    f["fv"].zero_()
            merged = [{**layer, **f, "base": base} if layer is not None else None for layer, f in zip(caches, fresh)]
            for kk in range(C):
                step(merged, c * C + kk)
            for layer, f in zip(caches, fresh):  # merge the chunk into the prefix, in place
                if layer is not None:
                    layer["k"][base : base + C].copy_(f["fk"])
                    layer["v"][base : base + C].copy_(f["fv"])

    dones = torch.stack(dones)  # (num_steps, b)
    first = torch.argmax(dones.to(torch.int64), dim=0)
    num_generated = torch.where(dones.any(dim=0), first + 1, torch.full_like(first, num_steps))
    return buf[:, t0:total], num_generated


@torch.inference_mode()
def mlm_unmask(
    model,
    tokens: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    single_run: bool = True,
    mask: Optional[torch.Tensor] = None,
    style_embeddings: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    filter_fn: Callable = top_k,
    filter_kwargs: Optional[Dict] = None,
    greedy: bool = False,
    mask_token_id: int = 1,
    num_special_tokens: int = 4,
    forbid_ids: Optional[Dict[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """MLM unmasking (reference wrappers.py:99-182) of the MASK entries of
    `tokens` (b, T, S); returns a new tensor.

    `single_run`: one bidirectional forward and an argmax fill (the reference
    takes the argmax here too). Otherwise the masked positions are revealed
    left to right, each by a full forward masked to the revealed prefix
    (bidirectional attention rules out incremental caches): position `idx`
    takes the prediction at `idx - 1`, with the special ids (below
    `num_special_tokens`) and `forbid_ids[s]` never drawn. Sampling draws
    from `generator`; greedy gives the JAX package's tokens."""
    b, T, S = tokens.shape
    dev = tokens.device
    if not single_run and not greedy and generator is None:
        raise ValueError("mlm_unmask: sampling needs a torch.Generator")
    if mask is None:
        mask = torch.ones((b, T), dtype=torch.bool, device=dev)
    unmask_mask = tokens == mask_token_id

    def forward(tok, attn_len_mask):
        return model.decode_step(tok, mask=attn_len_mask, style_embeddings=style_embeddings, context=context)

    if single_run:
        logits = model.decoder.apply_lm_head(forward(tokens, mask))
        samples = torch.stack([torch.argmax(lg, dim=-1) for _, _, lg in logits_by_column(model, logits)], dim=-1)
        return torch.where(unmask_mask, samples.to(tokens.dtype), tokens)

    # the positions to reveal, read once on the host
    position_masked = unmask_mask.any(dim=-1).cpu().numpy()
    forbid = {s: torch.as_tensor(ids, device=dev) for s, ids in (forbid_ids or {}).items()}
    out = tokens.clone()
    arange = torch.arange(T, device=dev)
    for idx in range(1, T):
        if not position_masked[:, idx].any():
            continue
        hidden = forward(out, mask & (arange[None, :] <= idx))
        samples = []
        for s, _, lg in logits_by_column(model, model.decoder.apply_lm_head(hidden[:, idx - 1])):
            lg = lg.clone()
            lg[:, :num_special_tokens] = NEG_INF
            if s in forbid:
                lg[:, forbid[s]] = NEG_INF
            samples.append(_sample_stream(generator, lg, temperature, filter_fn, filter_kwargs, greedy))
        samples = torch.stack(samples, dim=-1).to(out.dtype)
        out[:, idx] = torch.where(unmask_mask[:, idx], samples, out[:, idx])
    return out

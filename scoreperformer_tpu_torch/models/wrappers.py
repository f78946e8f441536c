"""MixedLM unmasking decode loop.

Counterpart of `mixedlm_unmask` in scoreperformer_tpu/models/wrappers.py. The
JAX package compiles the loop into one `lax.scan`; here it is a Python loop of
eager steps over static KV caches that each step updates in place. Position
`j` consumes the already final token `j` and predicts `j + 1`; positions at or
past `valid_len` are left as they are.

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


def _sample_stream(generator, logits, temperature, filter_fn, filter_kwargs, greedy):
    if greedy:
        return torch.argmax(logits, dim=-1)
    filtered = apply_temperature(filter_fn(logits, **(filter_kwargs or {})), temperature)
    return categorical(filtered, generator)


def _not_ported(**knobs):
    for name, (value, default) in knobs.items():
        if value != default:
            raise NotImplementedError(f"mixedlm_unmask: {name}={value!r} is not ported yet")


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
    are the same either way."""
    _not_ported(
        static_prefix=(static_prefix, False), chunk_tokens=(chunk_tokens, False),
        unrolled_chunks=(unrolled_chunks, False), capacity_stages=(capacity_stages, 1),
    )
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
    # the chunked layout pads the step count; the caches hold every step
    cache_len = max(n_steps, T)
    caches = model.init_decoder_cache(b, cache_len, dtype=cache_dtype, device=dev)
    # step j's cache position as a device view: no host-to-device copy per step
    positions = torch.arange(max(n_steps, 1), dtype=torch.int64, device=dev)

    tokens = tokens.clone()
    unmask_mask = tokens == mask_token_id
    if valid_len is None:
        valid_len = torch.full((b,), T, dtype=torch.int64, device=dev)
    forbid = {s: torch.as_tensor(ids, device=dev) for s, ids in (forbid_ids or {}).items()}

    def step(step_caches, j):
        """Consume token j (already final), predict j+1 and write it back."""
        jr, j1 = min(j, T - 1), min(j + 1, T - 1)  # dynamic_slice clamping
        hidden = model.decode_step(
            tokens[:, jr : jr + 1],
            masked_tokens=tokens_masked[:, j1 : j1 + 1],
            style_embeddings=style_embeddings[:, j1 : j1 + 1] if style_embeddings is not None else None,
            context=context[:, j1 : j1 + 1] if context is not None else None,
            caches=step_caches,
            cache_index=positions[j : j + 1],
        )
        columns = logits_by_column(model, model.decoder.apply_lm_head(hidden[:, 0]))
        target = tokens[:, j1]
        if use_batched:
            lg = torch.stack([F.pad(l, (0, vmax - l.shape[-1]), value=NEG_INF) for _, _, l in columns], dim=1)
            lg = lg + col_mask
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
        tokens[:, j1] = torch.where(fill, samples, target)  # in place

    if C is None:
        for j in range(n_steps):
            step(caches, j)
        return tokens

    if fresh_dtype is None:
        fresh_dtype = torch.float32 if cache_dtype == torch.int8 else cache_dtype
    fresh = [
        {"fk": torch.zeros((C,) + layer["k"].shape[1:], dtype=fresh_dtype, device=dev),
         "fv": torch.zeros((C,) + layer["v"].shape[1:], dtype=fresh_dtype, device=dev)}
        if layer is not None else None
        for layer in caches
    ]
    for base in range(0, n_steps, C):
        for f in fresh:
            if f is not None:
                f["fk"].zero_()
                f["fv"].zero_()
        merged = [
            {**layer, **f, "base": base} if layer is not None else None
            for layer, f in zip(caches, fresh)
        ]
        for j in range(base, base + C):
            step(merged, j)
        for layer, f in zip(caches, fresh):  # merge the chunk into the prefix, in place
            if layer is None:
                continue
            for key in ("k", "v"):
                rows = f["f" + key]
                if "k_s" in layer:  # int8: quantize the chunk's rows once, with their scales
                    rows, layer[key + "_s"][base : base + C] = quantize_kv_rows(rows.float())
                layer[key][base : base + C].copy_(rows)
    return tokens

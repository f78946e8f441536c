"""Logit filtering and sampling (counterpart of scoreperformer_tpu/ops/sampling.py).

Filters return full-size logits with -inf outside the kept set. Sampling
draws from an explicit `torch.Generator`; it cannot reproduce `jax.random`'s
stream, so sampled tokens are compared by distribution, never bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

NEG_INF = float("-inf")


def top_p(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """Nucleus filtering (sampling.py:15-23): a token is kept iff the
    probability mass of the tokens ranked strictly above it is at most
    `thres`. Ranks break ties by position (a stable sort), as jnp.argsort."""
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1) - sorted_probs  # exclusive
    ranks = torch.argsort(torch.argsort(-logits, dim=-1, stable=True), dim=-1, stable=True)
    return logits.masked_fill(cum.gather(-1, ranks) > thres, NEG_INF)


def top_a(logits: torch.Tensor, min_p_pow: float = 2.0, min_p_ratio: float = 0.02) -> torch.Tensor:
    """Keep the tokens whose probability reaches max(p)^min_p_pow *
    min_p_ratio (sampling.py:38-41)."""
    probs = torch.softmax(logits.float(), dim=-1)
    limit = probs.amax(dim=-1, keepdim=True) ** min_p_pow * min_p_ratio
    return logits.masked_fill(probs < limit, NEG_INF)


def top_k(logits: torch.Tensor, thres: float = 0.9, k: Optional[int] = None, method: Optional[str] = None,
          recall: float = 1.0) -> torch.Tensor:
    """Keep every logit at or above the k-th largest (ties included), with
    k = ceil((1 - thres) * V) unless given. `method` and `recall` choose how
    the JAX filter finds the k-th value on a TPU (sort, `lax.top_k`, or
    `approx_max_k` at that recall target); every one of them keeps what the
    exact filter keeps here, which meets any recall target."""
    if k is None:
        k = math.ceil((1 - thres) * logits.shape[-1])
    k = max(1, min(int(k), logits.shape[-1]))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_temperature(logits: torch.Tensor, temperature) -> torch.Tensor:
    """Divide by T (a number, or one value per row of the leading batch dim)."""
    if isinstance(temperature, (int, float)):
        return logits if temperature == 1.0 else logits / temperature
    if temperature.ndim >= 1:
        temperature = temperature.reshape(temperature.shape[:1] + (1,) * (logits.ndim - 1))
    return logits / temperature


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick (the
    method of jax.random.categorical)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def filter_logits_and_sample(generator: Optional[torch.Generator], logits: torch.Tensor,
                             filter_logits_fn: Callable = top_k, filter_kwargs: Optional[Dict] = None,
                             temperature=1.0, sample: bool = True) -> torch.Tensor:
    """filter, temperature, then one draw per row from `generator` (which
    lives on the logits' device); with `sample=False`, the filtered
    distribution itself (sampling.py:46-59)."""
    filtered = apply_temperature(filter_logits_fn(logits, **(filter_kwargs or {})), temperature)
    if not sample:
        return torch.softmax(filtered, dim=-1)
    return categorical(filtered, generator)

"""Logit filtering and sampling (counterpart of scoreperformer_tpu/ops/sampling.py).

Filters return full-size logits with -inf outside the kept set. Sampling
draws from an explicit `torch.Generator`; it cannot reproduce `jax.random`'s
stream, so sampled tokens are compared by distribution, never bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = float("-inf")


def top_k(logits: torch.Tensor, thres: float = 0.9, k: Optional[int] = None) -> torch.Tensor:
    """Keep every logit at or above the k-th largest (ties included), with
    k = ceil((1 - thres) * V) unless given."""
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

"""Dropout drawn from an explicit `torch.Generator`.

The JAX package draws dropout from the "dropout" RNG stream that the trainer
folds from (seed, step). Here the trainer makes one generator per step and
enters `dropout_generator(g)` around the forward; every `Dropout` in
`module.train()` mode draws its keep mask from it with `torch.rand`
(`F.dropout` takes no generator). In `module.eval()` mode dropout is the
identity, as `deterministic=True` is in the JAX package.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator, Optional

import torch
from torch import nn

_generator: ContextVar[Optional[torch.Generator]] = ContextVar("dropout_generator", default=None)


@contextmanager
def dropout_generator(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Dropout inside the block draws from `generator` (None: torch's default)."""
    token = _generator.set(generator)
    try:
        yield
    finally:
        _generator.reset(token)


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """flax's nn.Dropout: keep with probability 1-p, scale kept values by 1/(1-p)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=_generator.get(), device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"

"""Dropout drawn from an explicit `torch.Generator`.

The JAX package draws dropout from the "dropout" RNG stream that the trainer
folds from (seed, step). Here the trainer makes one generator per step and
enters `dropout_generator(g)` around the forward; every `Dropout` in
`module.train()` mode draws its keep mask from it with `torch.rand`
(`F.dropout` takes no generator). In `module.eval()` mode dropout is the
identity, as `deterministic=True` is in the JAX package.

On a mesh (`parallel/mesh.py`), a rank draws the mask of the global tensor
and keeps its own block of it: `layout` names the mesh axis each leading
dim is split over (the batch over `data` unless said otherwise), so a step
draws the same masks whatever the number of ranks, as JAX's dropout on a
global array does.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator, Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import DATA_AXIS, current

BATCH_LAYOUT = (DATA_AXIS,)

_generator: ContextVar[Optional[torch.Generator]] = ContextVar("dropout_generator", default=None)


@contextmanager
def dropout_generator(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Dropout inside the block draws from `generator` (None: torch's default)."""
    token = _generator.set(generator)
    try:
        yield
    finally:
        _generator.reset(token)


def uniform(shape, generator: Optional[torch.Generator], device,
            layout: Sequence[Optional[str]] = BATCH_LAYOUT) -> torch.Tensor:
    """U[0, 1) of `shape`: this rank's block of the draw of the global
    shape, the dims split over the mesh axes `layout` names."""
    mesh = current()
    shape = tuple(shape)
    if mesh is None:
        return torch.rand(shape, generator=generator, device=device)
    full, block = list(shape), [slice(None)] * len(shape)
    for dim, axis in enumerate(layout):
        n = 1 if axis is None else mesh.size(axis)
        if n > 1:
            full[dim] = shape[dim] * n
            i = mesh.index(axis)
            block[dim] = slice(i * shape[dim], (i + 1) * shape[dim])
    return torch.rand(full, generator=generator, device=device)[tuple(block)]


def dropout(x: torch.Tensor, p: float, training: bool,
            layout: Sequence[Optional[str]] = BATCH_LAYOUT) -> torch.Tensor:
    """flax's nn.Dropout: keep with probability 1-p, scale kept values by 1/(1-p)."""
    if not training or p == 0.0:
        return x
    keep = uniform(x.shape, _generator.get(), x.device, layout) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.layout = BATCH_LAYOUT  # the mesh axis of each leading dim of x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training, self.layout)

    def extra_repr(self) -> str:
        return f"p={self.p}"

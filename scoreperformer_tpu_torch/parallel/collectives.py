"""Every collective of the port, over an axis of the active mesh.

The process group's backend is `nccl` on CUDA and `gloo` on the CPU (or on
CUDA when asked for: two ranks can share one card only over gloo). gloo
takes every collective used here on CUDA tensors in torch 2.11, with the
right values read at once on the current stream
(`parallel.workers.collective_probe`, which `chip_smoke.py`'s parallel
phase prints), so nothing here stages a tensor through host memory. Each
function is the identity when no mesh is active or its axis has one rank,
so the model runs its one-device code unchanged.

The autograd pairs (Megatron's f and g):
- `copy_to_group`: identity forward, all-reduce of the gradient backward
  (a replicated input whose uses on the ranks each give part of its
  gradient);
- `reduce_from_group`: all-reduce forward, identity backward (partial
  outputs summed);
- `gather_rows`: the ranks' rows concatenated, with a backward that sums
  the gathered gradient over the ranks and keeps the rank's rows (each
  rank holds part of a loss over all the rows).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, current

_timer: Optional[Dict[str, float]] = None


@contextmanager
def collective_timer() -> Iterator[Dict[str, float]]:
    """Inside the block every collective here waits for the device before
    and after it and adds its wall seconds to the yielded dict's "seconds"
    ("calls" counts them): the collectives' share of a step, at the cost
    of two synchronizations a call. Off (no synchronization) outside."""
    global _timer
    prev, _timer = _timer, {"seconds": 0.0, "calls": 0}
    try:
        yield _timer
    finally:
        _timer = prev


def _run(op, x: torch.Tensor) -> None:
    if _timer is None:
        op()
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    op()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    _timer["seconds"] += time.perf_counter() - t0
    _timer["calls"] += 1


def _group(axis: str):
    mesh = current()
    if mesh is None or mesh.size(axis) == 1:
        return None, 1
    return mesh.group(axis), mesh.size(axis)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone()
    _run(lambda: dist.all_reduce(out, group=group), out)
    return out


def _all_gather_list(x: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    x = x.detach().contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    _run(lambda: dist.all_gather(out, x, group=group), x)
    return out


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of `x` over the axis, in a new tensor (no gradient)."""
    group, n = _group(axis)
    return x if n == 1 else _all_reduce(x, group)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated on `dim` in rank order (no gradient)."""
    return torch.cat(all_gather_list(x, axis), dim=dim)


def all_gather_list(x: torch.Tensor, axis: str) -> List[torch.Tensor]:
    group, n = _group(axis)
    return [x] if n == 1 else _all_gather_list(x, group, n)


# The autograd pairs take their group in the forward: a backward may run on
# autograd's device thread, which does not see the active mesh.


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        return torch.cat(_all_gather_list(x, group, n), dim=0)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad.contiguous(), ctx.group)
        return total[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None


def copy_to_group(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _ReduceFromGroup.apply(x, group)


def gather_rows(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _GatherRows.apply(x, group, n, current().index(axis))


# ---- global loss terms over the data axis ----
#
# A rank computes a *partial* of each loss term: a value whose sum over the
# data axis is the term on the global batch, and whose gradients sum to the
# term's gradient. The trainer reports the sum of the partials and
# back-propagates n times the partial loss, averaging the gradients.


def data_total(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the data axis, detached: a count or a weight sum."""
    return all_reduce(x.detach(), DATA_AXIS)


def data_share(x: torch.Tensor) -> torch.Tensor:
    """The partial of a term that every data rank computes whole (over
    gathered rows): the term over the data axis's size."""
    n = _group(DATA_AXIS)[1]
    return x if n == 1 else x / n


def partial_ratio(num: torch.Tensor, den: torch.Tensor, min_den: Optional[float] = None) -> torch.Tensor:
    """The partial of sum(num) / sum(den) over the data axis: this rank's
    numerator over the global denominator (clamped below at `min_den`)."""
    den = data_total(den)
    if min_den is not None:
        den = den.clamp_min(min_den)
    return num / den

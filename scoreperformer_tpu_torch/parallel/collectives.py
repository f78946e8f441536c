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

Sequence parallelism (Megatron-SP; `models/transformer.py`) splits the
residual stream over the model axis on the sequence (dim 1):
- `scatter_seq`: the rank's slice forward, all-gather backward (a stack's
  replicated input enters the split stream); `gather_seq` the reverse (the
  stream leaves it: all-gather forward, the rank's slice backward);
- `gather_seq_to_group`: all-gather forward, reduce-scatter backward (in
  place of `copy_to_group` before a column-split projection);
- `reduce_scatter_seq`: reduce-scatter forward, all-gather backward (in
  place of `reduce_from_group` after a row-split projection).

The pipeline (`parallel/pipeline.py`) moves a stage's activations with
`pipe_shift`, the counterpart of `lax.ppermute(y, "pipe", [(i, i+1)])`
built on `all_to_all_single` (every pipe rank joins it, sending to one
neighbour at most), and replicates the last stage's outputs with
`replicate_last_stage`, the masked psum: an autograd pair whose backward
keeps the last rank's own gradient (zeros elsewhere), so a loss that every
pipe rank computes from the replicated output counts once. The schedule's
own autograd Function runs `pipe_shift` backward as the reverse hop.
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


def _reduce_scatter_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the ranks of `x`, this rank's block of it on `dim`."""
    xt = x.detach().movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    _run(lambda: reduce_scatter(out, xt, group=group), xt)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).contiguous()


def pipe_shift(x: Optional[torch.Tensor], group, n: int, index: int, step: int, send: bool, receive: bool,
               like: torch.Tensor) -> Optional[torch.Tensor]:
    """One hop along a pipe axis of n ranks: this rank (at `index`) sends
    `x` to rank index + step when `send`, and returns what rank index -
    step sent when `receive` (a tensor shaped as `like`), else None. Every
    rank of the axis calls it together (`all_to_all_single`, empty blocks
    where nothing moves)."""
    numel = like.numel()
    out_sizes, in_sizes = [0] * n, [0] * n
    if send:
        in_sizes[index + step] = numel
    if receive:
        out_sizes[index - step] = numel
    src = x.detach().reshape(-1).contiguous() if send else like.new_empty(0)
    out = like.new_empty(numel if receive else 0)
    _run(lambda: dist.all_to_all_single(out, src, out_sizes, in_sizes, group=group), like)
    return out.view_as(like) if receive else None


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


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.n = group, n
        return _block(x, n, index, 1)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_all_gather_list(grad, ctx.group, ctx.n), dim=1), None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.n, ctx.index = n, index
        return torch.cat(_all_gather_list(x, group, n), dim=1)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.n, ctx.index, 1), None, None, None


class _GatherSeqToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return torch.cat(_all_gather_list(x, group, n), dim=1)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, ctx.group, ctx.n, 1), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter_dim(x, group, n, 1)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_all_gather_list(grad, ctx.group, ctx.n), dim=1), None, None


class _ReplicateLastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, last):
        ctx.last = last
        return _all_reduce(x if last else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None, None


def scatter_seq(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _ScatterSeq.apply(x, group, n, current().index(axis))


def gather_seq(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _GatherSeq.apply(x, group, n, current().index(axis))


def gather_seq_to_group(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _GatherSeqToGroup.apply(x, group, n)


def reduce_scatter_seq(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, n = _group(axis)
    return x if n == 1 else _ReduceScatterSeq.apply(x, group, n)


def seq_block(x: torch.Tensor, axis: str) -> torch.Tensor:
    """This rank's slice of `x` (no gradient to pass: a mask) on the sequence."""
    _, n = _group(axis)
    return x if n == 1 else _block(x, n, current().index(axis), 1)


def replicate_last_stage(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The last rank's `x` on every rank of the axis (the masked psum)."""
    group, n = _group(axis)
    return x if n == 1 else _ReplicateLastStage.apply(x, group, current().index(axis) == n - 1)


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

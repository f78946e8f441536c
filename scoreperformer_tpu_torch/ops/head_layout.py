"""The head widths the hand-written attention kernels are built for, and the
layout that takes every other head dim through them.

The flash kernels and `prefix_attend` are instantiated at head dims 16, 32,
64 and 128 (the `case` labels of their `.cu` dispatch switches). A head dim
d below 128 runs at the least of those widths at or above it, w = `kernel_head_dim(d)`,
with zero columns d..w-1: a zero column adds an exact 0 to every q.k and
gives 0 in P.V, so the first d columns are the same function of the real
inputs, and the padded ones are dropped. Decode caches in this layout hold
each head's rows at width w, the zero columns written with the rows.

Tensors on a CUDA device take this layout (`kernel_layout`); tensors on the
CPU run the plain versions at their own width. `kernel_layout` is the one
place that choice is made, so a test may force the padded layout on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are built for
ABOVE_128 = "ROADMAP.md section 2, queue item 'Head dims above 128'"


def kernel_head_dim(d: int) -> int:
    """The least head dim the kernels are built for at or above `d`."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"head dim {d}: the attention kernels take head dims up to {KERNEL_HEAD_DIMS[-1]} "
                     f"({ABOVE_128})")


def kernel_layout(device) -> bool:
    """Whether tensors on `device` run the kernels, at their built head widths."""
    return torch.device(device).type == "cuda"


def head_width(d: int, device) -> int:
    """Per-head width of a decode cache for heads of `d` on `device`."""
    return kernel_head_dim(d) if kernel_layout(device) else d


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """`x` (..., d) with zero columns up to `width`, as a new contiguous
    tensor (x itself when d is `width`)."""
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))

"""In-place KV-cache row writes for the decode loop.

Counterpart of scoreperformer_tpu/ops/kv_cache.py. Caches are TIME-MAJOR,
(cap, batch, kv_dim), so the rows written by one decode step are contiguous.
On CUDA tensors `write_kv` (one cache) and `write_kv_pair` (a layer's K and
V caches at one start, which the decode steps call) launch the hand-written
kernel of `csrc/kv_cache.cu`, once a call; on CPU tensors they run
`write_kv_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._build import kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(cache: torch.Tensor, new: torch.Tensor) -> None:
    if cache.ndim != 3 or new.ndim != 3 or cache.shape[1:] != new.shape[1:]:
        raise ValueError(f"write_kv: cache {tuple(cache.shape)} and new {tuple(new.shape)} must be (cap|n, b, kv)")
    if new.shape[0] > cache.shape[0]:
        raise ValueError(f"write_kv: {new.shape[0]} rows do not fit a cache of {cache.shape[0]}")


def write_kv_plain(cache: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Plain version: rows [index, index+n) of `cache` = `new`, in place. As
    in jax.lax.dynamic_update_slice, a negative start counts from the end
    (adds cap), and the start is then clamped to [0, cap-n]."""
    _check(cache, new)
    cap, n = cache.shape[0], new.shape[0]
    start = int(index)
    start = min(max(start + cap if start < 0 else start, 0), cap - n)
    cache[start : start + n] = new.to(cache.dtype)
    return cache


def _launch(what: str, pairs, index) -> None:
    """One launch of the kernel over the (cache, new) `pairs`, which share
    shapes and dtypes."""
    cache, new = pairs[0]
    if not isinstance(index, torch.Tensor) or index.numel() != 1 or index.dtype != torch.int64:
        raise TypeError(f"{what}: on CUDA, index must be a one-element int64 tensor")
    if index.device != cache.device:
        raise ValueError(f"{what}: index is on {index.device}, cache on {cache.device}")
    for c, x in pairs:
        _check(c, x)
        if (c.shape, x.shape, c.dtype, x.dtype) != (cache.shape, new.shape, cache.dtype, new.dtype):
            raise ValueError(f"{what}: the K and V writes differ in shape or dtype")
        if c.device != cache.device or x.device != cache.device:
            raise ValueError(f"{what}: tensors on {c.device}/{x.device} and {cache.device}")
        if not (c.is_contiguous() and x.is_contiguous()):
            raise ValueError(f"{what}: caches and new rows must be contiguous")
    if cache.dtype not in _DTYPE_CODES or new.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtypes {cache.dtype}/{new.dtype} not in {list(_DTYPE_CODES)}")
    (c0, x0), (c1, x1) = pairs[0], pairs[-1]
    cap, b, kv = cache.shape
    err = kernel("kv_cache", "sp_write_kv")(
        c0.data_ptr(), x0.data_ptr(), c1.data_ptr(), x1.data_ptr(), len(pairs), index.data_ptr(),
        cap, new.shape[0], b * kv, _DTYPE_CODES[cache.dtype], _DTYPE_CODES[new.dtype],
        torch.cuda.current_stream(cache.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")


def _on_cuda(what: str, cache: torch.Tensor) -> bool:
    if cache.device.type == "cpu":
        return False
    if cache.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {cache.device}")
    return True


def write_kv(cache: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Write `new` (n, batch, kv_dim) into `cache` (cap, batch, kv_dim) at rows
    [index, index+n), IN PLACE, and return `cache`.

    On CUDA, `index` is a one-element int64 tensor on the cache's device; the
    kernel reads it there, so the call never waits for the host."""
    if not _on_cuda("write_kv", cache):
        return write_kv_plain(cache, new, index)
    _launch("write_kv", [(cache, new)], index)
    write_kv.launches += 1
    return cache


def write_kv_pair(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  index) -> Tuple[torch.Tensor, torch.Tensor]:
    """`write_kv` of a layer's K rows and V rows at the same start, IN PLACE,
    in one kernel launch on CUDA; returns (k_cache, v_cache). The two caches
    share their shape and dtype, and so do the two row blocks."""
    if not _on_cuda("write_kv_pair", k_cache):
        return write_kv_plain(k_cache, k_new, index), write_kv_plain(v_cache, v_new, index)
    _launch("write_kv_pair", [(k_cache, k_new), (v_cache, v_new)], index)
    write_kv_pair.launches += 1
    return k_cache, v_cache


write_kv.launches = 0
write_kv_pair.launches = 0

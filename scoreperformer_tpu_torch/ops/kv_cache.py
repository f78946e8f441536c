"""In-place KV-cache row writes for the decode loop.

Counterpart of scoreperformer_tpu/ops/kv_cache.py. Caches are TIME-MAJOR,
(cap, batch, kv_dim), so the rows written by one decode step are contiguous.
On a CUDA tensor `write_kv` launches the hand-written kernel of
`csrc/kv_cache.cu`; on a CPU tensor it runs `write_kv_plain`, the same
function in plain PyTorch.
"""
from __future__ import annotations

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


def write_kv(cache: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Write `new` (n, batch, kv_dim) into `cache` (cap, batch, kv_dim) at rows
    [index, index+n), IN PLACE, and return `cache`.

    On CUDA, `index` is a one-element int64 tensor on the cache's device; the
    kernel reads it there, so the call never waits for the host."""
    if cache.device.type == "cpu":
        return write_kv_plain(cache, new, index)
    if cache.device.type != "cuda":
        raise ValueError(f"write_kv: unsupported device {cache.device}")
    _check(cache, new)
    if not isinstance(index, torch.Tensor) or index.numel() != 1 or index.dtype != torch.int64:
        raise TypeError("write_kv: on CUDA, index must be a one-element int64 tensor")
    for name, t in (("new", new), ("index", index)):
        if t.device != cache.device:
            raise ValueError(f"write_kv: {name} is on {t.device}, cache on {cache.device}")
    if cache.dtype not in _DTYPE_CODES or new.dtype not in _DTYPE_CODES:
        raise TypeError(f"write_kv: dtypes {cache.dtype}/{new.dtype} not in {list(_DTYPE_CODES)}")
    if not (cache.is_contiguous() and new.is_contiguous()):
        raise ValueError("write_kv: cache and new must be contiguous")
    cap, b, kv = cache.shape
    err = kernel("kv_cache")(
        cache.data_ptr(), new.data_ptr(), index.data_ptr(), cap, new.shape[0], b * kv,
        _DTYPE_CODES[cache.dtype], _DTYPE_CODES[new.dtype],
        torch.cuda.current_stream(cache.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"write_kv: kernel launch failed with CUDA error {err}")
    write_kv.launches += 1
    return cache


write_kv.launches = 0

"""Decode attention over the frozen prefix cache, and the logsumexp combine.

Counterpart of scripts/exp_pallas_decode_attend.py: `pallas_prefix_attend`
(the Pallas `_prefix_attend_kernel`) and the combine of `hybrid_attend`, the
split that `models/attention.py::Attention._chunked_cache_attend` runs every
chunked decode step: the prefix half here, the fresh chunk's half in torch,
joined by `combine_lse`. On CUDA tensors `prefix_attend` launches the
hand-written kernel of `csrc/prefix_attend.cu`, one launch whose blocks take
the slots in tiles, split across a cluster that merges them; on CPU tensors
it runs `prefix_attend_plain`, the same function in plain PyTorch.

Unlike the TPU kernel, which wanted the cache relaid as (cap, d, b), both
take the cache in its own time-major layout, (cap, b, kv_heads * d), in
fp32, bf16 or int8 with (cap, b) row scales, folded as the JAX attention
folds them: the key scale multiplies the dots, the value scale the
probabilities before the value product.

On CUDA tensors the cache takes the kernels' head layout (`head_layout.py`):
each KV head's columns at the built width w at or above the head dim d, the
columns past d zero. q (b, h, d) is zero-padded to w here and o cut back to
d. The kernel is built for 1, 2, 4 or 8 query heads a KV head: with one KV
head per query head it runs at 1 whatever h is; over one KV head the query
heads go in groups of 8, one launch a group, the last group padded with
zero query and bias rows up to the next of 1, 2, 4, 8, whose outputs are
dropped.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import head_layout
from ._build import kernel
from .head_layout import KERNEL_HEAD_DIMS, kernel_head_dim

MASK_VALUE = -1e9  # the Pallas kernel's running max starts here
KERNEL_HEADS = (1, 2, 4, 8)  # the kernel's head-count template parameter
MAX_CLUSTER = 16  # blocks a cluster: the kernel's splits of one (batch row, KV head)
# the kernel's tiles (csrc/prefix_attend.cu: kTileKBytes, kMaxPairs, tile_slots)
TILE_K_BYTES = 16384
MAX_PAIRS = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SM_COUNT: Dict[int, int] = {}  # per device index, read once


def _check(q, pk, pv, bias, k_s, v_s, n_valid, width=None):
    """(b, h, d, cap, kv heads) after checking the shapes; the cache holds
    each KV head at `width` columns (d by default)."""
    if q.ndim != 3 or pk.ndim != 3 or pk.shape != pv.shape:
        raise ValueError(f"prefix_attend: q {tuple(q.shape)}, pk {tuple(pk.shape)}, pv {tuple(pv.shape)}")
    b, h, d = q.shape
    cap = pk.shape[0]
    width = width or d
    kvh = pk.shape[2] // width
    if pk.shape[1] != b or kvh * width != pk.shape[2] or kvh not in (1, h):
        raise ValueError(f"prefix_attend: cache {tuple(pk.shape)} does not fit q {tuple(q.shape)} at "
                         f"{width} columns a head")
    if bias.shape != (h, cap):
        raise ValueError(f"prefix_attend: bias {tuple(bias.shape)}, expected ({h}, {cap})")
    if (k_s is None) != (v_s is None) or (k_s is not None) != (pk.dtype == torch.int8):
        raise ValueError("prefix_attend: an int8 cache needs both row scales, other caches none")
    for s in (k_s, v_s):
        if s is not None and s.shape != (cap, b):
            raise ValueError(f"prefix_attend: row scales {tuple(s.shape)}, expected ({cap}, {b})")
    if n_valid is not None and not 0 <= int(n_valid) <= cap:
        raise ValueError(f"prefix_attend: n_valid={n_valid} outside [0, {cap}]")
    return b, h, d, cap, kvh


def prefix_attend_plain(q, pk, pv, bias, k_s=None, v_s=None, n_valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (o (b, h, d), lse (b, h)) over the first `n_valid`
    slots (all by default), with the running max floored at -1e9 and an
    empty sum giving o = 0, as in the Pallas kernel."""
    b, h, d, cap, kvh = _check(q, pk, pv, bias, k_s, v_s, n_valid)
    n = cap if n_valid is None else int(n_valid)
    k = pk[:n].float().reshape(n, b, kvh, d)
    v = pv[:n].float().reshape(n, b, kvh, d)
    qh = q.float().reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bgrd,nbgd->bgrn", qh, k).reshape(b, h, n)
    if k_s is not None:
        s = s * k_s[:n].T[:, None, :]
    s = s + bias[:, :n].float()[None]
    m = torch.full((b, h), MASK_VALUE, device=q.device)
    if n:
        m = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if v_s is not None:
        p = p * v_s[:n].T[:, None, :]
    acc = torch.einsum("bgrn,nbgd->bgrd", p.reshape(b, kvh, h // kvh, n), v).reshape(b, h, d)
    safe_l = torch.where(l == 0, 1.0, l)
    return acc / safe_l[..., None], m + torch.log(safe_l)


def combine_lse(o_p, lse_p, o_f, lse_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """Join two softmax halves over disjoint keys (`hybrid_attend`'s combine):
    o (..., d) and lse (...) of each half -> (o, lse) of the whole."""
    lse = torch.logaddexp(lse_p, lse_f)
    o = o_p * torch.exp(lse_p - lse)[..., None] + o_f * torch.exp(lse_f - lse)[..., None]
    return o, lse


def tile_slots(d: int, element_size: int, heads_per_kv: int) -> int:
    """Slots a tile of the kernel at head dim d, cache elements of
    `element_size` bytes and `heads_per_kv` query heads a KV head: its K rows
    TILE_K_BYTES, 64 to 128 slots, at most MAX_PAIRS (head, slot) pairs."""
    return min(max(64, min(128, TILE_K_BYTES // (d * element_size))), MAX_PAIRS // heads_per_kv)


def split_plan(units: int, n_slots: int, tile: int, sm_count: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the kernel's grid for `units` (batch row,
    KV head) pairs over `n_slots` slots in tiles of `tile`: tile i goes to
    split i // per, and the splits of a unit form one cluster of at most
    MAX_CLUSTER blocks. A unit splits only while the grid has at most one
    block an SM: a split costs a merge that more tiles a block do not (the
    served batch, 128 units of 3 tiles, ran 0.0079 ms in one split and 0.0097
    in two, `chip_probe_decode.py` on an H100). No split is empty unless
    there is no slot."""
    n_tiles = -(-n_slots // tile)
    want = min(MAX_CLUSTER, max(1, sm_count // units), max(1, n_tiles))
    per = max(1, -(-n_tiles // want))
    return max(1, -(-n_tiles // per)), per


def grid_plan(device: torch.device, units: int, n_slots: int, d: int, heads_per_kv: int,
              dtype: torch.dtype) -> Tuple[int, int, int]:
    """(tile, splits, tiles per split) of the kernel on CUDA device `device`;
    its SM count is read on the first call and kept."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    tile = tile_slots(d, dtype.itemsize, heads_per_kv)
    return (tile, *split_plan(units, n_slots, tile, _SM_COUNT[index]))


def prefix_attend(
    q: torch.Tensor,  # (b, h, d), scale folded in
    pk: torch.Tensor,  # (cap, b, kv_heads * d): fp32, bf16 or int8
    pv: torch.Tensor,
    bias: torch.Tensor,  # (h, cap) additive: ALiBi, -1e9 on stale slots
    k_s: Optional[torch.Tensor] = None,  # (cap, b) row scales of an int8 cache
    v_s: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,  # slots at or past it have weight 0 and are not read
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of one query row per (batch, head) over the prefix cache: the
    tiled, clustered split-K kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if not head_layout.kernel_layout(q.device):
        return prefix_attend_plain(q, pk, pv, bias, k_s, v_s, n_valid)
    d = q.shape[-1]
    width = kernel_head_dim(d)
    b, h, _, cap, kvh = dims = _check(q, pk, pv, bias, k_s, v_s, n_valid, width)
    if width == d and h // kvh in KERNEL_HEADS:
        return _attend(q, pk, pv, bias, k_s, v_s, n_valid, dims)
    parts = []
    for g0, n, rows in launch_groups(h, kvh):
        extra = 0 if kvh == h else rows - n  # zero query and bias rows, dropped below
        qg, bg = q[:, g0 : g0 + n], bias[g0 : g0 + n]
        qg = F.pad(qg, (0, width - d, 0, extra)) if width > d or extra else qg.contiguous()
        if extra:
            bg = F.pad(bg, (0, 0, 0, extra))
        o, lse = _attend(qg, pk, pv, bg, k_s, v_s, n_valid, (b, n + extra, width, cap, kvh))
        parts.append((o[:, :n, :d], lse[:, :n]))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([o for o, _ in parts], dim=1), torch.cat([lse for _, lse in parts], dim=1)


def launch_groups(h: int, kv_heads: int):
    """`prefix_attend`'s launches over h query heads on CUDA tensors, as
    (first head, heads, query heads a KV head in the launch) each: with a KV
    head per query head one launch at 1; over one KV head groups of 8, the
    last padded with zero rows up to the next of `KERNEL_HEADS`."""
    if kv_heads == h:
        return [(0, h, 1)]
    group = KERNEL_HEADS[-1]
    return [(g0, n, next(r for r in KERNEL_HEADS if r >= n))
            for g0 in range(0, h, group) for n in (min(group, h - g0),)]


def _attend(q, pk, pv, bias, k_s, v_s, n_valid, dims=None):
    """One launch of the kernel over q's heads, at a head dim and a count of
    heads a KV head it is built for (the plain version on CPU tensors);
    `dims` is `_check`'s answer where the caller has it."""
    if q.device.type == "cpu":
        return prefix_attend_plain(q, pk, pv, bias, k_s, v_s, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"prefix_attend: unsupported device {q.device}")
    b, h, d, cap, kvh = dims or _check(q, pk, pv, bias, k_s, v_s, n_valid)
    if d not in KERNEL_HEAD_DIMS or h // kvh not in KERNEL_HEADS:
        raise ValueError(f"prefix_attend: the kernel takes head dims {KERNEL_HEAD_DIMS} and {KERNEL_HEADS} "
                         f"query heads a KV head, got d={d}, h={h}, kv_heads={kvh}")
    if pk.dtype not in _DTYPE_CODES or pv.dtype != pk.dtype:
        raise TypeError(f"prefix_attend: cache dtypes {pk.dtype}/{pv.dtype} not in {list(_DTYPE_CODES)}")
    scales = [s for s in (k_s, v_s) if s is not None]
    for t in [q, bias] + scales:
        if t.dtype != torch.float32:
            raise TypeError(f"prefix_attend: q, bias and row scales must be float32, got {t.dtype}")
    for t in [q, pk, pv, bias] + scales:
        if t.device != q.device:
            raise ValueError(f"prefix_attend: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("prefix_attend: inputs must be contiguous")
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("prefix_attend: the cache must be 16-byte aligned")
    n = cap if n_valid is None else int(n_valid)
    tile, splits, per = grid_plan(q.device, b * kvh, n, d, h // kvh, pk.dtype)
    o = torch.empty(b, h, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, h, dtype=torch.float32, device=q.device)
    err = kernel("prefix_attend", "sp_prefix_attend")(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), bias.data_ptr(),
        k_s.data_ptr() if k_s is not None else None, v_s.data_ptr() if v_s is not None else None,
        o.data_ptr(), lse.data_ptr(), b, h, kvh, d, cap, n, splits, per, tile, _DTYPE_CODES[pk.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        what = ("a tile the kernel does not take" if err == -1 else
                f"no tensor map for the cache (CUresult {-1000 - err})" if err <= -1000 else f"CUDA error {err}")
        raise RuntimeError(f"prefix_attend: kernel launch failed at b={b}, h={h}, d={d}, kv_heads={kvh}, cap={cap}, "
                           f"n_valid={n}, {pk.dtype}, tile {tile}, {splits} splits of {per} tiles: {what}")
    prefix_attend.launches += 1
    return o, lse


prefix_attend.launches = 0

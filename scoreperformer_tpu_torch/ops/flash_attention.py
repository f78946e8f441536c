"""Flash attention with ALiBi generated inside the kernels, forward and backward.

Counterpart of scoreperformer_tpu/ops/flash_attention.py. On CUDA tensors
`flash_attention_alibi` launches the hand-written forward kernel and, for the
gradient, the dK/dV and dQ/dslope kernels, inside one
`torch.autograd.Function`: those of `csrc/flash_attention_fwd.cu` and
`csrc/flash_attention_bwd.cu` for fp32 operands, of
`csrc/flash_attention_fwd_bf16.cu` and `csrc/flash_attention_bwd_bf16.cu`
for bf16 ones; none of them materializes the (h, t, t) bias or score
tensors. On CPU tensors the same Function runs `flash_attention_plain`
and `flash_attention_bwd_plain`, the same functions in plain PyTorch. All keep
the TPU kernels' order of operations: q is scaled before the forward's dot
and S after the backward's, the bias is -slope*|i-j|, masked scores are
-1e30, the softmax sum is clamped at 1e-30, P is recomputed from the saved
logsumexp, all in fp32.

`precision` takes the Pallas kernels' names. Their products run at
whatever `precision` they are given, and JAX's model calls them with none,
so at "default": on the TPU each dot's operands are rounded to bf16 and
their products summed in fp32 (one MXU pass; "highest" is what the JAX
parity tests ask for). Here "default" follows PyTorch's counterpart of a
device's default matmul precision (`precision_is_one_pass`):
- under `torch.set_float32_matmul_precision("medium")` it is the one-pass
  route, the TPU's DEFAULT numerics: S = bf16(q*scale).bf16(k) in the
  forward, (bf16(q).bf16(k))*scale in the backward, P.V, P^T.dO, dO.V^T,
  dS^T.q and dS.K each one product of bf16 operands summed in fp32, dS and
  the slope gradient from the unrounded fp32 values. On CUDA tensors the
  one-pass kernels (`csrc/flash_attention_fwd_one_pass.cu` and
  `csrc/flash_attention_bwd_one_pass.cu`: the bf16 `wgmma` kernels with P
  and dS one bf16 term) run it and write fp32 or bf16 outputs as their
  inputs are. They read fp32 or bf16 operands as the wrappers receive them
  and round them to bf16 inside (the bits of `.to(torch.bfloat16)`), the
  forward's q after the scale (the bits of `(q.float() * scale).to(
  torch.bfloat16)`): no wrapper makes a copy;
- under "high" or "highest" (PyTorch's default), and for "high" and
  "highest", the fp32-accurate kernels run: fp32 operands take every
  product in split TF32, three TF32 `wgmma` products each, within about
  2^-21 of fp32; bf16 operands take S and dP as single bf16 `wgmma`
  products, exact in fp32, and P and dS in three bf16 terms each. That is
  at least the TPU's HIGH (bf16_3x).
The mode is resolved once in the forward and kept for its backward. A
one-pass launch counts in each wrapper's `launches_one_pass`.

q, k, v and the output gradient may be bf16 (a model held in bf16 gives
them), as the Pallas kernels take them: the arithmetic stays fp32, the output is written in q's
dtype, the gradients in their inputs' dtypes (dslopes in the slopes'), lse in
fp32, and delta = rowsum(dout * out) is taken in the residuals' dtype, as the
JAX wrapper takes it. A bf16 launch counts in `launches_bf16`, an fp32 one in
`launches`.

Head dims other than the kernels' built widths, up to 128, take the kernels
at the next built width (`head_layout.py`): q, k, v (and dout) are
zero-padded along d, o, dq, dk and dv sliced back; the scale stays that of
the real d, and lse and dslopes do not change.

A query row whose keys are all masked gets the JAX wrapper's answer: that
wrapper pads keys to whole blocks with mask 0, so the row averages v over
every key of the blocks it visits (`jax_masked_row_keys`), not over t keys.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import head_layout
from ._build import kernel
from .head_layout import KERNEL_HEAD_DIMS, kernel_head_dim, pad_head_dim

# the names of JAX's `_PRECISIONS` (scoreperformer_tpu/ops/flash_attention.py:42-46)
PRECISIONS = ("default", "high", "highest")
# keys of a tile of the bf16 forward kernel (csrc/flash_attention_fwd_bf16.cu
# kRows), against whose running max its one-pass instances round P
ONE_PASS_KEY_TILE = 64
NEG_INF = -1.0000000150474662e30  # -1e30 in fp32, so that fp64 references subtract it exactly as the kernels do
BLOCK_ROWS = 64  # (head, position) rows per block of the dQ kernel


def dq_slope_parts(b: int, h: int, hk: int, tq: int):
    """Shape (b, h, blocks) of the dQ kernel's slope-gradient parts: one per
    head a block holds. With one KV head and h dividing 64 a block holds all
    h heads at 64/h positions, else 64 positions of one head
    (`launch_dq` of csrc/flash_attention_bwd.cu and of
    csrc/flash_attention_bwd_bf16.cu)."""
    positions = BLOCK_ROWS // h if hk == 1 and h > 1 and BLOCK_ROWS % h == 0 else BLOCK_ROWS
    return (b, h, -(-tq // positions))


def _check(q, k, v, slopes, mask):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] not in (1, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if slopes.shape != (h,):
        raise ValueError(f"flash_attention: slopes {tuple(slopes.shape)}, expected ({h},)")
    if mask is not None and mask.shape != (b, k.shape[2]):
        raise ValueError(f"flash_attention: mask {tuple(mask.shape)}, expected ({b}, {k.shape[2]})")


def jax_masked_row_keys(tq: int, tk: int, causal: bool, device=None) -> torch.Tensor:
    """(tq,) number of keys the JAX wrapper averages v over for a query row
    with no valid key: its key blocks of bk = max(128, min(256, tk)), all of
    them, or with `causal` those up to the end of the row's query block of
    bq = max(8, min(256, tq)) rows (scoreperformer_tpu/ops/flash_attention.py:
    266-273 and :105-108)."""
    bk = max(128, min(256, tk))
    n_kb = -(-tk // bk)
    if not causal:
        return torch.full((tq,), n_kb * bk, dtype=torch.int64, device=device)
    bq = max(8, min(256, tq))
    q_end = (torch.arange(tq, device=device) // bq + 1) * bq
    return torch.clamp((q_end + bk - 1) // bk, max=n_kb) * bk


def _acc(x):
    """x in the plain versions' arithmetic type: fp32, or fp64 for fp64
    inputs (a reference for the kernels' long sums, in chip_smoke.py)."""
    return x.double() if x.dtype == torch.float64 else x.float()


def _fp32_products(fn):
    """`fn` with PyTorch's fp32 matrix products at full precision whatever
    the global setting: the plain versions are the kernels' reference, and
    under `torch.set_float32_matmul_precision("medium")` PyTorch takes fp32
    products in bf16 on the CPU and TF32 on the card."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = torch.get_float32_matmul_precision()
        if saved == "highest":
            return fn(*args, **kwargs)
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(saved)

    return wrapped


def _operand(x, one_pass):
    """A dot's operand x in the plain versions' arithmetic type, rounded to
    bf16 (to nearest, ties to even) first in the one-pass mode, as the TPU's
    DEFAULT precision rounds every dot's operands."""
    a = _acc(x)
    return a.to(torch.bfloat16).to(a.dtype) if one_pass else a


def _valid(b, tq, tk, mask, causal, device):
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    valid = torch.ones(b, 1, 1, tk, dtype=torch.bool, device=device)
    if mask is not None:
        valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & (j <= i)
    return valid, (j - i).abs().float()


def _scores(q, k, slopes, mask, causal, scale, one_pass=False, recompute=False):
    """Masked scores (b, h, tq, tk) and the distances |i-j| (tq, tk). In the
    one-pass mode the forward's S is bf16(q*scale).bf16(k) (`_flash_kernel`
    scales q before the dot) and the backward's recomputed one (`recompute`)
    (bf16(q).bf16(k))*scale (`_recompute_p` scales after it)."""
    b, _, tq, _ = q.shape
    tk = k.shape[2]
    if not one_pass:
        s = (_acc(q) * scale) @ _acc(k).transpose(-1, -2)  # hk=1 broadcasts
    elif recompute:
        s = (_operand(q, True) @ _operand(k, True).transpose(-1, -2)) * scale
    else:
        s = _operand(_acc(q) * scale, True) @ _operand(k, True).transpose(-1, -2)
    valid, dist = _valid(b, tq, tk, mask, causal, q.device)
    dist = dist.to(s.dtype)
    s = s - _acc(slopes)[None, :, None, None] * dist
    return torch.where(valid, s, NEG_INF), dist


@_fp32_products
def flash_attention_plain(q, k, v, slopes, mask=None, causal=True, scale=None, return_lse=False, one_pass=False):
    """Plain version of the forward: the whole (b, h, tq, tk) score tensor at
    once. `one_pass`: the TPU's DEFAULT numerics (S and P.V each one product
    of bf16-rounded operands, summed in fp32), P rounded against the running
    max of the one-pass kernel's key tiles (`_one_pass_tiles`), else
    fp32-accurate."""
    _check(q, k, v, slopes, mask)
    tq, d = q.shape[2], q.shape[3]
    tk = k.shape[2]
    scale = scale if scale is not None else d**-0.5
    s, _ = _scores(q, k, slopes, mask, causal, scale, one_pass)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    # rows with no valid key: v averaged over the JAX wrapper's padded keys
    none_valid = m == NEG_INF
    if bool(none_valid.any()):
        keys = jax_masked_row_keys(tq, tk, causal, q.device)[:, None]
        p = torch.where(none_valid, (torch.arange(tk, device=q.device)[None, :] < keys).to(p.dtype), p)
        l = torch.where(none_valid, keys.to(l.dtype), l)
    out = (_operand(p, one_pass) @ _operand(v, one_pass)) / l
    if one_pass:
        tiled, m_tiled, l_tiled = _one_pass_tiles(s, v)
        out = torch.where(none_valid, out, tiled)
        m, l = torch.where(none_valid, m, m_tiled), torch.where(none_valid, l, l_tiled)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _one_pass_tiles(s, v):
    """(o, m, l) of the online softmax over the masked scores `s` in key
    tiles of ONE_PASS_KEY_TILE, in order, as the one-pass forward kernel
    walks them: each tile's P = exp(s - m) against the running max m,
    rounded to bf16 for P.V, and the running sums rescaled by exp(m_old -
    m_new). For a row with a valid key this is the kernel's arithmetic;
    rows with none are the caller's."""
    tk = s.shape[-1]
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, dtype=s.dtype, device=s.device)
    l = torch.zeros_like(m)
    acc = None
    for t0 in range(0, tk, ONE_PASS_KEY_TILE):
        st = s[..., t0:t0 + ONE_PASS_KEY_TILE]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.exp(st - m_new)
        alpha = torch.exp(m - m_new)
        tile = _operand(p, True) @ _operand(v[..., t0:t0 + ONE_PASS_KEY_TILE, :], True)
        acc = tile if acc is None else alpha * acc + tile
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        m = m_new
    return acc / l.clamp_min(1e-30), m, l.clamp_min(1e-30)


def _bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass):
    s, dist = _scores(q, k, slopes, mask, causal, scale, one_pass, recompute=True)
    p = torch.exp(s - lse[..., None])
    if causal:
        # a row with no valid key has lse = -1e30, so P = 1 on every key the
        # JAX kernels visit for it: the key blocks up to its query block's end
        tq, tk = s.shape[-2:]
        keys = jax_masked_row_keys(tq, tk, True, q.device)
        p = torch.where(torch.arange(tk, device=q.device)[None, :] < keys[:, None], p, 0.0)
    ds = p * (_operand(dout, one_pass) @ _operand(v, one_pass).transpose(-1, -2) - delta[..., None])
    return p, ds, dist


def padded_key_dslopes(lse, delta, tq: int, tk: int, causal: bool) -> Optional[torch.Tensor]:
    """(h,) part of the slope gradient that the JAX wrapper's padded keys add,
    or None when it pads no key. On a row with no valid key P = exp(-1e30 -
    lse) = 1 on every key its blocks visit, the padded ones past t_k too;
    there v = 0, so dS = -P * delta, and dS * (-|i-j|) sums to
    P * delta * sum_j |i-j| over the row's padded keys. On every other row P
    is 0 there. (scoreperformer_tpu/ops/flash_attention.py:362-372, :117-132.)"""
    bk = max(128, min(256, tk))
    n_pad = -(-tk // bk) * bk - tk
    if n_pad == 0:
        return None
    dev = lse.device
    keys = jax_masked_row_keys(tq, tk, causal, dev)[:, None]
    j = tk + torch.arange(n_pad, device=dev)[None, :]
    dist = torch.where(j < keys, (j - torch.arange(tq, device=dev)[:, None]).abs(), 0).sum(-1).float()
    p = torch.exp(NEG_INF - _acc(lse))
    return (p * _acc(delta) * dist.to(p.dtype)).sum(dim=(0, 2))


def _sum_kv_heads(x, hk):
    """x summed over the query heads when there is one KV head: one add a
    head in head order, so that the sum's bits do not depend on the head
    dim (a zero-padded one gives the same columns)."""
    if hk != 1:
        return x
    out = x[:, :1]
    for i in range(1, x.shape[1]):
        out = out + x[:, i : i + 1]
    return out


@_fp32_products
def flash_attention_bwd_dkv_plain(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None,
                                  one_pass=False):
    """Plain version of the dK/dV kernel: (dk, dv), summed over the query heads
    when there is one KV head. `one_pass`: every dot's operands rounded to
    bf16 (`_flash_bwd_dkv_kernel` at DEFAULT: dV = bf16(P)^T.bf16(dO), dK =
    (bf16(dS)^T.bf16(q))*scale)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds, _ = _bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
    dv = _operand(p, one_pass).transpose(-1, -2) @ _operand(dout, one_pass)
    if one_pass:
        dk = (_operand(ds, True).transpose(-1, -2) @ _operand(q, True)) * scale
    else:
        dk = ds.transpose(-1, -2) @ (_acc(q) * scale)
    hk = k.shape[1]
    return _sum_kv_heads(dk, hk).to(k.dtype), _sum_kv_heads(dv, hk).to(v.dtype)


@_fp32_products
def flash_attention_bwd_dq_plain(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None,
                                 one_pass=False):
    """Plain version of the dQ/dslope kernel: (dq, dslopes), dslopes summed
    over the batch. `one_pass`: dQ = (bf16(dS).bf16(K))*scale
    (`_flash_bwd_dq_kernel` at DEFAULT); dslopes from the unrounded dS."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, dist = _bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
    dq = (_operand(ds, one_pass) @ _operand(k, one_pass)) * scale
    dslopes = (ds * -dist).sum(dim=(0, 2, 3))
    padded = padded_key_dslopes(lse, delta, q.shape[2], k.shape[2], causal)
    if padded is not None:
        dslopes = dslopes + padded
    return dq.to(q.dtype), dslopes.to(slopes.dtype)


def flash_attention_bwd_plain(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None, one_pass=False):
    """Plain backward: (dq, dk, dv, dslopes) from the saved lse and
    delta = rowsum(dout * out)."""
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
    dq, dslopes = flash_attention_bwd_dq_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
    return dq, dk, dv, dslopes


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_args(name, tensors, mask, b, tk, d, device):
    """Checks shared by the kernel wrappers; returns the byte mask. `tensors`
    are the operands (q, k, v[, dout]), of one dtype, fp32 or bf16."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    for t in tensors + ([mask] if mask is not None else []):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    dtype = tensors[0].dtype
    if dtype not in KERNEL_DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 operands of one dtype, "
                        f"got {[str(t.dtype) for t in tensors]}")
    if mask is None:
        return torch.ones(b, tk, dtype=torch.bool, device=device)
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool, got {mask.dtype}")
    return mask


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _f32(name, x, shape, device):
    """`x` as a contiguous fp32 tensor of `shape` on `device` (slopes, lse, delta)."""
    if tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: {tuple(x.shape)} on {x.device}, expected {tuple(shape)} on {device}")
    return x.float().contiguous()


def _count(fn, dtype, one_pass=False):
    if one_pass:
        fn.launches_one_pass += 1
    elif dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _for_dtype(name, dtype):
    """The library or entry point `name` of the fp32 kernels (split-TF32
    `wgmma`), or its `_bf16` sibling (bf16 `wgmma`) for bf16 operands."""
    return name + "_bf16" if dtype == torch.bfloat16 else name


def _one_pass_kernel(library, symbol, dtype):
    """The one-pass entry point `symbol` of `library` (bf16 `wgmma`, P and dS
    one bf16 term) for `dtype`, fp32 or bf16: it takes operands and writes
    its outputs (o, or the gradients) in `dtype`, fp32 operands rounded to
    bf16 in the kernel (and the forward's q scaled before, in either dtype)."""
    return kernel(library, symbol + ("_f32" if dtype == torch.float32 else ""))


def _padded_width(q) -> Optional[int]:
    """The built width that q's head dim is padded to, or None when the
    kernels take it as it is (or the plain versions run it)."""
    d = q.shape[-1]
    if not head_layout.kernel_layout(q.device) or d in KERNEL_HEAD_DIMS:
        return None
    return kernel_head_dim(d)


def _to_built_width(q, k, v, slopes, mask, *rest):
    """q, k, v and `rest` (dout) zero-padded along the head dim to the next
    built width where the kernels are not built for q's, as they are
    otherwise."""
    width = _padded_width(q)
    if width is None:
        return (q, k, v, *rest)
    _check(q, k, v, slopes, mask)
    return tuple(pad_head_dim(x, width) for x in (q, k, v, *rest))


def _at_built_width(launch, q, k, v, slopes, mask, dout, rest, causal, scale, sliced, one_pass):
    """`launch`'s results at q's head dim: the inputs taken to the built
    width (`_to_built_width`), and the results named by `sliced` cut back."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    padded = _to_built_width(q, k, v, slopes, mask, *(() if dout is None else (dout,)))
    outs = launch(*padded[:3], slopes, mask, *padded[3:], *rest, causal, scale, one_pass)
    if padded[0] is q:
        return outs
    return tuple(_cut(o, d) if cut else o for o, cut in zip(outs, sliced))


def _cut(x, d):
    """x's first d columns as a tensor of their own, so that the padded one
    is freed."""
    return x[..., :d].contiguous()


def flash_attention_fwd(q, k, v, slopes, mask=None, causal=True, scale=None, one_pass=False):
    """(out, lse): the forward kernel on CUDA tensors, its plain version on CPU
    tensors; `one_pass` takes the TPU's DEFAULT numerics (the one-pass
    kernel, csrc/flash_attention_fwd_one_pass.cu)."""
    return _at_built_width(_fwd, q, k, v, slopes, mask, None, (), causal, scale, (True, False), one_pass)


def _fwd(q, k, v, slopes, mask, causal, scale, one_pass):
    if not kernel_route(q.device):
        return flash_attention_plain(q, k, v, slopes, mask, causal, scale, return_lse=True, one_pass=one_pass)
    # the one-pass kernel takes q, k and v as they are and the real scale:
    # it rounds bf16(q*scale), as `_flash_kernel` scales q before its dot
    out = _fwd_launch(q, k, v, slopes, mask, causal, scale, one_pass)
    _count(flash_attention_fwd, q.dtype, one_pass)
    return out


def _fwd_launch(q, k, v, slopes, mask, causal, scale, one_pass):
    """(out, lse) of one forward launch on CUDA tensors, out in the operands'
    dtype: the one-pass kernel (fp32 or bf16 operands, rounded to bf16 in
    the kernel, q after the scale) or the fp32-accurate kernel of q's
    dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    mask, slopes = _fwd_args(q, k, v, slopes, mask)
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    if one_pass:
        launch = _one_pass_kernel("flash_attention_fwd_one_pass", "sp_flash_attention_fwd_one_pass", q.dtype)
    else:
        launch = kernel(_for_dtype("flash_attention_fwd", q.dtype), _for_dtype("sp_flash_attention_fwd", q.dtype))
    _raise_on("flash_attention", launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, hk, tq, tk, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    return out, lse


def _fwd_args(q, k, v, slopes, mask):
    """The forward launch's checks: q, k and v of one dtype, fp32 or bf16,
    contiguous and 16-byte aligned (so are their rows, at the built head
    dims); returns the byte mask and the fp32 slopes."""
    _check(q, k, v, slopes, mask)
    b, h, _, d = q.shape
    mask = _kernel_args("flash_attention", [q, k, v], mask, b, k.shape[2], d, q.device)
    slopes = _f32("flash_attention: slopes", slopes, (h,), q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    return mask, slopes


def _bwd_launch(name, symbol, q, k, v, slopes, mask, dout, lse, delta, causal, scale, outs, one_pass):
    """One backward launch on CUDA tensors into `outs`, the gradients (and
    dQ's slope parts) in the operands' dtype: the one-pass kernel (fp32
    operands read as they are and rounded to bf16 in the kernel, or bf16
    ones) or the fp32-accurate kernel of q's dtype."""
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    mask, slopes, lse, delta = _bwd_args(name, q, k, v, slopes, mask, dout, lse, delta, outs)
    if one_pass:
        launch = _one_pass_kernel("flash_attention_bwd_one_pass", symbol + "_one_pass", q.dtype)
    else:
        launch = kernel(_for_dtype("flash_attention_bwd", q.dtype), _for_dtype(symbol, q.dtype))
    _raise_on(name, launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        b, h, hk, tq, tk, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))


def _bwd_args(name, q, k, v, slopes, mask, dout, lse, delta, outs):
    """The backward launch's checks: q, k, v and dout of one dtype, fp32 or
    bf16, and the gradients in `outs` in it; returns the byte mask and the
    fp32 slopes, lse and delta."""
    _check(q, k, v, slopes, mask)
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    mask = _kernel_args(name, [q, k, v, dout], mask, b, tk, d, q.device)
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} does not fit q {tuple(q.shape)}")
    grads = [o for o in outs if o.dim() == 4]  # not dQ's slope parts
    if any(g.dtype != q.dtype for g in grads):
        raise TypeError(f"{name}: the kernels write the gradients in the operands' dtype, {q.dtype}, "
                        f"not {[str(g.dtype) for g in grads]}")
    slopes = _f32(f"{name}: slopes", slopes, (h,), q.device)
    lse = _f32(f"{name}: lse", lse, (b, h, tq), q.device)
    delta = _f32(f"{name}: delta", delta, (b, h, tq), q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError(f"{name}: q, k, v and dout must be 16-byte aligned")
    return mask, slopes, lse, delta


def flash_attention_bwd_dkv(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None, one_pass=False):
    """(dk, dv) by the dK/dV kernel on CUDA tensors (its plain version on CPU
    tensors); with one KV head the sum over query heads is in the kernel.
    `one_pass`: the TPU's DEFAULT numerics (the one-pass kernel)."""
    return _at_built_width(_bwd_dkv, q, k, v, slopes, mask, dout, (lse, delta), causal, scale, (True, True),
                           one_pass)


def kernel_route(device) -> bool:
    """Whether the forward and backward wrappers launch their kernels for
    tensors on `device` (CPU tensors run the plain versions). The one place
    they make that choice, so a test may force the kernel route on the CPU
    and put launchers of its own in `_fwd_launch`'s and `_bwd_launch`'s
    place."""
    return torch.device(device).type != "cpu"


def _bwd_dkv(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass):
    if not kernel_route(q.device):
        return flash_attention_bwd_dkv_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", "sp_flash_attention_bwd_dkv",
                q, k, v, slopes, mask, dout, lse, delta, causal, scale, (dk, dv), one_pass)
    _count(flash_attention_bwd_dkv, dk.dtype, one_pass)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None, one_pass=False):
    """(dq, dslopes) by the dQ/dslope kernel on CUDA tensors (its plain version
    on CPU tensors). The kernel writes one part of the slope gradient per
    (batch, head, query tile), the JAX wrapper's padded keys' part
    (`padded_key_dslopes`) included; a torch sum reduces them in a fixed
    order. `one_pass`: the TPU's DEFAULT numerics (the one-pass kernel)."""
    return _at_built_width(_bwd_dq, q, k, v, slopes, mask, dout, (lse, delta), causal, scale, (True, False),
                           one_pass)


def _bwd_dq(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass):
    if not kernel_route(q.device):
        return flash_attention_bwd_dq_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
    b, h, tq, _ = q.shape
    dq = torch.empty_like(q)
    parts = torch.empty(dq_slope_parts(b, h, k.shape[1], tq), dtype=torch.float32, device=q.device)
    _bwd_launch("flash_attention_bwd_dq", "sp_flash_attention_bwd_dq",
                q, k, v, slopes, mask, dout, lse, delta, causal, scale, (dq, parts), one_pass)
    _count(flash_attention_bwd_dq, dq.dtype, one_pass)
    return dq, parts.sum(dim=(0, 2)).to(slopes.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, then the two backward kernels (or the plain versions on
    CPU tensors). The mask gets no gradient. At a head dim the kernels are
    not built for, the residuals are kept unpadded and padded once for both
    backward kernels, whose wrappers then take them as they are."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, mask, causal, scale, one_pass):
        out, lse = flash_attention_fwd(q, k, v, slopes, mask, causal, scale, one_pass=one_pass)
        ctx.save_for_backward(q, k, v, slopes, mask, out, lse)
        ctx.causal, ctx.scale, ctx.one_pass = causal, scale, one_pass  # the forward's mode, whatever comes after
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, slopes, mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout * out).sum(-1).float()  # in the residuals' dtype, as the JAX wrapper
        d = q.shape[-1]
        scale = ctx.scale if ctx.scale is not None else d**-0.5  # the real d's, not the padded width's
        q, k, v, dout = _to_built_width(q, k, v, slopes, mask, dout)
        args = (q, k, v, slopes, mask, dout, lse, delta, ctx.causal, scale)
        # by module name: a caller may swap in the plain versions
        dk, dv = flash_attention_bwd_dkv(*args, one_pass=ctx.one_pass)
        dq, dslopes = flash_attention_bwd_dq(*args, one_pass=ctx.one_pass)
        return dq[..., :d], dk[..., :d], dv[..., :d], dslopes, None, None, None, None


def flash_attention_alibi(
    q: torch.Tensor,  # (b, h, tq, d)
    k: torch.Tensor,  # (b, hk, tk, d); hk == h or 1 (MQA)
    v: torch.Tensor,
    slopes: torch.Tensor,  # (h,) ALiBi slopes (zeros for plain attention)
    mask: Optional[torch.Tensor] = None,  # (b, tk) key validity
    causal: bool = True,
    scale: Optional[float] = None,
    precision: str = "default",
) -> torch.Tensor:
    """Attention, o = softmax(q.k*scale - slope*|i-j|, masked) . v, with
    gradients for q, k, v and slopes (`flash_attention_fwd` gives o and the
    row logsumexp without them). `precision` takes JAX's names
    (`precision_is_one_pass`), resolved here once for the forward and its
    backward."""
    one_pass = precision_is_one_pass(precision)
    _check(q, k, v, slopes, mask)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, slopes, mask, causal, scale, one_pass)


def precision_is_one_pass(precision: str = "default") -> bool:
    """Whether `precision` (a name of JAX's `_PRECISIONS`: "default", "high",
    "highest"; any other raises KeyError, as JAX's lookup does) takes the
    one-pass route, the TPU's DEFAULT numerics: "default" does where PyTorch's
    counterpart of a device's default matmul precision,
    `torch.get_float32_matmul_precision()`, is "medium"; otherwise, and for
    "high" and "highest", the fp32-accurate kernels run (split TF32, or P and
    dS in three bf16 terms: at least the TPU's HIGH, bf16_3x)."""
    if precision not in PRECISIONS:
        raise KeyError(precision)
    return precision == "default" and torch.get_float32_matmul_precision() == "medium"


for _fn in (flash_attention_fwd, flash_attention_bwd_dkv, flash_attention_bwd_dq):
    _fn.launches = _fn.launches_bf16 = _fn.launches_one_pass = 0

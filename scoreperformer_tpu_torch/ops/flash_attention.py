"""Flash attention with ALiBi generated inside the kernels, forward and backward.

Counterpart of scoreperformer_tpu/ops/flash_attention.py. On CUDA tensors
`flash_attention_alibi` launches the hand-written forward kernel of
`csrc/flash_attention_fwd.cu` and, for the gradient, the dK/dV and dQ/dslope
kernels of `csrc/flash_attention_bwd.cu`, inside one `torch.autograd.Function`;
none of them materializes the (h, t, t) bias or score tensors. On CPU tensors
the same Function runs `flash_attention_plain` and `flash_attention_bwd_plain`,
the same functions in plain PyTorch. All keep the TPU kernels' numerics: q is
scaled before the dot, the bias is -slope*|i-j|, masked scores are -1e30, the
softmax sum is clamped at 1e-30, P is recomputed from the saved logsumexp, all
in fp32.

A query row whose keys are all masked gets the JAX wrapper's answer: that
wrapper pads keys to whole blocks with mask 0, so the row averages v over
every key of the blocks it visits (`jax_masked_row_keys`), not over t keys.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._build import kernel

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64)
BLOCK_Q = 32  # query rows per block of the dQ kernel (one dslope part each)


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


def _valid(b, tq, tk, mask, causal, device):
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    valid = torch.ones(b, 1, 1, tk, dtype=torch.bool, device=device)
    if mask is not None:
        valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & (j <= i)
    return valid, (j - i).abs().float()


def _scores(q, k, slopes, mask, causal, scale):
    """Masked scores (b, h, tq, tk) and the distances |i-j| (tq, tk)."""
    b, _, tq, _ = q.shape
    tk = k.shape[2]
    s = (q.float() * scale) @ k.float().transpose(-1, -2)  # hk=1 broadcasts
    valid, dist = _valid(b, tq, tk, mask, causal, q.device)
    s = s - slopes.float()[None, :, None, None] * dist
    return torch.where(valid, s, NEG_INF), dist


def flash_attention_plain(q, k, v, slopes, mask=None, causal=True, scale=None, return_lse=False):
    """Plain version of the forward: the whole (b, h, tq, tk) score tensor at once."""
    _check(q, k, v, slopes, mask)
    tq, d = q.shape[2], q.shape[3]
    tk = k.shape[2]
    scale = scale if scale is not None else d**-0.5
    s, _ = _scores(q, k, slopes, mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    # rows with no valid key: v averaged over the JAX wrapper's padded keys
    none_valid = m == NEG_INF
    if bool(none_valid.any()):
        keys = jax_masked_row_keys(tq, tk, causal, q.device)[:, None]
        p = torch.where(none_valid, (torch.arange(tk, device=q.device)[None, :] < keys).float(), p)
        l = torch.where(none_valid, keys.float(), l)
    out = ((p @ v.float()) / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale):
    s, dist = _scores(q, k, slopes, mask, causal, scale)
    p = torch.exp(s - lse[..., None])
    ds = p * (dout.float() @ v.float().transpose(-1, -2) - delta[..., None])
    return p, ds, dist


def _sum_kv_heads(x, hk):
    return x.sum(dim=1, keepdim=True) if hk == 1 else x


def flash_attention_bwd_dkv_plain(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None):
    """Plain version of the dK/dV kernel: (dk, dv), summed over the query heads
    when there is one KV head."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds, _ = _bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale)
    dv = p.transpose(-1, -2) @ dout.float()
    dk = ds.transpose(-1, -2) @ (q.float() * scale)
    hk = k.shape[1]
    return _sum_kv_heads(dk, hk).to(k.dtype), _sum_kv_heads(dv, hk).to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None):
    """Plain version of the dQ/dslope kernel: (dq, dslopes), dslopes summed
    over the batch."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, dist = _bwd_plain_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale)
    dq = (ds @ k.float()) * scale
    dslopes = (ds * -dist).sum(dim=(0, 2, 3))
    return dq.to(q.dtype), dslopes.to(slopes.dtype)


def flash_attention_bwd_plain(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None):
    """Plain backward: (dq, dk, dv, dslopes) from the saved lse and
    delta = rowsum(dout * out)."""
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale)
    dq, dslopes = flash_attention_bwd_dq_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale)
    return dq, dk, dv, dslopes


def _kernel_args(name, tensors, mask, b, tk, d, device):
    """Checks shared by the kernel wrappers; returns the byte mask."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    for t in tensors + ([mask] if mask is not None else []):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if mask is None:
        return torch.ones(b, tk, dtype=torch.bool, device=device)
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool, got {mask.dtype}")
    return mask


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def flash_attention_fwd(q, k, v, slopes, mask=None, causal=True, scale=None):
    """(out, lse): the forward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, slopes, mask, causal, scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, slopes, mask)
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    mask = _kernel_args("flash_attention", [q, k, v, slopes], mask, b, tk, d, q.device)
    scale = scale if scale is not None else d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    _raise_on("flash_attention", kernel("flash_attention_fwd", "sp_flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, hk, tq, tk, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_launch(name, symbol, q, k, v, slopes, mask, dout, lse, delta, causal, scale, outs):
    _check(q, k, v, slopes, mask)
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    mask = _kernel_args(name, [q, k, v, slopes, dout, lse, delta], mask, b, tk, d, q.device)
    if dout.shape != q.shape or lse.shape != (b, h, tq) or delta.shape != (b, h, tq):
        raise ValueError(f"{name}: dout {tuple(dout.shape)}, lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)} do not fit q {tuple(q.shape)}")
    scale = scale if scale is not None else d**-0.5
    _raise_on(name, kernel("flash_attention_bwd", symbol)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        b, h, hk, tq, tk, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))


def flash_attention_bwd_dkv(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None):
    """(dk, dv) by the dK/dV kernel on CUDA tensors (its plain version on CPU
    tensors); with one KV head the sum over query heads is in the kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", "sp_flash_attention_bwd_dkv",
                q, k, v, slopes, mask, dout, lse, delta, causal, scale, (dk, dv))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, slopes, mask, dout, lse, delta, causal=True, scale=None):
    """(dq, dslopes) by the dQ/dslope kernel on CUDA tensors (its plain version
    on CPU tensors). The kernel writes one part of the slope gradient per
    (batch, head, query tile); a torch sum reduces them in a fixed order."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, slopes, mask, dout, lse, delta, causal, scale)
    b, h, tq, _ = q.shape
    dq = torch.empty_like(q)
    parts = torch.empty(b, h, -(-tq // BLOCK_Q), dtype=torch.float32, device=q.device)
    _bwd_launch("flash_attention_bwd_dq", "sp_flash_attention_bwd_dq",
                q, k, v, slopes, mask, dout, lse, delta, causal, scale, (dq, parts))
    flash_attention_bwd_dq.launches += 1
    return dq, parts.sum(dim=(0, 2)).to(slopes.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, then the two backward kernels (or the plain versions on
    CPU tensors). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, mask, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, slopes, mask, causal, scale)
        ctx.save_for_backward(q, k, v, slopes, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, slopes, mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1)
        args = (q, k, v, slopes, mask, dout, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(*args)
        dq, dslopes = flash_attention_bwd_dq(*args)
        return dq, dk, dv, dslopes, None, None, None


def flash_attention_alibi(
    q: torch.Tensor,  # (b, h, tq, d)
    k: torch.Tensor,  # (b, hk, tk, d); hk == h or 1 (MQA)
    v: torch.Tensor,
    slopes: torch.Tensor,  # (h,) ALiBi slopes (zeros for plain attention)
    mask: Optional[torch.Tensor] = None,  # (b, tk) key validity
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention, o = softmax(q.k*scale - slope*|i-j|, masked) . v, with
    gradients for q, k, v and slopes (`flash_attention_fwd` gives o and the
    row logsumexp without them)."""
    _check(q, k, v, slopes, mask)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, slopes, mask, causal, scale)


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0

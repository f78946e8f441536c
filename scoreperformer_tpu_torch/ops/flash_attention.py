"""Flash attention forward with ALiBi generated inside the kernel.

Counterpart of the forward of scoreperformer_tpu/ops/flash_attention.py. On
CUDA tensors `flash_attention_alibi` launches the hand-written kernel of
`csrc/flash_attention_fwd.cu`, which never materializes the (h, t, t) bias or
score tensors; on CPU tensors it runs `flash_attention_plain`, the same
function in plain PyTorch. Both keep the TPU kernel's numerics: q is scaled
before the dot, the bias is -slope*|i-j|, masked scores are -1e30, the softmax
sum is clamped at 1e-30, all in fp32. The backward (training) is not ported
yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._build import kernel

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64)


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


def flash_attention_plain(q, k, v, slopes, mask=None, causal=True, scale=None, return_lse=False):
    """Plain version: the whole (b, h, tq, tk) score tensor at once."""
    _check(q, k, v, slopes, mask)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else d**-0.5
    s = (q.float() * scale) @ k.float().transpose(-1, -2)  # (b, h, tq, tk); hk=1 broadcasts
    i = torch.arange(tq, device=q.device)[:, None]
    j = torch.arange(tk, device=q.device)[None, :]
    s = s - slopes.float()[None, :, None, None] * (j - i).abs().float()
    valid = torch.ones(b, 1, 1, tk, dtype=torch.bool, device=q.device)
    if mask is not None:
        valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & (j <= i)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = ((p @ v.float()) / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_alibi(
    q: torch.Tensor,  # (b, h, tq, d)
    k: torch.Tensor,  # (b, hk, tk, d); hk == h or 1 (MQA)
    v: torch.Tensor,
    slopes: torch.Tensor,  # (h,) ALiBi slopes (zeros for plain attention)
    mask: Optional[torch.Tensor] = None,  # (b, tk) key validity
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Attention forward, o = softmax(q.k*scale - slope*|i-j|, masked) . v,
    and optionally the row logsumexp (b, h, tq)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, slopes, mask, causal, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, slopes, mask)
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    tensors = [q, k, v, slopes] + ([mask] if mask is not None else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: inputs must be contiguous")
    for t in (q, k, v, slopes):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: the kernel takes float32, got {t.dtype}")
    if mask is None:
        mask = torch.ones(b, tk, dtype=torch.bool, device=q.device)
    if mask.dtype != torch.bool:
        raise TypeError(f"flash_attention: mask must be bool, got {mask.dtype}")
    scale = scale if scale is not None else d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device) if return_lse else None
    err = kernel("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, h, hk, tq, tk, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention_alibi.launches += 1
    return (out, lse) if return_lse else out


flash_attention_alibi.launches = 0

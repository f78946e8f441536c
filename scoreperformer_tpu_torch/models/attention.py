"""Multi-head attention with ALiBi, MQA, and a static-shape KV cache.

Counterpart of scoreperformer_tpu/models/attention.py. Caches are dicts of
time-major (cap, b, kv) tensors that the decode loop owns and that this module
updates IN PLACE through `write_kv`. Positions (`cache_index`) are one-element
int64 tensors on the device, so a decode step never waits for the host.
Softmax runs in fp32. Attention-probability dropout applies in
`module.train()` mode only (see `dropout.py`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.flash_attention import flash_attention_alibi
from ..ops.kv_cache import write_kv
from .dropout import Dropout
from .layers import ALiBiPositionalBias

MASK_VALUE = -1e9


def init_kv_cache(batch: int, max_len: int, kv_dim: int, dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """Fixed-size TIME-MAJOR cache (max_len, batch, kv_dim) for one layer."""
    if dtype != torch.float32:
        raise NotImplementedError("only fp32 KV caches are ported; bf16/int8 caches are queued")
    return {
        "k": torch.zeros(max_len, batch, kv_dim, dtype=dtype, device=device),
        "v": torch.zeros(max_len, batch, kv_dim, dtype=dtype, device=device),
    }


def _attn_mask_4d(attn_mask: torch.Tensor) -> torch.Tensor:
    """(i, j), (b, i, j) or (b, h|1, i, j) -> broadcastable to (b, h, i, j)."""
    if attn_mask.ndim == 2:
        return attn_mask[None, None]
    if attn_mask.ndim == 3:
        return attn_mask[:, None]
    return attn_mask


def _masked(dots: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, dots, MASK_VALUE)


class Attention(nn.Module):
    def __init__(
        self,
        dim: int,
        dim_head: int = 64,
        heads: int = 8,
        causal: bool = False,
        dropout: float = 0.0,
        one_kv_head: bool = False,
        max_attend: Optional[int] = None,
        alibi_pos_bias: bool = False,
        alibi_num_heads: Optional[int] = None,
        alibi_symmetric: bool = True,
        alibi_learned: bool = False,
        use_flash: bool = False,
    ):
        super().__init__()
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.one_kv_head, self.max_attend = one_kv_head, max_attend
        self.alibi_symmetric, self.use_flash = alibi_symmetric, use_flash
        self.dropout = dropout
        self.attn_dropout = Dropout(dropout)
        q_dim = dim_head * heads
        kv_dim = dim_head if one_kv_head else q_dim
        self.to_q = nn.Linear(dim, q_dim, bias=False)
        self.to_k = nn.Linear(dim, kv_dim, bias=False)
        self.to_v = nn.Linear(dim, kv_dim, bias=False)
        self.to_out = nn.Linear(q_dim, dim, bias=False)
        self.rel_pos = (
            ALiBiPositionalBias(
                heads=alibi_num_heads or heads,
                total_heads=heads,
                symmetric=alibi_symmetric or causal,
                learned=alibi_learned,
            )
            if alibi_pos_bias
            else None
        )

    @property
    def kv_heads(self) -> int:
        return 1 if self.one_kv_head else self.heads

    def _split_kv(self, t: torch.Tensor) -> torch.Tensor:
        """(j, b, kv) time-major rows -> (b, kv_heads, j, d)."""
        j, b = t.shape[:2]
        return t.reshape(j, b, self.kv_heads, self.dim_head).permute(1, 2, 0, 3)

    def _chunked_cache_attend(self, x, mask, attn_mask, cache, cache_index):
        """Decode attention over a frozen prefix cache {"k","v"} (cap, b, kv)
        plus the chunk's fresh buffers {"fk","fv"} (C, b, kv); "base" (an int)
        is the global position of fresh slot 0. The step's rows are written
        into the fresh buffers in place; softmax runs over [prefix | fresh]
        with prefix slots at or past `base` masked as stale."""
        b, n = x.shape[:2]
        h, d = self.heads, self.dim_head
        idx = cache_index
        base = cache["base"]

        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        fk = write_kv(cache["fk"], self.to_k(x).transpose(0, 1).contiguous(), idx - base)
        fv = write_kv(cache["fv"], self.to_v(x).transpose(0, 1).contiguous(), idx - base)
        pk, pv = cache["k"], cache["v"]
        cap, chunk = pk.shape[0], fk.shape[0]
        dev = x.device

        pos_q = idx + torch.arange(n, device=dev)
        key_pos = torch.cat([torch.arange(cap, device=dev), base + torch.arange(chunk, device=dev)])
        key_valid = torch.cat(
            [torch.arange(cap, device=dev) < base, torch.ones(chunk, dtype=torch.bool, device=dev)]
        )

        dots_p = q @ self._split_kv(pk).transpose(-1, -2)
        dots_f = q @ self._split_kv(fk).transpose(-1, -2)
        dots = torch.cat([dots_p, dots_f], dim=-1) * d**-0.5

        if self.rel_pos is not None:
            dots = dots + self.rel_pos(pos_q, key_pos)[None]
        if mask is not None:
            dots = _masked(dots, mask[:, None, None, :])
        if attn_mask is not None:
            dots = _masked(dots, _attn_mask_4d(attn_mask))
        if self.max_attend is not None:
            dist = pos_q[:, None] - key_pos[None, :]
            dots = _masked(dots, ((-self.max_attend < dist) & (dist <= self.max_attend))[None, None])
        if self.causal:
            dots = _masked(dots, (key_pos[None, :] <= pos_q[:, None])[None, None])
        dots = _masked(dots, key_valid[None, None, None, :])

        attn = torch.softmax(dots.float(), dim=-1).to(dots.dtype)
        out = attn[..., :cap] @ self._split_kv(pv) + attn[..., cap:] @ self._split_kv(fv)
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.to_out(out)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        context_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Without a cache: full attention over `x` (or cross-attention over
        `context`). With a cache: the keys/values of `x` are written IN PLACE
        at slot `cache_index % cap` (a ring) and the queries attend over the
        whole buffer, masked to the written positions."""
        if cache is not None and "fk" in cache:
            if context is not None:
                raise ValueError("a chunked cache is not compatible with cross-attention")
            return self._chunked_cache_attend(x, mask, attn_mask, cache, cache_index)

        b, n = x.shape[:2]
        h, d = self.heads, self.dim_head
        scale = d**-0.5
        dev = x.device
        kv_input = context if context is not None else x
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)  # b h n d
        k = self.to_k(kv_input)
        v = self.to_v(kv_input)

        # flash path: full self-attention, no cache/window/attn_mask, symmetric
        # ALiBi, no attention dropout while training (the kernels have none).
        # On CUDA tensors this is the hand-written kernels, forward and
        # backward; on CPU tensors the same call runs their plain versions.
        if (
            self.use_flash
            and cache is None
            and context is None
            and attn_mask is None
            and self.max_attend is None
            and (not self.training or self.dropout == 0.0)
            and (self.rel_pos is None or self.alibi_symmetric or self.causal)
        ):
            slopes = self.rel_pos.padded_slopes() if self.rel_pos is not None else torch.zeros(h, device=dev)
            k_h = k.reshape(b, n, self.kv_heads, d).transpose(1, 2).contiguous()
            v_h = v.reshape(b, n, self.kv_heads, d).transpose(1, 2).contiguous()
            out = flash_attention_alibi(
                q.contiguous(), k_h, v_h, slopes.float().contiguous(),
                mask=mask.contiguous() if mask is not None else None,
                causal=self.causal, scale=scale,
            )
            out = self.to_out(out.transpose(1, 2).reshape(b, n, h * d))
            if mask is not None:
                out = out * mask[..., None]
            return out

        has_cache = cache is not None
        if has_cache:
            if context is not None:
                raise ValueError("a cache is not compatible with cross-attention")
            idx = cache_index if cache_index is not None else torch.zeros(1, dtype=torch.int64, device=dev)
            cap = cache["k"].shape[0]
            # ring buffer: single-position steps past the capacity wrap and the
            # cache then holds the last `cap` positions
            slot = idx % cap
            k_t = write_kv(cache["k"], k.transpose(0, 1).contiguous(), slot)
            v_t = write_kv(cache["v"], v.transpose(0, 1).contiguous(), slot)
            j = cap
            pos_q = idx + torch.arange(n, device=dev)
            # absolute position held by each slot: the latest write at or
            # before the last query position that maps to that slot
            p_last = idx + n - 1
            key_pos = p_last - torch.remainder(p_last - torch.arange(j, device=dev), cap)
            key_valid = key_pos >= 0
            k_h, v_h = self._split_kv(k_t), self._split_kv(v_t)
        else:
            j = k.shape[1]
            pos_q = (j - n) + torch.arange(n, device=dev) if context is None else torch.arange(n, device=dev)
            key_pos = torch.arange(j, device=dev)
            key_valid = None
            k_h = k.reshape(b, j, self.kv_heads, d).transpose(1, 2)
            v_h = v.reshape(b, j, self.kv_heads, d).transpose(1, 2)
        dots = (q @ k_h.transpose(-1, -2)) * scale

        if self.rel_pos is not None:
            dots = dots + self.rel_pos(pos_q, key_pos)[None]

        # masks, composed in the JAX package's order
        input_mask = context_mask if (context is not None and context_mask is not None) else mask
        if input_mask is not None:
            dots = _masked(dots, input_mask[:, None, None, :])
        if attn_mask is not None:
            dots = _masked(dots, _attn_mask_4d(attn_mask))
        if self.max_attend is not None:
            dist = pos_q[:, None] - key_pos[None, :]
            dots = _masked(dots, ((-self.max_attend < dist) & (dist <= self.max_attend))[None, None])
        if self.causal:
            dots = _masked(dots, (key_pos[None, :] <= pos_q[:, None])[None, None])
        if key_valid is not None:
            dots = _masked(dots, key_valid[None, None, None, :])

        attn = torch.softmax(dots.float(), dim=-1).to(dots.dtype)
        attn = self.attn_dropout(attn)
        out = (attn @ v_h).transpose(1, 2).reshape(b, n, h * d)
        out = self.to_out(out)
        if mask is not None and not has_cache:
            out = out * mask[..., None]
        return out

"""Multi-head attention with ALiBi, MQA, and a static-shape KV cache.

Counterpart of scoreperformer_tpu/models/attention.py. Caches are dicts of
time-major (cap, b, kv) tensors that the decode loop owns and that this module
updates IN PLACE through `write_kv_pair` (a layer's K and V rows in one
kernel launch). Positions (`cache_index`) are one-element int64 tensors on
the device, so a decode step never waits for the host. Softmax runs in fp32,
or in bf16 with `softmax_bf16` outside the chunked decode, as in the JAX
module. Attention-probability dropout applies in `module.train()` mode only
(see `dropout.py`).

A cache may hold each KV head at a width past the head dim (the kernels'
layout on the GPU, `ops/head_layout.py`): rows are written with zero
columns there, and every reader takes each head's first `dim_head`
columns.

On a model axis (`parallel/shard.py` sets `head_range`), a rank holds its
query heads' rows of `to_q` and columns of `to_out`, and its KV heads' rows
of `to_k`/`to_v`, or all of them when there are fewer KV heads than ranks
(their gradient is then summed over the axis). The input passes through
copy-to-group and one reduce-from-group sums the ranks' `to_out` outputs.
With `sequence_parallel` the input is the rank's slice of the sequence: an
all-gather takes the place of copy-to-group (attention, ALiBi and the
flash kernels see the whole sequence) and a reduce-scatter that of
reduce-from-group. Only the training and eval forward run sharded; a
cache raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.flash_attention import flash_attention_alibi
from ..ops.head_layout import pad_head_dim
from ..ops.kv_cache import write_kv_pair
from ..ops.prefix_attend import combine_lse, prefix_attend
from ..parallel.collectives import (copy_to_group, gather_seq_to_group, reduce_from_group, reduce_scatter_seq,
                                    seq_block)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from .dropout import Dropout
from .layers import ALiBiPositionalBias, Linear, linear

MASK_VALUE = -1e9


def init_kv_cache(batch: int, max_len: int, kv_dim: int, dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """Fixed-size TIME-MAJOR cache (max_len, batch, kv_dim) for one layer, in
    fp32, bf16, or int8 with one fp32 scale per (position, batch) row
    ("k_s", "v_s"; see `quantize_kv_rows`). Only the chunked decode reads an
    int8 cache: its rows are quantized once per chunk at the merge."""
    if dtype == torch.int8:
        return {
            "k": torch.zeros(max_len, batch, kv_dim, dtype=torch.int8, device=device),
            "k_s": torch.zeros(max_len, batch, dtype=torch.float32, device=device),
            "v": torch.zeros(max_len, batch, kv_dim, dtype=torch.int8, device=device),
            "v_s": torch.zeros(max_len, batch, dtype=torch.float32, device=device),
        }
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"init_kv_cache: dtype {dtype} is not float32, bfloat16 or int8")
    return {
        "k": torch.zeros(max_len, batch, kv_dim, dtype=dtype, device=device),
        "v": torch.zeros(max_len, batch, kv_dim, dtype=dtype, device=device),
    }


def quantize_kv_rows(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-row int8 quantization of (..., kv_dim) rows: (q, scale)
    with scale = max(|row|, eps) / 127 and q = round(x / scale), half to
    even as jnp.round, clipped to [-127, 127]."""
    scale = torch.clamp(x.abs().amax(dim=-1), min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _attn_mask_4d(attn_mask: torch.Tensor) -> torch.Tensor:
    """(i, j), (b, i, j) or (b, h|1, i, j) -> broadcastable to (b, h, i, j)."""
    if attn_mask.ndim == 2:
        return attn_mask[None, None]
    if attn_mask.ndim == 3:
        return attn_mask[:, None]
    return attn_mask


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
        softmax_bf16: bool = False,
    ):
        """`softmax_bf16`: cast the scores to bf16 after ALiBi, mask and
        softmax them in bf16, and take the value product in fp32, as the JAX
        module does (not bit-stable against fp32); the flash and the chunked
        decode paths ignore it. The boolean masks are always ANDed and
        applied in one select, which gives the bits of one select a mask:
        both forms of the JAX module's `fused_mask_select`."""
        super().__init__()
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.one_kv_head, self.max_attend = one_kv_head, max_attend
        self.alibi_symmetric, self.use_flash = alibi_symmetric, use_flash
        self.softmax_bf16 = softmax_bf16
        self.dropout = dropout
        self.attn_dropout = Dropout(dropout)
        q_dim = dim_head * heads
        kv_dim = dim_head if one_kv_head else q_dim
        self.to_q = Linear(dim, q_dim, bias=False)
        self.to_k = Linear(dim, kv_dim, bias=False)
        self.to_v = Linear(dim, kv_dim, bias=False)
        self.to_out = Linear(q_dim, dim, bias=False)
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
        self.head_range: Optional[tuple] = None  # this rank's query heads on a model axis
        self.kv_whole = False  # K/V projections whole on every model rank

    def shard_heads(self, n: int, index: int) -> None:
        """Keep query heads [index*h/n, (index+1)*h/n) (their slopes and
        dropout masks too); the parameters are sliced by `parallel/shard.py`."""
        h = self.heads // n
        self.head_range = (index * h, (index + 1) * h)
        self.kv_whole = self.kv_heads < n
        self.heads = h
        self.attn_dropout.layout = (DATA_AXIS, MODEL_AXIS)
        if self.rel_pos is not None:
            self.rel_pos.head_range = self.head_range

    def _project_kv(self, x: torch.Tensor):
        if not self.kv_whole:
            return self.to_k(x), self.to_v(x)
        return (linear(x, copy_to_group(self.to_k.weight, MODEL_AXIS)),
                linear(x, copy_to_group(self.to_v.weight, MODEL_AXIS)))

    @property
    def kv_heads(self) -> int:
        return 1 if self.one_kv_head else self.heads

    def _split_kv(self, t: torch.Tensor) -> torch.Tensor:
        """(j, b, kv) time-major rows -> (b, kv_heads, j, d): each head's first
        d columns of the cache's width."""
        j, b = t.shape[:2]
        return t.reshape(j, b, self.kv_heads, -1)[..., : self.dim_head].permute(1, 2, 0, 3)

    def _cache_rows(self, x: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """(b, n, kv) projected rows -> (n, b, kv') rows of `cache`, each
        head zero-padded to the cache's width."""
        rows = x.transpose(0, 1)
        width = cache.shape[2] // self.kv_heads
        if width != self.dim_head:
            rows = pad_head_dim(rows.reshape(*rows.shape[:2], self.kv_heads, self.dim_head), width).flatten(2)
        return rows.contiguous()

    def _decode_bias(self, mask, attn_mask, pos_q, key_pos, cap, base):
        """(h, cap + C) additive bias of the chunked decode's keys, the
        prefix slots then the fresh ones: ALiBi, and -1e9 on stale prefix
        slots (at or past `base`) and on keys that `mask`, `attn_mask`,
        `max_attend` or causality exclude. A mask that differs between batch
        rows cannot fold into one bias: it raises."""
        dev = pos_q.device
        if self.rel_pos is not None:
            bias = self.rel_pos(pos_q, key_pos)[:, 0]
        else:
            bias = torch.zeros(self.heads, key_pos.shape[0], device=dev)
        ok = (torch.arange(key_pos.shape[0], device=dev) >= cap) | (key_pos < base)
        if mask is not None:
            if mask.shape[0] != 1:
                raise NotImplementedError("chunked decode: a per-row key mask cannot fold into the bias")
            ok = ok & mask[0].bool()
        if attn_mask is not None:
            am = _attn_mask_4d(attn_mask)
            if am.shape[0] != 1:
                raise NotImplementedError("chunked decode: a per-row attn_mask cannot fold into the bias")
            ok = ok & am[0, :, 0].bool()
        dist = pos_q[:, None] - key_pos[None, :]
        if self.max_attend is not None:
            ok = ok & (-self.max_attend < dist) & (dist <= self.max_attend)
        if self.causal:
            ok = ok & (dist >= 0)
        return torch.where(ok, bias, MASK_VALUE)

    def _chunked_cache_attend(self, x, mask, attn_mask, cache, cache_index):
        """Decode attention of one query row over a frozen prefix cache
        {"k","v"} (cap, b, kv), int8 ones with row scales {"k_s","v_s"}, plus
        the chunk's fresh buffers {"fk","fv"} (C, b, kv); "base" (an int) is
        the global position of fresh slot 0 and the number of prefix slots
        written. The step's rows are written into the fresh buffers in place.
        The prefix half runs through `prefix_attend` (the split-K kernel on
        the GPU), the fresh half here, and `combine_lse` joins them: the JAX
        module's single softmax over [prefix | fresh], reassociated."""
        b, n = x.shape[:2]
        if n != 1:
            raise NotImplementedError("the chunked decode attends one query row per step")
        h, d = self.heads, self.dim_head
        scale = d**-0.5
        idx = cache_index
        base = cache["base"]

        q = self.to_q(x).reshape(b, h, d)
        fk, fv = write_kv_pair(cache["fk"], cache["fv"], self._cache_rows(self.to_k(x), cache["fk"]),
                               self._cache_rows(self.to_v(x), cache["fv"]), idx - base)
        cap, chunk = cache["k"].shape[0], fk.shape[0]
        dev = x.device

        pos_q = idx + torch.arange(n, device=dev)
        key_pos = torch.cat([torch.arange(cap, device=dev), base + torch.arange(chunk, device=dev)])

        bias = self._decode_bias(mask, attn_mask, pos_q, key_pos, cap, base)

        # the fresh half: the chunk's C slots
        dots = (q[:, :, None] @ self._split_kv(fk).to(q.dtype).transpose(-1, -2))[:, :, 0] * scale
        dots = (dots + bias[None, :, cap:]).float()
        m_f = dots.amax(dim=-1, keepdim=True)
        p_f = torch.exp(dots - m_f)
        l_f = p_f.sum(dim=-1, keepdim=True)
        o_f = ((p_f / l_f)[:, :, None] @ self._split_kv(fv).to(q.dtype))[:, :, 0]
        if cap == 0:  # a static prefix's first chunk: no prefix, the fresh chunk's softmax alone
            return self.to_out(o_f.reshape(b, n, h * d))
        lse_f = (m_f + torch.log(l_f))[..., 0]

        o_p, lse_p = prefix_attend(
            (q * scale).contiguous(), cache["k"], cache["v"], bias[:, :cap].contiguous(),
            cache.get("k_s"), cache.get("v_s"), n_valid=base,
        )
        out, _ = combine_lse(o_p, lse_p, o_f, lse_f)
        return self.to_out(out.reshape(b, n, h * d))

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        context_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[torch.Tensor] = None,
        sequence_parallel: bool = False,
    ) -> torch.Tensor:
        """Without a cache: full attention over `x` (or cross-attention over
        `context`). With a cache: the keys/values of `x` are written IN PLACE
        at slot `cache_index % cap` (a ring) and the queries attend over the
        whole buffer, masked to the written positions. With
        `sequence_parallel` (a model-sharded layer), `x` and the output are
        this rank's slice of the sequence; `mask` covers the whole one."""
        sharded = self.head_range is not None
        if sharded:
            if cache is not None:
                raise NotImplementedError("a model axis shards the training and eval forward, not a cached decode")
            x = (gather_seq_to_group if sequence_parallel else copy_to_group)(x, MODEL_AXIS)
            context = None if context is None else copy_to_group(context, MODEL_AXIS)
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
        k, v = self._project_kv(kv_input)

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
            return self._close(out, mask, sharded, sequence_parallel)

        has_cache = cache is not None
        if has_cache:
            if context is not None:
                raise ValueError("a cache is not compatible with cross-attention")
            idx = cache_index if cache_index is not None else torch.zeros(1, dtype=torch.int64, device=dev)
            cap = cache["k"].shape[0]
            # ring buffer: single-position steps past the capacity wrap and the
            # cache then holds the last `cap` positions
            slot = idx % cap
            k_t, v_t = write_kv_pair(cache["k"], cache["v"], self._cache_rows(k, cache["k"]),
                                     self._cache_rows(v, cache["v"]), slot)
            j = cap
            pos_q = idx + torch.arange(n, device=dev)
            # absolute position held by each slot: the latest write at or
            # before the last query position that maps to that slot
            p_last = idx + n - 1
            key_pos = p_last - torch.remainder(p_last - torch.arange(j, device=dev), cap)
            key_valid = key_pos >= 0
            k_h, v_h = self._split_kv(k_t).to(q.dtype), self._split_kv(v_t).to(q.dtype)
        else:
            j = k.shape[1]
            pos_q = (j - n) + torch.arange(n, device=dev) if context is None else torch.arange(n, device=dev)
            key_pos = torch.arange(j, device=dev)
            key_valid = None
            k_h = k.reshape(b, j, self.kv_heads, d).transpose(1, 2)
            v_h = v.reshape(b, j, self.kv_heads, d).transpose(1, 2)
        dots = (q @ k_h.transpose(-1, -2)) * scale

        if self.rel_pos is not None:  # in the scores' type, as the JAX module adds it
            dots = dots + self.rel_pos(pos_q, key_pos)[None].to(dots.dtype)
        if self.softmax_bf16:
            dots = dots.to(torch.bfloat16)

        # boolean masks, each broadcastable to dots (b, h, n, j), ANDed and
        # applied in one select (the bits of one select a mask)
        oks = []
        input_mask = context_mask if (context is not None and context_mask is not None) else mask
        if input_mask is not None:
            oks.append(input_mask[:, None, None, :])
        if attn_mask is not None:
            oks.append(_attn_mask_4d(attn_mask))
        if self.max_attend is not None:
            dist = pos_q[:, None] - key_pos[None, :]
            oks.append(((-self.max_attend < dist) & (dist <= self.max_attend))[None, None])
        if self.causal:
            oks.append((key_pos[None, :] <= pos_q[:, None])[None, None])
        if key_valid is not None:
            oks.append(key_valid[None, None, None, :])
        if oks:
            ok = oks[0]
            for m in oks[1:]:
                ok = ok & m
            dots = torch.where(ok, dots, MASK_VALUE)

        if self.softmax_bf16:
            # jax.nn.softmax's steps, each rounded to bf16; JAX promotes the
            # bf16 probabilities to fp32 for the product with fp32 values
            u = torch.exp(dots - dots.amax(dim=-1, keepdim=True))
            attn = self.attn_dropout(u / u.sum(dim=-1, keepdim=True)).to(v_h.dtype)
        else:
            attn = self.attn_dropout(torch.softmax(dots.float(), dim=-1).to(dots.dtype))
        out = (attn @ v_h).transpose(1, 2).reshape(b, n, h * d)
        out = self.to_out(out)
        return self._close(out, None if has_cache else mask, sharded, sequence_parallel)

    @staticmethod
    def _close(out, mask, sharded, sequence_parallel):
        """The ranks' partial outputs summed (each keeping its slice of the
        sequence with `sequence_parallel`), padded positions zeroed."""
        if sharded:
            out = (reduce_scatter_seq if sequence_parallel else reduce_from_group)(out, MODEL_AXIS)
        if mask is not None:
            out = out * (seq_block(mask, MODEL_AXIS) if sequence_parallel else mask)[..., None]
        return out

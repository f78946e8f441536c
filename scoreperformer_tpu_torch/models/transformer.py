"""Transformer stack: pre/post-norm residual blocks with the ('a','c','f')
layer pattern, AdaLayerNorm style conditioning and static KV caches.

Counterpart of scoreperformer_tpu/models/transformer.py. Layer `i` lives at
`layers.{i}` as [[norm], block], the reference's layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from ..configs import ModuleConfig
from .attention import Attention, init_kv_cache
from .layers import AdaptiveLayerNorm, FeedForward


@dataclass
class AttentionConfig(ModuleConfig):
    dim_head: int = 64
    dropout: float = 0.0
    one_kv_head: bool = False
    max_attend_past: Optional[int] = None
    alibi_pos_bias: bool = False
    alibi_num_heads: Optional[int] = None
    alibi_symmetric: bool = True
    alibi_learned: bool = False
    use_flash: bool = False
    fused_mask_select: bool = False
    softmax_bf16: bool = False


@dataclass
class FeedForwardConfig(ModuleConfig):
    mult: int = 4
    glu: bool = False
    swish: bool = False
    post_act_ln: bool = False
    dropout: float = 0.0
    no_bias: bool = True
    num_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_stride: int = 1
    router_aux_weight: float = 1e-2
    router_z_weight: float = 0.0


@dataclass
class TransformerConfig(ModuleConfig):
    _target_: str = "default"
    dim: int = 512
    depth: int = 4
    heads: int = 8
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    feed_forward: FeedForwardConfig = field(default_factory=FeedForwardConfig)
    causal: bool = False
    cross_attend: bool = False
    only_cross: bool = False
    pre_norm: bool = True
    use_adanorm: bool = False
    style_emb_dim: Optional[int] = None
    final_norm: bool = True

    def layer_types(self) -> Tuple[str, ...]:
        if self.cross_attend and not self.only_cross:
            block = ("a", "c", "f")
        elif self.cross_attend and self.only_cross:
            block = ("c", "f")
        else:
            block = ("a", "f")
        return block * self.depth


class TransformerStack(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        att = cfg.attention
        if cfg.feed_forward.num_experts > 1:
            raise NotImplementedError("MoE feed-forward layers are not ported yet")
        if att.fused_mask_select or att.softmax_bf16:
            raise NotImplementedError("fused_mask_select / softmax_bf16 are not ported yet")
        if cfg.use_adanorm and cfg.style_emb_dim is None:
            raise ValueError("style_emb_dim required for adanorm")
        self.layer_types = cfg.layer_types()

        def make_norm():
            if cfg.use_adanorm:
                return AdaptiveLayerNorm(cfg.dim, cfg.style_emb_dim)
            return nn.LayerNorm(cfg.dim, eps=1e-5)

        layers = []
        for layer_type in self.layer_types:
            if layer_type in ("a", "c"):
                block = Attention(
                    dim=cfg.dim,
                    heads=cfg.heads,
                    causal=cfg.causal if layer_type == "a" else False,
                    dropout=att.dropout,
                    dim_head=att.dim_head,
                    one_kv_head=att.one_kv_head,
                    max_attend=att.max_attend_past if layer_type == "a" else None,
                    alibi_pos_bias=att.alibi_pos_bias,
                    alibi_num_heads=att.alibi_num_heads,
                    alibi_symmetric=att.alibi_symmetric,
                    alibi_learned=att.alibi_learned,
                    use_flash=att.use_flash if layer_type == "a" else False,
                )
            else:
                ff = cfg.feed_forward
                block = FeedForward(
                    dim=cfg.dim, mult=ff.mult, glu=ff.glu, swish=ff.swish,
                    post_act_ln=ff.post_act_ln, dropout=ff.dropout, no_bias=ff.no_bias,
                )
            layers.append(nn.ModuleList([nn.ModuleList([make_norm()]), block]))
        self.layers = nn.ModuleList(layers)
        self.final_norm = make_norm() if (cfg.pre_norm and cfg.final_norm) else None

    def _apply_norm(self, norm, x, style_embeddings):
        if self.config.use_adanorm:
            return norm(x, condition=style_embeddings)
        return norm(x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device="cpu") -> List[Any]:
        """Per-self-attention-layer static KV caches."""
        att = self.config.attention
        kv_dim = att.dim_head * (1 if att.one_kv_head else self.config.heads)
        return [
            init_kv_cache(batch, max_len, kv_dim, dtype, device) if lt == "a" else None
            for lt in self.layer_types
        ]

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        context: Optional[torch.Tensor] = None,
        context_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        style_embeddings: Optional[torch.Tensor] = None,
        caches: Optional[List[Any]] = None,
        cache_index: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """With `caches`, each self-attention layer updates its cache in place."""
        cfg = self.config
        if cfg.cross_attend != (context is not None):
            raise ValueError("context must be passed iff cross_attend is set")
        has_cache = caches is not None
        # with a cache, `mask` covers the cache buffer (keys); queries are x
        attn_in_mask = None if has_cache else mask

        for ind, (layer_type, (norms, block)) in enumerate(zip(self.layer_types, self.layers)):
            residual = x
            if cfg.pre_norm:
                x = self._apply_norm(norms[0], x, style_embeddings)
            if layer_type == "a":
                out = block(
                    x, mask=mask, attn_mask=attn_mask,
                    cache=caches[ind] if has_cache else None, cache_index=cache_index,
                )
            elif layer_type == "c":
                out = block(x, context=context, mask=attn_in_mask, context_mask=context_mask)
            else:
                out = block(x)
            x = out + residual
            if not cfg.pre_norm:
                x = self._apply_norm(norms[0], x, style_embeddings)

        if self.final_norm is not None:
            x = self._apply_norm(self.final_norm, x, style_embeddings)
        return x

"""Transformer stack: pre/post-norm residual blocks with the ('a','c','f')
layer pattern, AdaLayerNorm style conditioning and static KV caches.

Counterpart of scoreperformer_tpu/models/transformer.py. Layer `i` lives at
`layers.{i}` as [[norm], block], the reference's layout. With
`feed_forward.num_experts > 1`, every `moe_stride`-th feed-forward of a stack
(counted by feed-forward ordinal, per stack) is a `moe.MoEFeedForward`; the
stack hands each MoE layer's (aux loss, drop rate) to the caller's
`moe_stats` list.

Sequence parallelism (JAX's `shard_seq_activations` after every residual
add, scoreperformer_tpu/models/transformer.py:267): on a mesh with
`sequence_parallel` set, whose model axis splits every block of the stack,
the residual stream lives split over the sequence on the model ranks. The
stack's input enters it (`scatter_seq`), the norms, residual adds and the
AdaNorm style rows run on the rank's slice (the norms' parameters and a
style vector take their gradient summed over the slices), each block
gathers the whole
sequence and hands back its slice (`models/attention.py`,
`models/layers.py`), and the output leaves it (`gather_seq`). As JAX's
constraint, it is a no-op where the sequence does not divide the model
axis (a data rank always holds a whole block of the batch here); the
values are those without it, only memory changes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from ..configs import ModuleConfig
from ..ops import head_layout
from ..parallel.collectives import copy_to_group, gather_seq, scatter_seq
from ..parallel.mesh import MODEL_AXIS, current
from .attention import Attention, init_kv_cache
from .layers import AdaptiveLayerNorm, FeedForward, LayerNorm
from .moe import MoEFeedForward


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
    # read from the recipes and not passed on: Attention always ANDs the
    # boolean masks into one select, the bits of either JAX form
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
        att, ff = cfg.attention, cfg.feed_forward
        if cfg.use_adanorm and cfg.style_emb_dim is None:
            raise ValueError("style_emb_dim required for adanorm")
        self.layer_types = cfg.layer_types()

        def make_norm():
            if cfg.use_adanorm:
                return AdaptiveLayerNorm(cfg.dim, cfg.style_emb_dim)
            return LayerNorm(cfg.dim, eps=1e-5)

        layers = []
        ff_ord = 0
        stride = max(1, int(ff.moe_stride))
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
                    softmax_bf16=att.softmax_bf16,
                )
            elif ff.num_experts > 1 and ff_ord % stride == stride - 1:
                if ff.post_act_ln:
                    raise ValueError("post_act_ln is not supported by MoE feed-forward layers "
                                     "(num_experts > 1); disable one of them")
                block = MoEFeedForward(
                    dim=cfg.dim, num_experts=ff.num_experts, mult=ff.mult, top_k=ff.expert_top_k,
                    capacity_factor=ff.capacity_factor, glu=ff.glu, swish=ff.swish, dropout=ff.dropout,
                    no_bias=ff.no_bias, router_aux_weight=ff.router_aux_weight, router_z_weight=ff.router_z_weight,
                )
            else:
                block = FeedForward(
                    dim=cfg.dim, mult=ff.mult, glu=ff.glu, swish=ff.swish,
                    post_act_ln=ff.post_act_ln, dropout=ff.dropout, no_bias=ff.no_bias,
                )
            ff_ord += layer_type == "f"
            layers.append(nn.ModuleList([nn.ModuleList([make_norm()]), block]))
        self.layers = nn.ModuleList(layers)
        self.final_norm = make_norm() if (cfg.pre_norm and cfg.final_norm) else None

    def _apply_norm(self, norm, x, style_embeddings, sequence_parallel=False):
        if self.config.use_adanorm:
            return norm(x, condition=style_embeddings, sequence_parallel=sequence_parallel)
        return norm(x, sequence_parallel=sequence_parallel)

    def _sequence_parallel(self, x: torch.Tensor, caches) -> bool:
        """The residual stream splits over the model axis: the active mesh
        asks for it, the model axis splits every block and the sequence
        divides it; never with caches."""
        mesh = current()
        if mesh is None or not mesh.sequence_parallel or caches is not None:
            return False
        n = mesh.size(MODEL_AXIS)
        if n <= 1 or x.shape[1] % n:
            return False
        return all(block.head_range is not None if isinstance(block, Attention)
                   else isinstance(block, FeedForward) and block.model_sharded for _, block in self.layers)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device="cpu") -> List[Any]:
        """Per-self-attention-layer static KV caches, each head at the width
        the device's kernels take (`head_layout.head_width`)."""
        att = self.config.attention
        kv_dim = head_layout.head_width(att.dim_head, device) * (1 if att.one_kv_head else self.config.heads)
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
        moe_stats: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
        return_hiddens: bool = False,
    ):
        """The output, or with `return_hiddens` (output, hiddens): the input
        of every self-attention layer and the output, as the JAX stack's
        hiddens. With `caches`, each self-attention layer updates its cache in
        place. With `moe_stats` (a list), each MoE layer appends its (aux
        loss, drop rate) to it. MoE routing takes `mask` as its padding mask
        only without caches and when it covers x's tokens (with a cache,
        `mask` covers the cache's keys): otherwise every token routes."""
        cfg = self.config
        if cfg.cross_attend != (context is not None):
            raise ValueError("context must be passed iff cross_attend is set")
        has_cache = caches is not None
        # with a cache, `mask` covers the cache buffer (keys); queries are x
        attn_in_mask = None if has_cache else mask
        sp = self._sequence_parallel(x, caches)
        if sp:
            x = scatter_seq(x, MODEL_AXIS)
            if style_embeddings is not None:  # rows go with their positions; a vector's gradient sums over the slices
                style_embeddings = (scatter_seq if style_embeddings.ndim == 3 else copy_to_group)(style_embeddings,
                                                                                                 MODEL_AXIS)

        hiddens = []
        for ind, (layer_type, (norms, block)) in enumerate(zip(self.layer_types, self.layers)):
            if layer_type == "a" and return_hiddens:
                hiddens.append(x)
            residual = x
            if cfg.pre_norm:
                x = self._apply_norm(norms[0], x, style_embeddings, sp)
            if layer_type == "a":
                out = block(
                    x, mask=mask, attn_mask=attn_mask,
                    cache=caches[ind] if has_cache else None, cache_index=cache_index, sequence_parallel=sp,
                )
            elif layer_type == "c":
                out = block(x, context=context, mask=attn_in_mask, context_mask=context_mask, sequence_parallel=sp)
            elif isinstance(block, MoEFeedForward):
                ff_mask = mask if not has_cache and mask is not None and mask.shape[:2] == x.shape[:2] else None
                if moe_stats is None:
                    out = block(x, mask=ff_mask)
                else:
                    out, aux, drop = block(x, mask=ff_mask, with_stats=True)
                    moe_stats.append((aux, drop))
            else:
                out = block(x, sequence_parallel=sp)
            x = out + residual
            if not cfg.pre_norm:
                x = self._apply_norm(norms[0], x, style_embeddings, sp)

        if self.final_norm is not None:
            x = self._apply_norm(self.final_norm, x, style_embeddings, sp)
        if not return_hiddens:
            return gather_seq(x, MODEL_AXIS) if sp else x
        hiddens.append(x)
        if sp:
            hiddens = [gather_seq(hid, MODEL_AXIS) for hid in hiddens]
        return hiddens[-1], hiddens

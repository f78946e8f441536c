"""TupleTransformer: a transformer over tuple-token sequences.

Counterpart of scoreperformer_tpu/models/tuple_transformer.py, with static
KV caches threaded through the stack for the decode loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from ..configs import ModuleConfig
from .embeddings import (
    StreamEmbedding,
    TupleTokenEmbeddings,
    TupleTokenEmbeddingsConfig,
    TupleTokenHeadConfig,
    TupleTokenLMHead,
    TupleTokenRegressionHead,
    TupleTokenRegressionHeadConfig,
    TupleTokenTiedLMHead,
    TupleTokenTiedSplitLMHead,
)
from .dropout import Dropout
from .layers import AbsolutePositionalEmbedding, LayerNorm, Linear
from .transformer import TransformerConfig, TransformerStack


class EmbeddingModes:
    SUM = "mean"
    CONCAT = "cat"
    ATTENTION = "attention"
    ADANORM = "adanorm"


@dataclass
class TupleTransformerOutput:
    """What `TupleTransformerModule.forward` returns when asked for more than
    the hidden state (the JAX module's output)."""
    hidden_state: torch.Tensor
    logits: Optional[Dict[str, torch.Tensor]] = None
    reg_values: Optional[Dict[str, torch.Tensor]] = None
    caches: Optional[List[Any]] = None
    hiddens: Optional[List[torch.Tensor]] = None


@dataclass
class TupleTransformerConfig(ModuleConfig):
    dim: int = 512
    max_seq_len: int = 1024
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    token_embeddings: TupleTokenEmbeddingsConfig = field(default_factory=TupleTokenEmbeddingsConfig)
    use_abs_pos_emb: bool = True
    emb_norm: bool = False
    emb_dropout: float = 0.0
    context_emb_dim: Optional[int] = None
    context_emb_mode: str = EmbeddingModes.ATTENTION
    style_emb_dim: Optional[Union[int, List[int]]] = None
    style_emb_mode: str = EmbeddingModes.CONCAT
    lm_head: Optional[TupleTokenHeadConfig] = None
    regression_head: Optional[TupleTokenRegressionHeadConfig] = None

    def resolved_style_dim(self) -> int:
        if self.style_emb_dim is None:
            return 0
        if isinstance(self.style_emb_dim, (list, tuple)):
            return int(sum(self.style_emb_dim))
        return int(self.style_emb_dim)


class TupleTransformerModule(nn.Module):
    def __init__(
        self,
        num_tokens: Dict[str, int],
        config: TupleTransformerConfig,
        shared_streams: Optional[Dict[str, StreamEmbedding]] = None,
    ):
        super().__init__()
        cfg = self.config = config
        self.num_tokens = dict(num_tokens)
        dim = cfg.dim
        self.context_dim = cfg.context_emb_dim or 0
        self.style_dim = cfg.resolved_style_dim()

        self.token_emb = TupleTokenEmbeddings(
            num_tokens, cfg.token_embeddings, project_emb_dim=dim, shared_streams=shared_streams
        )
        # context by concatenation disables cross-attention
        cross_attend = cfg.transformer.cross_attend and cfg.context_emb_mode == EmbeddingModes.ATTENTION
        self.transformer = TransformerStack(
            cfg.transformer.replace(
                dim=dim,
                cross_attend=cross_attend,
                use_adanorm=cfg.style_emb_mode == EmbeddingModes.ADANORM,
                style_emb_dim=self.style_dim,
            )
        )
        self.pos_emb = AbsolutePositionalEmbedding(dim, cfg.max_seq_len) if cfg.use_abs_pos_emb else None
        self.emb_norm = LayerNorm(dim, eps=1e-5) if cfg.emb_norm else None
        self.emb_dropout = Dropout(cfg.emb_dropout)
        total_emb_dim = (
            dim
            + int(cfg.context_emb_mode == EmbeddingModes.CONCAT) * self.context_dim
            + int(cfg.style_emb_mode == EmbeddingModes.CONCAT) * self.style_dim
        )
        self.project_emb = Linear(total_emb_dim, dim) if total_emb_dim != dim else None

        self.lm_head = None
        if cfg.lm_head is not None:
            target, filter_keys = cfg.lm_head._target_, cfg.lm_head.filter_keys
            if target == "lm":
                self.lm_head = TupleTokenLMHead(dim, self.num_tokens, filter_keys=filter_keys)
            elif target == "lm-tied":
                self.lm_head = TupleTokenTiedLMHead(self.token_emb.total_emb_dim, dim,
                                                    reuse_projection=cfg.lm_head.reuse_projection)
            elif target == "lm-tied-split":
                self.lm_head = TupleTokenTiedSplitLMHead(dim, self.token_emb, filter_keys=filter_keys)
            else:
                raise ValueError(f"unknown lm head target {target}")
        self.regression_head = None
        if cfg.regression_head is not None:
            self.regression_head = TupleTokenRegressionHead(dim, cfg.regression_head.regression_keys)

    @property
    def dim(self) -> int:
        return self.config.dim

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device="cpu"):
        return self.transformer.init_cache(batch, max_len, dtype, device)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        x_extra: Optional[List[torch.Tensor]] = None,
        style_embeddings: Optional[torch.Tensor] = None,
        context: Optional[torch.Tensor] = None,
        context_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        caches: Optional[List[Any]] = None,
        cache_index: Optional[torch.Tensor] = None,
        moe_stats: Optional[list] = None,
        return_embeddings: Optional[bool] = None,
        return_hiddens: bool = False,
        logits_keys: Optional[List[str]] = None,
    ) -> Union[torch.Tensor, TupleTransformerOutput]:
        """The hidden states; `apply_lm_head` turns them into logits. MoE
        layers append their (aux loss, drop rate) to `moe_stats`, a list.
        Given any of `return_embeddings`, `return_hiddens` or `logits_keys`,
        a `TupleTransformerOutput`, as the JAX module returns: the hidden
        state; unless `return_embeddings`, the heads' logits and regression
        values (of `logits_keys` only, when given); the caches, updated in
        place; with `return_hiddens`, the stack's hiddens."""
        cfg = self.config
        if x_extra is not None and not isinstance(x_extra, (list, tuple)):
            x_extra = [x_extra]

        h = self.token_emb(x, x_extra=x_extra)
        n = h.shape[1]
        if self.pos_emb is not None:
            pos = torch.arange(n, device=h.device)
            if cache_index is not None:
                pos = cache_index + pos
            h = h + self.pos_emb(pos)
        if self.emb_norm is not None:
            h = self.emb_norm(h)
        if context is not None and cfg.context_emb_mode == EmbeddingModes.CONCAT:
            h = torch.cat([h, context[:, :n]], dim=-1)
            context = None
        if style_embeddings is not None:
            style_embeddings = style_embeddings[:, :n]
            if cfg.style_emb_mode == EmbeddingModes.CONCAT:
                h = torch.cat([h, style_embeddings], dim=-1)
                style_embeddings = None
        h = self.emb_dropout(h)
        if self.project_emb is not None:
            h = self.project_emb(h)

        out = self.transformer(
            h, mask=mask, context=context, context_mask=context_mask, attn_mask=attn_mask,
            style_embeddings=style_embeddings, caches=caches, cache_index=cache_index, moe_stats=moe_stats,
            return_hiddens=return_hiddens,
        )
        if return_embeddings is None and not return_hiddens and logits_keys is None:
            return out
        hidden, hiddens = out if return_hiddens else (out, None)
        logits = reg_values = None
        if not return_embeddings:
            if self.lm_head is not None:
                logits = self.apply_lm_head(hidden, keys=logits_keys)
            reg_values = self.apply_regression_head(hidden, keys=logits_keys)
        return TupleTransformerOutput(hidden_state=hidden, logits=logits, reg_values=reg_values, caches=caches,
                                      hiddens=hiddens)

    def apply_lm_head(self, hidden: torch.Tensor, keys: Optional[List[str]] = None, batched: bool = False):
        """Per-stream logits, keyed in the order of `num_tokens` (of `keys`
        only, when given); with `batched`, the tied head's one (..., S, Vmax)
        tensor (`TupleTokenTiedLMHead.forward`)."""
        if batched:
            if not isinstance(self.lm_head, TupleTokenTiedLMHead):
                raise ValueError("batched logits are only available on the tied LM head")
            return self.lm_head(hidden, self.token_emb, keys=keys, batched=True)
        return self.lm_head(hidden, self.token_emb, keys=keys)

    def apply_regression_head(self, hidden: torch.Tensor, keys: Optional[List[str]] = None):
        """{key: (..., 1) value} of the regression head, None without one
        (the JAX output's `reg_values`)."""
        if self.regression_head is None:
            return None
        return self.regression_head(hidden, keys=keys)

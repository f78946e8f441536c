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
    TupleTokenRegressionHeadConfig,
    TupleTokenTiedLMHead,
)
from .dropout import Dropout
from .layers import AbsolutePositionalEmbedding
from .transformer import TransformerConfig, TransformerStack


class EmbeddingModes:
    SUM = "mean"
    CONCAT = "cat"
    ATTENTION = "attention"
    ADANORM = "adanorm"


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
        self.emb_norm = nn.LayerNorm(dim, eps=1e-5) if cfg.emb_norm else None
        self.emb_dropout = Dropout(cfg.emb_dropout)
        total_emb_dim = (
            dim
            + int(cfg.context_emb_mode == EmbeddingModes.CONCAT) * self.context_dim
            + int(cfg.style_emb_mode == EmbeddingModes.CONCAT) * self.style_dim
        )
        self.project_emb = nn.Linear(total_emb_dim, dim) if total_emb_dim != dim else None

        self.lm_head = None
        if cfg.lm_head is not None:
            if cfg.lm_head._target_ != "lm-tied" or not cfg.lm_head.reuse_projection:
                raise NotImplementedError(
                    f"LM head {cfg.lm_head._target_!r} is not ported yet; only the tied head is"
                )
            self.lm_head = TupleTokenTiedLMHead(self.token_emb.total_emb_dim)
        if cfg.regression_head is not None:
            raise NotImplementedError("regression heads are not ported yet")

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
    ) -> torch.Tensor:
        """The hidden states; `apply_lm_head` turns them into logits."""
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

        return self.transformer(
            h, mask=mask, context=context, context_mask=context_mask, attn_mask=attn_mask,
            style_embeddings=style_embeddings, caches=caches, cache_index=cache_index,
        )

    def apply_lm_head(self, hidden: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-stream logits, keyed in the order of `num_tokens`."""
        return self.lm_head(hidden, self.token_emb)

"""ScorePerformer composite model, inference path.

Counterpart of scoreperformer_tpu/models/scoreperformer.py: the score encoder
and the MMD style encoder produce context and style embeddings; the
performance decoder consumes them one position at a time over static KV
caches. The training forward and its losses are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from ..configs import ModuleConfig
from ..device import resolve_device
from .embeddings import TupleTokenHeadConfig, build_stream_embeddings
from .mmd import MMDTupleTransformer, MMDTupleTransformerConfig
from .tuple_transformer import TupleTransformerConfig, TupleTransformerModule


@dataclass
class ScorePerformerConfig(ModuleConfig):
    num_tokens: Optional[Dict[str, int]] = None
    dim: int = 256
    perf_decoder: TupleTransformerConfig = field(default_factory=TupleTransformerConfig)
    score_encoder: Optional[TupleTransformerConfig] = None
    perf_encoder: Optional[MMDTupleTransformerConfig] = None
    classifiers: Optional[dict] = None
    tie_token_emb: bool = False
    mode: Optional[str] = None
    num_score_tokens: Optional[Dict[str, int]] = None


class _DecoderWrapper(nn.Module):
    """The reference wraps the decoder in its LM wrapper, so the decoder's
    parameters live under `perf_decoder.model.`."""

    def __init__(self, model: TupleTransformerModule):
        super().__init__()
        self.model = model


class ScorePerformerModel(nn.Module):
    """Built on the GPU unless `device` says otherwise; with no GPU the
    default raises."""

    def __init__(self, config: ScorePerformerConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        num_tokens = cfg.num_tokens
        num_score_tokens = cfg.num_score_tokens or num_tokens
        # classifier heads read the style embeddings in training only; they
        # are not ported, and their weights are skipped on load
        shared = (
            build_stream_embeddings(num_tokens, cfg.perf_decoder.token_embeddings, cfg.dim)
            if cfg.tie_token_emb
            else None
        )
        self.score_encoder = None
        if cfg.score_encoder is not None:
            self.score_encoder = TupleTransformerModule(
                num_score_tokens, cfg.score_encoder.replace(dim=cfg.dim, lm_head=None), shared_streams=shared
            )
        self.perf_encoder = None
        if cfg.perf_encoder is not None:
            self.perf_encoder = MMDTupleTransformer(
                num_tokens, cfg.perf_encoder.replace(dim=cfg.dim, lm_head=None), shared_streams=shared
            )
        dec_cfg = cfg.perf_decoder.replace(
            dim=cfg.dim,
            context_emb_dim=None if cfg.score_encoder is None else cfg.dim,
            style_emb_dim=None if cfg.perf_encoder is None else cfg.perf_encoder.embedding_dim,
        )
        dec_cfg.transformer = dec_cfg.transformer.replace(cross_attend=cfg.score_encoder is not None)
        if dec_cfg.lm_head is None:
            dec_cfg.lm_head = TupleTokenHeadConfig(_target_="lm")
        self.perf_decoder = _DecoderWrapper(TupleTransformerModule(num_tokens, dec_cfg, shared_streams=shared))
        self.to(device)

    @property
    def decoder(self) -> TupleTransformerModule:
        return self.perf_decoder.model

    def forward_encoders(self, perf=None, perf_mask=None, score=None, score_mask=None,
                         bars=None, beats=None, onsets=None):
        score_emb = perf_emb = perf_enc_out = None
        if self.score_encoder is not None:
            score_emb = self.score_encoder(score, mask=score_mask)
        if self.perf_encoder is not None:
            perf_enc_out = self.perf_encoder(perf, mask=perf_mask, bars=bars, beats=beats, onsets=onsets)
            perf_emb = perf_enc_out.embeddings
        return score_emb, perf_emb, perf_enc_out

    def encode_embeddings(self, perf, perf_mask=None, score=None, score_mask=None,
                          bars=None, beats=None, onsets=None):
        """Encoder pass only: (score_emb, style_emb, perf_encoder output)."""
        return self.forward_encoders(
            perf=perf, perf_mask=perf_mask, score=score, score_mask=score_mask,
            bars=bars, beats=beats, onsets=onsets,
        )

    def decode_step(self, seq_tokens, masked_tokens=None, style_embeddings=None, context=None,
                    caches=None, cache_index=None, mask=None):
        """Decoder hidden states of a few positions over static KV caches,
        which are updated in place. Inputs are the already shifted decoder
        tokens."""
        return self.decoder(
            seq_tokens, mask=mask,
            x_extra=[masked_tokens] if masked_tokens is not None else None,
            style_embeddings=style_embeddings,
            context=context,
            caches=caches, cache_index=cache_index,
        )

    def init_decoder_cache(self, batch: int, max_len: int, dtype=torch.float32, device="cpu"):
        return self.decoder.init_cache(batch, max_len, dtype, device)

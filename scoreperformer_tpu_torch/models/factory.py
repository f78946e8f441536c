"""Model config factory: experiment-config dicts -> config dataclasses -> modules.

Counterpart of scoreperformer_tpu/models/factory.py, over the same recipe
schema (the `model:` node after data injection).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .embeddings import TupleTokenEmbeddingsConfig, TupleTokenHeadConfig
from .mmd import MMDTupleTransformerConfig
from .scoreperformer import ScorePerformerConfig, ScorePerformerModel
from .transformer import AttentionConfig, FeedForwardConfig, TransformerConfig
from .tuple_transformer import TupleTransformerConfig


def build_transformer_config(data: Optional[Dict[str, Any]]) -> TransformerConfig:
    data = dict(data or {})
    target = data.get("_target_", "default")
    cfg = TransformerConfig.from_dict(data)
    cfg._target_ = target
    if target == "encoder":
        cfg.causal = False
    elif target == "decoder":
        cfg.causal = True
    if "attention" in data:
        cfg.attention = AttentionConfig.from_dict(data["attention"])
    if "feed_forward" in data:
        cfg.feed_forward = FeedForwardConfig.from_dict(data["feed_forward"])
    return cfg


def build_tuple_transformer_config(data: Optional[Dict[str, Any]], mmd: bool = False) -> TupleTransformerConfig:
    data = dict(data or {})
    cfg = (MMDTupleTransformerConfig if mmd else TupleTransformerConfig).from_dict(data)
    if "transformer" in data:
        cfg.transformer = build_transformer_config(data["transformer"])
    if "token_embeddings" in data:
        emb = dict(data["token_embeddings"])
        cfg.token_embeddings = TupleTokenEmbeddingsConfig.from_dict(emb)
        cfg.token_embeddings._target_ = emb.get("_target_", "simple")
    cfg.lm_head = None
    if data.get("lm_head") is not None:
        head = dict(data["lm_head"])
        cfg.lm_head = TupleTokenHeadConfig.from_dict(head)
        cfg.lm_head._target_ = head.get("_target_", "lm")
    if data.get("regression_head") is not None:
        raise NotImplementedError("regression heads are not ported yet")
    return cfg


def build_scoreperformer_config(data: Dict[str, Any]) -> ScorePerformerConfig:
    """Full model config from a recipe `model:` dict (post data-injection)."""
    data = dict(data)
    cfg = ScorePerformerConfig.from_dict(data)
    cfg.perf_decoder = build_tuple_transformer_config(data.get("perf_decoder"))
    cfg.score_encoder = (
        build_tuple_transformer_config(data["score_encoder"]) if data.get("score_encoder") is not None else None
    )
    cfg.perf_encoder = (
        build_tuple_transformer_config(data["perf_encoder"], mmd=True) if data.get("perf_encoder") is not None else None
    )
    return cfg


def build_scoreperformer(
    data: Dict[str, Any], device="cuda", seed: Optional[int] = None
) -> Tuple[ScorePerformerModel, ScorePerformerConfig]:
    """Build the model from a config dict on `device` (the GPU by default);
    with `seed`, the initial weights come from that seed alone."""
    cfg = build_scoreperformer_config(data)
    if seed is None:
        return ScorePerformerModel(cfg, device=device), cfg
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return ScorePerformerModel(cfg, device=device), cfg

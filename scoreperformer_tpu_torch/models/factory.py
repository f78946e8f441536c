"""Model config factory: experiment-config dicts -> config dataclasses -> modules.

Counterpart of scoreperformer_tpu/models/factory.py, over the same recipe
schema (the `model:` node after data injection).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .classifiers import LinearEmbeddingClassifierConfig, MultiHeadEmbeddingClassifierConfig
from .embeddings import TupleTokenEmbeddingsConfig, TupleTokenHeadConfig, TupleTokenRegressionHeadConfig
from .mmd import MMDTupleTransformerConfig
from .scoreperformer import PerformerConfig, PerformerModel, ScorePerformerConfig, ScorePerformerModel
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
    cfg.regression_head = None
    if data.get("regression_head") is not None:
        cfg.regression_head = TupleTokenRegressionHeadConfig.from_dict(data["regression_head"])
    return cfg


def build_classifiers_config(data: Optional[Dict[str, Any]]) -> Optional[MultiHeadEmbeddingClassifierConfig]:
    if data is None:
        return None
    data = dict(data)
    cfg = MultiHeadEmbeddingClassifierConfig.from_dict(data)
    if "classifier" in data:
        cfg.classifier = LinearEmbeddingClassifierConfig.from_dict(data["classifier"])
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
    cfg.classifiers = build_classifiers_config(data.get("classifiers"))
    return cfg


def _seeded(build, seed: Optional[int]):
    if seed is None:
        return build()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def build_scoreperformer(
    data: Dict[str, Any], device="cuda", seed: Optional[int] = None
) -> Tuple[ScorePerformerModel, ScorePerformerConfig]:
    """Build the model from a config dict on `device` (the GPU by default);
    with `seed`, the initial weights come from that seed alone."""
    cfg = build_scoreperformer_config(data)
    return _seeded(lambda: ScorePerformerModel(cfg, device=device), seed), cfg


def build_performer_config(data: Dict[str, Any]) -> PerformerConfig:
    """The standalone Performer's config from a recipe `model:` dict (post
    data-injection: `num_tokens` and the token values set)."""
    data = dict(data)
    cfg = PerformerConfig.from_dict(data)
    cfg.transformer = build_tuple_transformer_config(data.get("transformer"))
    cfg.num_tokens = dict(data["num_tokens"])
    return cfg


def build_performer(
    data: Dict[str, Any], device="cuda", seed: Optional[int] = None
) -> Tuple[PerformerModel, PerformerConfig]:
    """The standalone Performer LM, as `build_scoreperformer` builds the
    ScorePerformer."""
    cfg = build_performer_config(data)
    return _seeded(lambda: PerformerModel(cfg, device=device), seed), cfg


# the model constructors by the recipes' `model._name_`
MODELS = {"ScorePerformer": build_scoreperformer, "Performer": build_performer}


def build_model(name: str, data: Dict[str, Any], device="cuda", seed: Optional[int] = None):
    """(model, config) of the model a recipe names."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODELS)}")
    return MODELS[name](data, device=device, seed=seed)

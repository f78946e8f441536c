"""Direction classifiers over the style embeddings.

Counterpart of scoreperformer_tpu/models/classifiers.py: one MLP head per
direction group (dynamics, tempo, articulation...) reads the MMD encoder's
per-note style embeddings and predicts the group's class; the loss is a
cross-entropy weighted per class (effective-number weights) and per note
(padding and deadpan performances weigh 0). Parameter names are the
reference PyTorch ones (`classifiers.heads.<group>.layers.<i>`), which
`convert.py` maps from a JAX tree and a reference `.pt` carries.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..configs import ModuleConfig
from ..parallel.collectives import partial_ratio
from .dropout import dropout
from .layers import Linear


@dataclass
class LinearEmbeddingClassifierConfig(ModuleConfig):
    _target_: str = "linear"
    hidden_dims: Optional[Sequence[int]] = field(default_factory=lambda: (32,))
    dropout: float = 0.0


@dataclass
class MultiHeadEmbeddingClassifierConfig(ModuleConfig):
    _target_: str = "multi-head"
    num_classes: Optional[Dict[str, int]] = None
    classifier: LinearEmbeddingClassifierConfig = field(default_factory=LinearEmbeddingClassifierConfig)
    class_samples: Optional[Dict[str, List[int]]] = None
    weighted_classes: bool = False
    loss_weight: float = 1.0
    detach_inputs: Union[bool, float] = False


@dataclass
class EmbeddingClassifierOutput:
    logits: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None


@dataclass
class MultiHeadEmbeddingClassifierOutput:
    logits: Optional[Dict[str, torch.Tensor]] = None
    loss: Optional[torch.Tensor] = None
    losses: Optional[Dict[str, torch.Tensor]] = None


def effective_class_weights(num_samples, beta: float = 0.999, mult: float = 1e4) -> np.ndarray:
    """Effective-number class weighting (classifiers.py:55-61), in float64;
    the heads keep them in fp32, as the JAX heads do."""
    num_samples = np.maximum(np.asarray(num_samples, dtype=np.float64), 1e-6)
    effective_num = 1.0 - np.power(beta, num_samples * mult)
    weights = (1.0 - beta) / effective_num
    weights = weights / weights.sum() * len(num_samples)
    return weights


def weighted_cross_entropy(logits, labels, class_weights=None, sample_weights=None):
    """Cross-entropy weighted per class and per sample (classifiers.py:64-78).
    Labels are clamped to [0, C-1], so a -100 pad reads class 0 and its sample
    weight removes it; the mean is over the sum of the applied weights, at
    least 1e-9, so a batch with no weight gives 0. On a data axis, this
    rank's partial: its weighted sum over the global batch's weights."""
    num_classes = logits.shape[-1]
    labels = labels.long().clamp(0, num_classes - 1)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    w = class_weights[labels] if class_weights is not None else torch.ones_like(nll)
    if sample_weights is not None:
        w = w * sample_weights
    return partial_ratio((nll * w).sum(), w.sum(), min_den=1e-9)


class LinearEmbeddingClassifier(nn.Module):
    """Dropout, Linear and ReLU per hidden dim, then dropout and the output
    Linear (classifiers.py:81-105). The Linears sit at even indices of
    `layers`, ReLUs between them, as in the reference module."""

    def __init__(self, input_dim: int, num_classes: int, hidden_dims: Sequence[int] = (32,),
                 dropout: float = 0.0, class_weights: Optional[np.ndarray] = None):
        super().__init__()
        dims = [input_dim, *(hidden_dims or ())]
        layers: List[nn.Module] = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layers += [Linear(d_in, d_out), nn.ReLU()]
        layers.append(Linear(dims[-1], num_classes))
        self.layers = nn.Sequential(*layers)
        self.dropout = float(dropout)
        self.register_buffer(
            "class_weights",
            None if class_weights is None else torch.as_tensor(np.asarray(class_weights, np.float32)),
            persistent=False,
        )

    def forward(self, embeddings, labels=None, sample_weights=None) -> EmbeddingClassifierOutput:
        x = embeddings
        for layer in self.layers:
            if isinstance(layer, nn.Linear):
                x = dropout(x, self.dropout, self.training)
            x = layer(x)
        loss = None
        if labels is not None:
            loss = weighted_cross_entropy(x, labels, self.class_weights, sample_weights)
        return EmbeddingClassifierOutput(logits=x, loss=loss)


class GRUCellStack(nn.Module):
    """A GRU over the sequence and a Linear on its last state
    (classifiers.py:108-124). `torch.nn.GRU` orders the gates r, z, n; the
    flax cell's weights enter through `convert.gru_cell_stack_state_from_jax`."""

    def __init__(self, input_dim: int, hidden_dim: int, num_classes: int):
        super().__init__()
        self.gru = nn.GRU(input_dim, hidden_dim, batch_first=True)
        self.out = Linear(hidden_dim, num_classes)

    def forward(self, embeddings, labels=None, class_weights=None) -> EmbeddingClassifierOutput:
        states, _ = self.gru(embeddings)
        logits = self.out(states[:, -1])
        loss = None
        if labels is not None:
            loss = weighted_cross_entropy(logits, labels, class_weights)
        return EmbeddingClassifierOutput(logits=logits, loss=loss)


class MultiHeadEmbeddingClassifier(nn.Module):
    """One `LinearEmbeddingClassifier` per direction group, in the order of
    `num_classes`, with effective-number class weights when
    `weighted_classes` (classifiers.py:127-177). The inputs are mixed as
    d * x.detach() + (1 - d) * x with d = float(detach_inputs); the loss is
    loss_weight times the heads' mean."""

    def __init__(self, input_dim: int, num_classes: Dict[str, int], config: MultiHeadEmbeddingClassifierConfig):
        super().__init__()
        self.config = config
        self.heads = nn.ModuleDict()
        for key, num in num_classes.items():
            class_weights = None
            if config.weighted_classes and config.class_samples and key in config.class_samples:
                class_weights = effective_class_weights(config.class_samples[key])
            self.heads[key] = LinearEmbeddingClassifier(
                input_dim, num, hidden_dims=tuple(config.classifier.hidden_dims or ()),
                dropout=config.classifier.dropout, class_weights=class_weights,
            )
        self.detach = float(config.detach_inputs)

    def forward(self, embeddings, labels=None, sample_weights=None) -> MultiHeadEmbeddingClassifierOutput:
        x = self.detach * embeddings.detach() + (1 - self.detach) * embeddings
        logits, losses = {}, {}
        loss = 0.0
        for i, (key, head) in enumerate(self.heads.items()):
            out = head(x, labels=labels[..., i] if labels is not None else None, sample_weights=sample_weights)
            logits[key] = out.logits
            if out.loss is not None:
                loss = loss + out.loss
                losses["clf/" + key] = out.loss
        loss = self.config.loss_weight * loss / max(1, len(self.heads))
        losses["clf"] = loss
        has_labels = labels is not None
        return MultiHeadEmbeddingClassifierOutput(
            logits=logits, loss=loss if has_labels else None, losses=losses if has_labels else None,
        )

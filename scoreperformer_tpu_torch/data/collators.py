# Verbatim copy of scoreperformer_tpu/data/collators.py; the port imports nothing of the JAX package.
"""Batch collators → fixed-shape numpy arrays.

Counterpart of scoreperformer/data/collators/*.py. TPU-first change: batches
pad to a FIXED `fixed_seq_len` (default: dataset max_seq_len + 2 for SOS/EOS)
instead of the per-batch max, so every training step reuses one compiled XLA
program. MLM/MixedLM masking matches the reference semantics
(performance.py:117-277).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .datasets import ScorePerformanceSample

LABEL_PAD = -100


@dataclass
class SeqInputs:
    tokens: np.ndarray
    mask: np.ndarray
    lengths: np.ndarray


@dataclass
class SeqSegments:
    bar: Optional[np.ndarray] = None
    beat: Optional[np.ndarray] = None
    onset: Optional[np.ndarray] = None


@dataclass
class ScorePerformanceInputs:
    scores: SeqInputs
    performances: SeqInputs
    noisy_performances: Optional[SeqInputs] = None
    segments: Optional[SeqSegments] = None
    directions: Optional[np.ndarray] = None
    deadpan_mask: Optional[np.ndarray] = None
    labels: Optional[SeqInputs] = None
    masked_performances: Optional[SeqInputs] = None


def _pad_stack(seqs: List[np.ndarray], max_len: int, pad_value: int = 0):
    batch = len(seqs)
    S = seqs[0].shape[-1] if seqs[0].ndim == 2 else None
    shape = (batch, max_len, S) if S else (batch, max_len)
    tokens = np.full(shape, pad_value, dtype=np.int64)
    mask = np.zeros((batch, max_len), dtype=bool)
    lengths = np.zeros(batch, dtype=np.int64)
    for i, seq in enumerate(seqs):
        n = min(len(seq), max_len)
        tokens[i, :n] = seq[:n]
        mask[i, :n] = True
        lengths[i] = n
    return SeqInputs(tokens=tokens, mask=mask, lengths=lengths)


class ScorePerformanceCollator:
    """(collators/score_performance.py:36-116)"""

    def __init__(
        self,
        pad_token_id: int = 0,
        pad_to_multiple_of: int = 1,
        fixed_seq_len: Optional[int] = None,
    ):
        self.pad_token_id = pad_token_id
        self.pad_to_multiple_of = pad_to_multiple_of
        self.fixed_seq_len = fixed_seq_len

    def pad_len(self, length: int) -> int:
        if self.fixed_seq_len is not None:
            return self.fixed_seq_len
        if self.pad_to_multiple_of > 1:
            return int(math.ceil(length / self.pad_to_multiple_of) * self.pad_to_multiple_of)
        return length

    def __call__(self, batch: List[ScorePerformanceSample]) -> ScorePerformanceInputs:
        perf_len = self.pad_len(max(len(s.perf) for s in batch))
        score_len = self.pad_len(max(len(s.score) for s in batch))

        performances = _pad_stack([s.perf for s in batch], perf_len, self.pad_token_id)
        scores = _pad_stack([s.score for s in batch], score_len, self.pad_token_id)

        noisy = None
        if all(s.noisy_perf is not None for s in batch):
            noisy = _pad_stack([s.noisy_perf for s in batch], perf_len, self.pad_token_id)

        segments = None
        if batch[0].segments is not None:
            segments = SeqSegments(
                bar=_pad_stack([s.segments.bar for s in batch], score_len).tokens,
                beat=_pad_stack([s.segments.beat for s in batch], score_len).tokens,
                onset=_pad_stack([s.segments.onset for s in batch], score_len).tokens,
            )

        directions = None
        if batch[0].directions:
            groups = list(batch[0].directions.keys())
            directions = np.zeros((len(batch), score_len, len(groups)), dtype=np.int64)
            for i, sample in enumerate(batch):
                n = min(len(sample.score), score_len)
                for j, group in enumerate(groups):
                    for (label, _key), note_map in sample.directions[group].items():
                        hit = note_map[:n] != 0
                        directions[i, :n, j][hit] = label * note_map[:n][hit]

        deadpan_mask = np.array([s.is_deadpan for s in batch], dtype=bool)

        return ScorePerformanceInputs(
            scores=scores,
            performances=performances,
            noisy_performances=noisy,
            segments=segments,
            directions=directions,
            deadpan_mask=deadpan_mask,
        )


def mask_with_tokens(t: np.ndarray, token_ids, squeeze: bool = True) -> np.ndarray:
    """(performance.py:104-112)"""
    if t.ndim == 2 or not squeeze:
        mask = np.zeros_like(t, dtype=bool)
        for tok in token_ids:
            mask |= t == tok
    else:
        mask = np.zeros(t.shape[:2], dtype=bool)
        for tok in token_ids:
            mask |= np.any(t == tok, axis=-1)
    return mask


def mask_with_token_dims(t: np.ndarray, token_dims) -> np.ndarray:
    mask = np.zeros_like(t, dtype=bool)
    if token_dims:
        mask[..., list(token_dims)] = True
    return mask


def get_mask_subset_with_prob(mask: np.ndarray, prob: float, rng: np.random.RandomState):
    """Random subset of True positions with per-row count = ceil(prob * valid)
    (performance.py:126-140)."""
    batch, seq_len = mask.shape[:2]
    max_masked = math.ceil(prob * seq_len)

    num_tokens = mask.sum(axis=-1, keepdims=True)
    mask_excess = mask.cumsum(axis=-1) > np.ceil(num_tokens * prob)
    mask_excess = mask_excess[:, :max_masked]

    rand = rng.rand(batch, seq_len)
    rand[~mask] = -1e9
    sampled_indices = np.argsort(-rand, axis=-1)[:, :max_masked]
    sampled_indices = np.where(mask_excess, 0, sampled_indices + 1)

    new_mask = np.zeros((batch, seq_len + 1), dtype=bool)
    np.put_along_axis(new_mask, sampled_indices, True, axis=-1)
    return new_mask[:, 1:]


def mlm_mask_sequence(
    seq: np.ndarray,
    rng: np.random.RandomState,
    mask_prob: float,
    replace_prob: float,
    mask_token_id: int,
    mask_ignore_token_ids,
    mask_ignore_token_dims,
    label_pad_ignored_dims: bool = True,
    label_pad_token_id: int = LABEL_PAD,
):
    """MLM subset masking (performance.py:169-189)."""
    no_mask = mask_with_tokens(seq, mask_ignore_token_ids)
    mask = get_mask_subset_with_prob(~no_mask, mask_prob, rng)
    if seq.ndim == 3:
        mask = np.broadcast_to(mask[..., None], seq.shape)

    dim_mask = mask_with_token_dims(seq, mask_ignore_token_dims)
    replace = rng.rand(*seq.shape[:2]) < replace_prob
    if seq.ndim == 3:
        replace = replace[..., None]

    token_mask = mask & replace & (~dim_mask)
    masked_seq = np.where(token_mask, mask_token_id, seq)

    label_mask = mask
    if label_pad_ignored_dims:
        label_mask = label_mask & (~dim_mask)
    labels = np.where(label_mask, seq, label_pad_token_id)
    return masked_seq, labels, label_mask


class LMScorePerformanceCollator(ScorePerformanceCollator):
    """CLM/MLM labels (collators/score_performance.py:124-186)."""

    def __init__(
        self,
        pad_token_id: int = 0,
        pad_to_multiple_of: int = 1,
        fixed_seq_len: Optional[int] = None,
        mlm: bool = False,
        mask_prob: float = 0.15,
        replace_prob: float = 0.9,
        mask_token_id: int = 1,
        mask_ignore_token_ids: Optional[List[int]] = None,
        mask_ignore_token_dims: Optional[List[int]] = None,
        label_pad_ignored_dims: bool = True,
        label_pad_token_id: int = LABEL_PAD,
        seed: int = 23,
    ):
        super().__init__(pad_token_id, pad_to_multiple_of, fixed_seq_len)
        self.mlm = mlm
        self.mask_prob = mask_prob
        self.replace_prob = replace_prob
        self.mask_token_id = mask_token_id
        self.mask_ignore_token_ids = sorted({*(mask_ignore_token_ids or []), pad_token_id})
        self.mask_ignore_token_dims = mask_ignore_token_dims or []
        self.label_pad_ignored_dims = label_pad_ignored_dims
        self.label_pad_token_id = label_pad_token_id
        self._rng = np.random.RandomState(seed)

    def reseed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def mask_sequence(self, seq: np.ndarray):
        return mlm_mask_sequence(
            seq,
            self._rng,
            self.mask_prob,
            self.replace_prob,
            self.mask_token_id,
            self.mask_ignore_token_ids,
            self.mask_ignore_token_dims,
            self.label_pad_ignored_dims,
            self.label_pad_token_id,
        )

    def __call__(self, batch) -> ScorePerformanceInputs:
        data = super().__call__(batch)
        if self.mlm:
            masked_seq, labels, label_mask = self.mask_sequence(data.performances.tokens)
            data.performances = SeqInputs(
                tokens=masked_seq, mask=data.performances.mask, lengths=data.performances.lengths
            )
            mask_for_labels = data.performances.mask
        else:
            labels = np.where(
                data.performances.tokens == self.pad_token_id,
                self.label_pad_token_id,
                data.performances.tokens,
            )
            mask_for_labels = data.performances.mask
        data.labels = SeqInputs(
            tokens=labels, mask=mask_for_labels, lengths=data.performances.lengths
        )
        return data


class MixedLMScorePerformanceCollator(ScorePerformanceCollator):
    """MixedLM: every non-ignored dim of every position is masked into a
    parallel stream (collators/score_performance.py:189-234, performance.py:239-255)."""

    def __init__(
        self,
        pad_token_id: int = 0,
        pad_to_multiple_of: int = 1,
        fixed_seq_len: Optional[int] = None,
        mask_token_id: int = 1,
        mask_ignore_token_ids: Optional[List[int]] = None,
        mask_ignore_token_dims: Optional[List[int]] = None,
        label_pad_ignored_dims: bool = True,
        label_pad_token_id: int = LABEL_PAD,
        **kwargs,
    ):
        super().__init__(pad_token_id, pad_to_multiple_of, fixed_seq_len)
        self.mask_token_id = mask_token_id
        self.mask_ignore_token_ids = sorted({*(mask_ignore_token_ids or []), pad_token_id})
        self.mask_ignore_token_dims = mask_ignore_token_dims or []
        self.label_pad_ignored_dims = label_pad_ignored_dims
        self.label_pad_token_id = label_pad_token_id

    def mask_sequence(self, seq: np.ndarray):
        no_mask = mask_with_tokens(seq, self.mask_ignore_token_ids, squeeze=False)
        dim_mask = mask_with_token_dims(seq, self.mask_ignore_token_dims)

        token_mask = (~no_mask) & (~dim_mask)
        masked_seq = np.where(token_mask, self.mask_token_id, seq)

        label_mask = ~no_mask
        if self.label_pad_ignored_dims:
            label_mask = label_mask & (~dim_mask)
        labels = np.where(label_mask, seq, self.label_pad_token_id)
        return masked_seq, labels

    def __call__(self, batch) -> ScorePerformanceInputs:
        data = super().__call__(batch)
        masked, labels = self.mask_sequence(data.performances.tokens)
        data.masked_performances = SeqInputs(
            tokens=masked, mask=data.performances.mask.copy(), lengths=data.performances.lengths
        )
        data.labels = SeqInputs(
            tokens=labels, mask=data.performances.mask.copy(), lengths=data.performances.lengths
        )
        return data


def scoreperformer_model_inputs(data: ScorePerformanceInputs) -> Dict[str, np.ndarray]:
    """Map collated inputs to ScorePerformerModel kwargs
    (counterpart of model.prepare_inputs, model.py:343-372)."""
    inputs = {
        "perf": data.performances.tokens,
        "perf_mask": data.performances.mask,
        "score": data.scores.tokens,
        "score_mask": data.scores.mask,
    }
    if data.labels is not None:
        inputs["labels"] = data.labels.tokens
    if data.noisy_performances is not None:
        inputs["noisy_perf"] = data.noisy_performances.tokens
        inputs["noisy_perf_mask"] = data.noisy_performances.mask
    if data.masked_performances is not None:
        inputs["masked_perf"] = data.masked_performances.tokens
    if data.segments is not None:
        inputs["bars"] = data.segments.bar
        inputs["beats"] = data.segments.beat
        inputs["onsets"] = data.segments.onset
    if data.directions is not None:
        inputs["directions"] = data.directions
    if data.deadpan_mask is not None:
        inputs["deadpan_mask"] = data.deadpan_mask
    return inputs

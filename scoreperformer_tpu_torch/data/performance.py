# Verbatim copy of scoreperformer_tpu/data/performance.py; the port imports nothing of the JAX package.
"""Performance-only dataset and collators (for the standalone Performer LM).

Counterpart of scoreperformer/data/datasets/performance.py:39-260 and
data/collators/performance.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..utils import load_json
from .collators import LABEL_PAD, SeqInputs, _pad_stack, mask_with_token_dims, mask_with_tokens
from .datasets import compute_bar_sample_positions, get_end_bar, get_num_bars, prob2bool
from .helpers import (
    TokenSequenceAugmentations,
    TupleTokenSequenceIndexer,
    TupleTokenSequenceProcessor,
)
from .token_sequence import LocalTokenSequenceDataset


@dataclass
class PerformanceSampleMeta:
    idx: Optional[int]
    perf_idx: int
    start_bar: int
    end_bar: Optional[int]
    bar_offset: int = 0
    augmentations: Optional[TokenSequenceAugmentations] = None


@dataclass
class PerformanceSample:
    perf: np.ndarray
    meta: PerformanceSampleMeta


class PerformanceDataset:
    """(performance.py:39-260)"""

    def __init__(
        self,
        root: str,
        split: str = "train",
        max_seq_len: int = 512,
        max_bar: int = 256,
        bar_sliding_window: int = 16,
        fit_to_max_bar: bool = False,
        fit_to_zero_bar: bool = False,
        sample_bars: bool = False,
        add_sos_eos: bool = False,
        sample: bool = False,
        seed: int = 23,
        augment_performance: bool = False,
        pitch_shift_range: Tuple[int, int] = (-3, 3),
        velocity_shift_range: Tuple[int, int] = (-2, 2),
        tempo_shift_range: Tuple[int, int] = (-2, 2),
        cache: bool = True,
        **kwargs,
    ):
        from ..tokenizers import load_tokenizer

        self.root = root
        self.split = split

        metadata = load_json(os.path.join(root, "metadata.json"))
        if any(key in metadata for key in ["all", "train", "eval", "val", "test"]):
            metadata = metadata[split]
        self.metadata = metadata
        # performance-only datasets list perfs directly; score-perf layouts map
        # score -> [perfs]
        if isinstance(next(iter(metadata.values()), None), list):
            names = sorted({p for perfs in metadata.values() for p in perfs})
        else:
            names = list(metadata)
        self.performance_names = names

        self.tokenizer = load_tokenizer(os.path.join(root, "config.json"))
        self.encoding = type(self.tokenizer).__name__

        self.performances = LocalTokenSequenceDataset(
            root=root, files=self.performance_names, cache=cache
        )

        self.max_seq_len = max_seq_len
        self.max_bar = max_bar
        self.bar_sliding_window = bar_sliding_window
        self.add_sos_eos = add_sos_eos

        self.indexer = TupleTokenSequenceIndexer(self.tokenizer)
        self._bar_indices = [None] * len(self.performances)

        bars_file = os.path.join(root, "bars.json")
        if os.path.exists(bars_file):
            num_bars = load_json(bars_file)
            perf_num_bars = np.array([num_bars[p] for p in self.performance_names])
        else:
            perf_num_bars = np.array(
                [get_num_bars(self.performances[i], self.tokenizer) for i in range(len(names))]
            )

        self._length, self._sample_positions, self._sample_ids = compute_bar_sample_positions(
            perf_num_bars, bar_sliding_window
        )

        self.sample = sample
        self._rng = np.random.RandomState(seed)

        assert not (fit_to_max_bar and fit_to_zero_bar)
        self.fit_to_max_bar = fit_to_max_bar
        self.fit_to_zero_bar = fit_to_zero_bar
        self.sample_bars = sample and sample_bars
        self.augment_performance = sample and augment_performance
        if not self.augment_performance:
            pitch_shift_range = velocity_shift_range = tempo_shift_range = (0, 0)

        self.processor = TupleTokenSequenceProcessor(
            tokenizer=self.tokenizer,
            pitch_shift_range=pitch_shift_range,
            velocity_shift_range=velocity_shift_range,
            tempo_shift_range=tempo_shift_range,
        )

    def reseed(self, seed: int):
        self._rng = np.random.RandomState(seed)

    def _bar_note_lut(self, perf_idx: int) -> np.ndarray:
        """Cached bar → first-note-index table of one performance."""
        lut = self._bar_indices[perf_idx]
        if lut is None:
            lut = self._bar_indices[perf_idx] = self.indexer.compute_bar_indices(
                self.performances[perf_idx]
            )
        return lut

    def _plan_window(self, idx, meta, rng, lut):
        """Bar/note window decisions for one sample.

        Returns (start_bar, end_bar, note span). Same shape as
        `LocalScorePerformanceDataset._plan_window`: a strided grid position,
        optionally jittered ±half a window under ``sample_bars``, bar-greedy
        end selection, and a max_seq_len note clamp; meta replay reuses the
        recorded bar decisions (window semantics: reference
        performance.py:183-205).
        """
        n_bars = len(lut) - 1
        half, quarter = self.bar_sliding_window // 2, self.bar_sliding_window // 4

        if meta is not None:
            start_bar = meta.start_bar
        else:
            start_bar = int(self._sample_positions[idx])
            if self.sample_bars:
                lo = max(0, start_bar - half)
                hi = max(lo + 1, min(n_bars - quarter, start_bar + half))
                start_bar = int(rng.randint(lo, hi))

        if meta is not None and meta.end_bar is not None:
            end_bar = meta.end_bar
        else:
            end_bar = get_end_bar(lut, start_bar, self.max_seq_len, self.max_bar)

        n0, n1 = int(lut[start_bar]), int(lut[end_bar + 1])
        if n0 == n1 or n1 - n0 > self.max_seq_len:
            n1 = min(n1, n0 + self.max_seq_len)
        return start_bar, end_bar, (n0, n1)

    def _choose_bar_offset(self, meta, rng, end_bar, n_bars, bar_lo, bar_hi) -> int:
        """Re-basing offset for the Bar stream: fit_to_zero_bar pins the
        window's first bar to 0; fit_to_max_bar proportionally re-maps
        windows that start past max_bar (performance.py:214-226)."""
        if meta is not None:
            return meta.bar_offset
        if self.fit_to_max_bar and end_bar >= self.max_bar:
            return int((self.max_bar - 1) * bar_hi / n_bars) - bar_hi
        if self.fit_to_zero_bar:
            return -int(bar_lo)
        return 0

    def _choose_augmentations(self, meta, rng):
        if meta is not None:
            return meta.augmentations
        if self.augment_performance and prob2bool(rng, self.augment_performance):
            return self.processor.sample_augmentations(rng)
        return None

    def get(self, idx=None, meta=None, rng=None) -> PerformanceSample:
        assert idx is not None or meta is not None
        rng = rng if rng is not None else self._rng

        if meta is not None:
            idx, perf_idx = meta.idx, meta.perf_idx
        else:
            perf_idx = int(np.searchsorted(self._sample_ids, idx, side="right")) - 1

        lut = self._bar_note_lut(perf_idx)
        total_notes = self.performances[perf_idx].shape[0]

        start_bar, end_bar, (n0, n1) = self._plan_window(idx, meta, rng, lut)
        seq = self.performances[perf_idx][n0:n1].copy()

        z = self.tokenizer.zero_token
        bar_offset = self._choose_bar_offset(
            meta, rng, end_bar,
            n_bars=len(lut) - 1,
            bar_lo=seq[:, 0].min() - z,
            bar_hi=seq[:, 0].max() - z,
        )
        if bar_offset != 0:
            seq[:, 0] += bar_offset

        augmentations = self._choose_augmentations(meta, rng)
        if augmentations is not None:
            seq = self.processor.augment_sequence(seq, augmentations)
            seq = seq[self.processor.compute_valid_pitch_mask(seq)]

        if self.add_sos_eos:
            if n0 == 0:
                seq = self.processor.add_sos_token(seq)
            if n1 == total_notes:
                seq = self.processor.add_eos_token(seq)

        meta = PerformanceSampleMeta(
            idx=idx, perf_idx=perf_idx, start_bar=start_bar, end_bar=end_bar,
            bar_offset=bar_offset, augmentations=augmentations,
        )
        return PerformanceSample(perf=seq, meta=meta)

    def __getitem__(self, idx):
        return self.get(idx=idx)

    def __len__(self):
        return self._length


# ---- collators (collators/performance.py) ----


@dataclass
class PerformanceInputs:
    performances: SeqInputs
    labels: Optional[SeqInputs] = None
    masked_performances: Optional[SeqInputs] = None


class PerformanceCollator:
    def __init__(self, pad_token_id=0, pad_to_multiple_of=1, fixed_seq_len=None):
        self.pad_token_id = pad_token_id
        self.pad_to_multiple_of = pad_to_multiple_of
        self.fixed_seq_len = fixed_seq_len

    def pad_len(self, length):
        if self.fixed_seq_len is not None:
            return self.fixed_seq_len
        if self.pad_to_multiple_of > 1:
            import math

            return int(math.ceil(length / self.pad_to_multiple_of) * self.pad_to_multiple_of)
        return length

    def __call__(self, batch: List[PerformanceSample]) -> PerformanceInputs:
        max_len = self.pad_len(max(len(s.perf) for s in batch))
        return PerformanceInputs(
            performances=_pad_stack([s.perf for s in batch], max_len, self.pad_token_id)
        )


class LMPerformanceCollator(PerformanceCollator):
    """CLM labels / MLM masking (performance.py:144-236)."""

    def __init__(
        self,
        pad_token_id=0,
        pad_to_multiple_of=1,
        fixed_seq_len=None,
        mlm=False,
        mask_prob=0.15,
        replace_prob=0.9,
        mask_token_id=1,
        mask_ignore_token_ids=None,
        mask_ignore_token_dims=None,
        label_pad_ignored_dims=True,
        label_pad_token_id=LABEL_PAD,
        seed=23,
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

    def reseed(self, seed):
        self._rng = np.random.RandomState(seed)

    def __call__(self, batch) -> PerformanceInputs:
        from .collators import mlm_mask_sequence

        data = super().__call__(batch)
        if self.mlm:
            masked_seq, labels, _ = mlm_mask_sequence(
                data.performances.tokens,
                self._rng,
                self.mask_prob,
                self.replace_prob,
                self.mask_token_id,
                self.mask_ignore_token_ids,
                self.mask_ignore_token_dims,
                self.label_pad_ignored_dims,
                self.label_pad_token_id,
            )
            data.performances = SeqInputs(
                tokens=masked_seq, mask=data.performances.mask, lengths=data.performances.lengths
            )
        else:
            labels = np.where(
                data.performances.tokens == self.pad_token_id,
                self.label_pad_token_id,
                data.performances.tokens,
            )
        data.labels = SeqInputs(
            tokens=labels, mask=data.performances.mask, lengths=data.performances.lengths
        )
        return data


class MixedLMPerformanceCollator(PerformanceCollator):
    """(performance.py:239-277)"""

    def __init__(
        self,
        pad_token_id=0,
        pad_to_multiple_of=1,
        fixed_seq_len=None,
        mask_token_id=1,
        mask_ignore_token_ids=None,
        mask_ignore_token_dims=None,
        label_pad_ignored_dims=True,
        label_pad_token_id=LABEL_PAD,
        **kwargs,
    ):
        super().__init__(pad_token_id, pad_to_multiple_of, fixed_seq_len)
        self.mask_token_id = mask_token_id
        self.mask_ignore_token_ids = sorted({*(mask_ignore_token_ids or []), pad_token_id})
        self.mask_ignore_token_dims = mask_ignore_token_dims or []
        self.label_pad_ignored_dims = label_pad_ignored_dims
        self.label_pad_token_id = label_pad_token_id

    def __call__(self, batch) -> PerformanceInputs:
        data = super().__call__(batch)
        seq = data.performances.tokens
        no_mask = mask_with_tokens(seq, self.mask_ignore_token_ids, squeeze=False)
        dim_mask = mask_with_token_dims(seq, self.mask_ignore_token_dims)
        token_mask = (~no_mask) & (~dim_mask)
        masked_seq = np.where(token_mask, self.mask_token_id, seq)
        label_mask = ~no_mask
        if self.label_pad_ignored_dims:
            label_mask = label_mask & (~dim_mask)
        labels = np.where(label_mask, seq, self.label_pad_token_id)
        data.masked_performances = SeqInputs(
            tokens=masked_seq, mask=data.performances.mask.copy(), lengths=data.performances.lengths
        )
        data.labels = SeqInputs(
            tokens=labels, mask=data.performances.mask.copy(), lengths=data.performances.lengths
        )
        return data


def performer_model_inputs(data: PerformanceInputs) -> Dict[str, np.ndarray]:
    """(model.py:124-137)"""
    inputs = {"perf": data.performances.tokens, "mask": data.performances.mask}
    if data.labels is not None:
        inputs["labels"] = data.labels.tokens
    if data.masked_performances is not None:
        inputs["masked_perf"] = data.masked_performances.tokens
    return inputs

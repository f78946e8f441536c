# Verbatim copy of scoreperformer_tpu/data/datasets.py; the port imports nothing of the JAX package.
"""Score-performance training datasets.

Counterpart of scoreperformer/data/datasets/{score_performance.py, utils.py}:
bar-window sampling with start-bar/note-shift jitter, pitch/velocity/tempo
augmentation, noisy-performance and deadpan substitution, per-note direction
labels, and reproducible resampling via sample metadata.

Randomness is carried in an explicit np.random.RandomState (no global seeds),
so distributed data loading stays deterministic per (seed, epoch, index).
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..tokenizers import TOKENIZERS, TokSequence, load_tokenizer
from ..utils import dump_json, load_json
from .helpers import (
    TokenSequenceAugmentations,
    TupleTokenSequenceIndexer,
    TupleTokenSequenceProcessor,
)
from .token_sequence import LocalTokenSequenceDataset, TokenSequenceDataset, load_tokens_np


# ---- sampling utils (datasets/utils.py) ----


def get_num_bars(seq: np.ndarray, tokenizer) -> int:
    bar_idx = tokenizer.types_idx["Bar"]
    return int(seq[-1, bar_idx] - tokenizer.zero_token + 1)


def compute_bar_sample_positions(seq_num_bars, bar_sliding_window: int):
    """Forward+backward strided bar windows (utils.py:38-53)."""
    bar_shift = bar_sliding_window
    length, sample_positions = 0, []
    for num_bars in seq_num_bars:
        back_shift = -bar_shift // 4 if (num_bars - bar_shift // 2) % bar_shift == 0 else 0
        positions = np.concatenate(
            [
                np.arange(0, num_bars - bar_shift // 2, bar_shift),
                np.arange(num_bars - bar_shift // 2 - back_shift, -1 + bar_shift // 2, -bar_shift),
            ]
        )
        length += len(positions)
        sample_positions.append(positions)

    sample_ids = np.concatenate([[0], np.cumsum(list(map(len, sample_positions)))[:-1]])
    sample_positions = np.concatenate(sample_positions)
    return length, sample_positions, sample_ids


def get_end_bar(score_indices, start_bar=0, max_seq_len=512, max_bar=256) -> int:
    end_bar = np.where(score_indices <= score_indices[start_bar] + max_seq_len)[0][-1] - 1
    return int(min(max(start_bar, end_bar), start_bar + max_bar - 1))


def prob2bool(rng: np.random.RandomState, prob) -> bool:
    if isinstance(prob, bool):
        return prob
    return bool(rng.random_sample() < float(prob))


def split_composer_metadata(reference_metadata, splits, seed=None):
    """Composer-aware train/eval splitting keeping all performances of a score
    in one split (datasets/utils.py:61-109)."""
    rng = np.random.RandomState(seed)
    data = {split: dict() for split in splits}

    for comp, score_perf in reference_metadata.items():
        comp_meta_rep = []
        items = list(score_perf.items())
        rng.shuffle(items)
        score_perf = dict(items)

        for score, perfs in score_perf.items():
            comp_meta_rep.extend([score] * len(perfs))

        if len(comp_meta_rep) > 10:
            start = 0
            for i, (split, ratio) in enumerate(splits.items()):
                end = min(len(comp_meta_rep), start + round(ratio * len(comp_meta_rep)))
                if i == len(splits) - 1:
                    end = len(comp_meta_rep)
                if end < len(comp_meta_rep) and comp_meta_rep[end - 1] == comp_meta_rep[-1]:
                    while end > 0 and comp_meta_rep[end] == comp_meta_rep[end - 1]:
                        end -= 1
                else:
                    while end < len(comp_meta_rep) and comp_meta_rep[end - 1] == comp_meta_rep[end]:
                        end += 1
                for score in np.unique(comp_meta_rep[start:end]).tolist():
                    data[split][score] = score_perf[score]
                start = end
        else:
            keys = np.array(list(splits.keys()))
            probs = np.array(list(splits.values()), dtype=float)
            probs = probs / probs.sum()
            for score, perfs in score_perf.items():
                data[str(rng.choice(keys, p=probs))][score] = perfs

    return {split: dict(sorted(d.items())) for split, d in data.items()}


# ---- sample containers (score_performance.py:31-66) ----


@dataclass
class NoteSegments:
    bar: np.ndarray
    beat: np.ndarray
    onset: np.ndarray


@dataclass
class ScorePerformanceSampleMeta:
    idx: Optional[int]
    score_idx: int
    perf_idx: int
    start_bar: int
    end_bar: Optional[int]
    start_idx: Optional[int] = None
    end_idx: Optional[int] = None
    bar_offset: int = 0
    note_shifts: Tuple[int, int] = (0, 0)
    augmentations: Optional[TokenSequenceAugmentations] = None
    noisy_augmentations: Optional[TokenSequenceAugmentations] = None
    is_deadpan: bool = False


@dataclass
class ScorePerformanceSample:
    score: np.ndarray
    perf: np.ndarray
    meta: ScorePerformanceSampleMeta
    noisy_perf: Optional[np.ndarray] = None
    segments: Optional[NoteSegments] = None
    directions: Optional[Dict[str, Dict[Tuple[int, str], np.ndarray]]] = None
    is_deadpan: bool = False


class ScorePerformanceDataset:
    """(score_performance.py:69-527)"""

    def __init__(
        self,
        scores: TokenSequenceDataset,
        performances: TokenSequenceDataset,
        metadata: Dict[str, List[str]],
        tokenizer,
        alignments: Optional[Dict[str, np.ndarray]] = None,
        auxiliary_data: Optional[Dict[str, object]] = None,
        performance_directions: Optional[Union[str, Path, List[str], Dict[str, List[str]]]] = None,
        score_directions_dict: Optional[Union[str, Path, Dict]] = None,
        max_seq_len: int = 512,
        max_bar: int = 256,
        bar_sliding_window: int = 16,
        sample_bars: Union[bool, float] = False,
        sample_note_shift: Union[bool, float] = False,
        force_max_seq_len: Union[bool, float] = False,
        fit_to_max_bar: bool = False,
        fit_to_zero_bar: bool = False,
        sample_bar_offset: Union[bool, float] = False,
        add_sos_eos: bool = False,
        sample: bool = False,
        seed: int = 23,
        augment_performance: Union[bool, float] = False,
        pitch_shift_range: Tuple[int, int] = (-3, 3),
        velocity_shift_range: Tuple[int, int] = (-2, 2),
        tempo_shift_range: Tuple[int, int] = (-2, 2),
        noisy_performance: bool = False,
        noise_strength: float = 0.5,
        noisy_random_bars: Union[bool, float] = 0.5,
        deadpan_performance: Union[bool, float] = False,
        **kwargs,
    ):
        self.metadata = metadata
        self.performance_names = list(sorted(set(chain.from_iterable(metadata.values()))))
        self.score_names = list(sorted(metadata.keys()))
        self._performance_map = {
            perf: (score, idx)
            for score, perfs in metadata.items()
            for idx, perf in enumerate(perfs)
        }

        self.scores = scores
        self.performances = performances
        self.alignments = alignments

        if isinstance(tokenizer, dict):
            from ..tokenizers import TokenizerConfig

            tokenizer = TOKENIZERS[tokenizer["tokenization"]](
                TokenizerConfig.from_dict(tokenizer["config"])
            )
        self.tokenizer = tokenizer
        self.encoding = type(self.tokenizer).__name__
        assert max_bar <= self.tokenizer.config.additional_params["max_bar_embedding"]
        assert not (fit_to_max_bar and fit_to_zero_bar)

        # window-shape knobs
        self.max_seq_len = max_seq_len
        self.max_bar = max_bar
        self.bar_sliding_window = bar_sliding_window
        self.add_sos_eos = add_sos_eos
        self.fit_to_max_bar = fit_to_max_bar
        self.fit_to_zero_bar = fit_to_zero_bar

        # stochastic-sampling knobs (all drawn from the explicit RandomState)
        self.sample = sample
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self.sample_bars = sample_bars
        self.sample_note_shift = sample_note_shift
        self.sample_bar_offset = sample_bar_offset
        self.force_max_seq_len = force_max_seq_len

        # augmentation knobs; shift ranges collapse to (0, 0) when neither
        # augmented nor noisy performances can ever request a shift
        self.augment_performance = augment_performance
        self.noisy_performance = noisy_performance
        self.noise_strength = noise_strength
        self.noisy_random_bars = noisy_random_bars
        self.deadpan_performance = deadpan_performance
        augmentable = self.noisy_performance or self.augment_performance != 0.0
        self.processor = TupleTokenSequenceProcessor(
            tokenizer=self.tokenizer,
            pitch_shift_range=pitch_shift_range if augmentable else (0, 0),
            velocity_shift_range=velocity_shift_range if augmentable else (0, 0),
            tempo_shift_range=tempo_shift_range if augmentable else (0, 0),
        )
        self.indexer = TupleTokenSequenceIndexer(self.tokenizer)

        # auxiliary payloads (e.g. precomputed `bars`) attach as attributes
        for key, data in (auxiliary_data or {}).items():
            setattr(self, key, data)

        # lazy per-sequence bar-index caches
        self._score_indices = [None] * len(self.scores)
        self._perf_indices = [None] * len(self.performances)

        # bar counts per performance (reusing any preloaded entries), then
        # the flattened strided-window table over them
        self.bars = getattr(self, "bars", {})
        self.bars.update(
            {
                perf: get_num_bars(self.performances[i], self.tokenizer)
                for i, perf in enumerate(self.performance_names)
                if perf not in self.bars
            }
        )
        self._length, self._sample_positions, self._sample_ids = compute_bar_sample_positions(
            seq_num_bars=np.array([self.bars[p] for p in self.performance_names]),
            bar_sliding_window=self.bar_sliding_window,
        )

        self._precompute_note_segment_maps()
        self._init_direction_labels(performance_directions, score_directions_dict)

    def _precompute_note_segment_maps(self) -> None:
        """Per-score beat/onset segment ids for every note.

        Counterpart of the beat-note maps in score_performance.py:186-191,
        computed as bucketing problems: beat ids bin note onsets into the
        beat-tick grid, onset ids are the rank of each note's onset among
        the distinct onsets (``np.unique`` inverse).
        """
        self._beat_maps, self._onset_maps = [], []
        for seq in self.scores:
            ticks = self.tokenizer.compute_ticks(seq, compute_beat_ticks=True)
            onsets = ticks["note_on"]
            self._beat_maps.append(np.digitize(onsets, ticks["beat"]) - 1)
            self._onset_maps.append(np.unique(onsets, return_inverse=True)[1])

    def _init_direction_labels(self, performance_directions, score_directions_dict) -> None:
        """Resolve direction-label config (score_performance.py:216-247).

        Accepts a path / flat list / {group: [names]} dict; a flat list
        becomes a single "directions" group. Each group's class count is
        len(names) + 1 for the implicit 'none' class 0.
        """
        if isinstance(performance_directions, (str, Path)):
            performance_directions = load_json(performance_directions)
        if isinstance(performance_directions, list):
            performance_directions = {"directions": list(performance_directions)}
        self.performance_directions = performance_directions
        self.performance_direction_sizes = None
        self.score_direction_maps = None
        if performance_directions is None:
            return

        assert score_directions_dict is not None
        self.performance_direction_sizes = {
            group: len(names) + 1 for group, names in performance_directions.items()
        }
        if isinstance(score_directions_dict, (str, Path)):
            score_directions_dict = load_json(score_directions_dict)

        from .directions import build_score_direction_maps

        all_names = [n for names in performance_directions.values() for n in names]
        self.score_direction_maps = build_score_direction_maps(
            self, score_directions_dict, direction_keys=all_names
        )["score"]["note"]

    def reseed(self, seed: int) -> None:
        """Reseed the sampling RNG (per-epoch reproducibility hook)."""
        self._rng = np.random.RandomState(seed)

    def get_direction_class_weights(self):
        """Per-group direction class frequencies (score_performance.py:250-279).

        Returns ``(fractions, weights)``: ``fractions[group]`` maps
        ``(class_id, name)`` to the fraction of (note, performance) pairs
        labelled with that class — class 0 ('none') absorbs the remainder —
        and ``weights[group]`` is the same list in class-id order.
        Computed as one vectorized counts matrix (scores x directions)
        contracted against per-score performance multiplicities.
        """
        n_perfs = np.array(
            [len(self.metadata[s]) for s in self.score_names], dtype=np.float64
        )
        n_notes = np.array([len(s) for s in self.scores], dtype=np.float64)
        total = float(n_notes @ n_perfs)

        fractions, weights = {}, {}
        for group, names in self.performance_directions.items():
            # counts[i, j] = labelled notes for direction j in score i
            counts = np.array(
                [
                    [float(maps[name].sum()) if name in maps else 0.0 for name in names]
                    for maps in self.score_direction_maps
                ],
                dtype=np.float64,
            ).reshape(len(self.score_direction_maps), len(names))
            per_direction = n_perfs @ counts
            table = {(0, "none"): (total - float(per_direction.sum())) / total}
            for j, name in enumerate(names):
                table[(j + 1, name)] = float(per_direction[j]) / total
            fractions[group] = table
            weights[group] = list(table.values())

        return fractions, weights

    # ---- sampling internals ----

    def _get_augmentations(self, meta, is_noisy_perf=False, rng=None):
        rng = rng if rng is not None else self._rng
        if meta is None:
            if self.sample and prob2bool(rng, self.augment_performance) and not is_noisy_perf:
                return self.processor.sample_augmentations(rng)
            elif self.sample and self.noisy_performance and is_noisy_perf:
                return self.processor.sample_augmentations(rng, multiplier=self.noise_strength)
            return None
        elif is_noisy_perf:
            return meta.noisy_augmentations
        return meta.augmentations

    def _augment_sequence(self, seq, augmentations, is_perf=True):
        if augmentations is None:
            return seq, np.ones_like(seq[:, 0], dtype=bool)
        if not is_perf:
            augmentations = copy.deepcopy(augmentations)
            augmentations.velocity_shift = 0
            augmentations.tempo_shift = 0
        seq = self.processor.augment_sequence(seq, augmentations)
        mask = self.processor.compute_valid_pitch_mask(seq)
        return seq[mask], mask

    # -- window planning ---------------------------------------------------

    def _bar_note_lut(self, kind: str, seq_idx: int) -> np.ndarray:
        """Lazily-built bar -> first-note-index table for a score or perf."""
        cache = self._score_indices if kind == "score" else self._perf_indices
        seqs = self.scores if kind == "score" else self.performances
        if cache[seq_idx] is None:
            cache[seq_idx] = self.indexer.compute_bar_indices(seqs[seq_idx])
        return cache[seq_idx]

    def _plan_window(self, idx, meta, rng, score_idx, perf_idx):
        """All bar/note window decisions for one sample.

        Returns (start_bar, end_bar, note_shifts, score_span, perf_span).
        Window semantics match reference score_performance.py:338-388 (the
        jitter bounds ARE the sampling spec); the control flow here is our
        own, and meta replay reuses recorded decisions verbatim.
        """
        score_lut = self._bar_note_lut("score", score_idx)
        perf_lut = self._bar_note_lut("perf", perf_idx)
        n_score_bars, n_perf_bars = len(score_lut) - 1, len(perf_lut) - 1
        n_notes = self.scores[score_idx].shape[0]
        half, quarter = self.bar_sliding_window // 2, self.bar_sliding_window // 4

        # start bar: strided grid position, optionally jittered +-half a
        # window inside the bars both sequences actually have
        if meta is not None:
            start_bar = meta.start_bar
        else:
            start_bar = min(int(self._sample_positions[idx]), n_perf_bars + 1 - half)
            if self.sample and prob2bool(rng, self.sample_bars):
                lo = max(0, start_bar - half)
                hi = min(min(n_score_bars, n_perf_bars) - quarter, start_bar + half)
                start_bar = int(rng.randint(lo, max(lo + 1, hi)))

        if meta is not None and meta.end_bar is not None:
            end_bar = meta.end_bar
        else:
            end_bar = get_end_bar(score_lut, start_bar, self.max_seq_len, self.max_bar)

        s0, s1 = int(score_lut[start_bar]), int(score_lut[end_bar + 1])
        p0, p1 = int(perf_lut[start_bar]), int(perf_lut[min(end_bar + 1, n_perf_bars)])
        if s1 == s0 or s1 - s0 > self.max_seq_len:
            s1 = min(s1, s0 + self.max_seq_len)
            p1 = min(p1, p0 + self.max_seq_len)

        # note-level shifts: a random +-max_seq_len/4 slide of both window
        # edges, then optional greedy extension to fill max_seq_len
        if meta is not None:
            shift_a, shift_b = meta.note_shifts
        else:
            shift_a = shift_b = 0
            if self.sample and prob2bool(rng, self.sample_note_shift):
                q = self.max_seq_len // 4
                lo, hi = max(-s0, -q), min(n_notes - s0 - q, q)
                if hi > lo:
                    shift_a = shift_b = int(rng.randint(lo, hi))
                shift_b = min(shift_b, n_notes - s1)
            if prob2bool(rng, self.force_max_seq_len):
                shift_b += min(self.max_seq_len - (s1 - s0), n_notes - s1 - shift_b)

        return (
            start_bar,
            end_bar,
            (shift_a, shift_b),
            (s0 + shift_a, s1 + shift_b),
            (p0 + shift_a, p1 + shift_b),
        )

    def _cut_sequences(self, score_idx, perf_idx, perf_name, score_span, perf_span):
        """Materialize the score/perf windows; perf goes through the per-note
        alignment map when one exists (score_performance.py:393-398)."""
        s0, s1 = score_span
        score_seq = self.scores[score_idx][s0:s1].copy()
        alignment = (self.alignments or {}).get(perf_name)
        if alignment is not None:
            perf_seq = self.performances[perf_idx][alignment[s0:s1]].copy()
        else:
            p0, p1 = perf_span
            perf_seq = self.performances[perf_idx][p0:p1].copy()
        return score_seq, perf_seq

    def _window_segments(self, score_idx, score_seq, score_span):
        """Bar/beat/onset segment ids of the window, re-based to zero_token."""
        s0, s1 = score_span
        z = self.tokenizer.zero_token
        segs = (
            score_seq[:, 0] - z,
            self._beat_maps[score_idx][s0:s1],
            self._onset_maps[score_idx][s0:s1],
        )
        return [s + (z - s[0]) for s in segs]

    def _choose_bar_offset(self, meta, rng, end_bar, n_score_bars, bar_lo, bar_hi):
        """Re-basing offset for the Bar stream (score_performance.py:416-433):
        fit_to_zero_bar pins the window's first bar to 0; fit_to_max_bar keeps
        ids inside the Bar vocab, either by sampling a placement or by
        proportionally re-mapping windows that start past max_bar."""
        if meta is not None:
            return meta.bar_offset
        if self.fit_to_zero_bar:
            return -int(bar_lo)
        if self.fit_to_max_bar:
            if self.sample and self.sample_bar_offset:
                return int(rng.randint(-bar_lo, self.max_bar - bar_hi))
            if end_bar >= self.max_bar:
                return int((self.max_bar - 1) * bar_hi / n_score_bars) - bar_hi
        return 0

    def _make_noisy_perf(self, perf_seq, meta, rng):
        """Noise-augmented copy of the performance, optionally with shuffled
        bar ids (score_performance.py:446-458)."""
        noisy_aug = self._get_augmentations(meta, is_noisy_perf=True, rng=rng)
        noisy, _ = self._augment_sequence(perf_seq.copy(), noisy_aug)
        if noisy.shape[0] < perf_seq.shape[0]:
            noisy = perf_seq.copy()  # pitch clipping dropped notes: keep clean
        if prob2bool(rng, self.noisy_random_bars):
            z = self.tokenizer.zero_token
            perm = rng.permutation(self.max_bar)
            noisy[:, 0] = perm[np.clip(noisy[:, 0] - z, 0, self.max_bar - 1)] + z
        return noisy, noisy_aug

    def _collect_directions(self, score_idx, score_span, mask, pad_sos, pad_eos, n_notes):
        """Per-note binary direction maps cut to the window
        (score_performance.py:484-497)."""
        s0, s1 = score_span
        maps = self.score_direction_maps[score_idx]
        out = {}
        for group_name, group_directions in self.performance_directions.items():
            group = {}
            for i, key in enumerate(group_directions):
                if key in maps:
                    m = maps[key][s0:s1][mask]
                    pads = ([0] if pad_sos else []), ([0] if pad_eos else [])
                    m = np.concatenate([pads[0], m, pads[1]]) if (pad_sos or pad_eos) else m
                else:
                    m = np.zeros(n_notes)
                group[(i + 1, key)] = m.astype(int)
            out[group_name] = group
        return out

    def get(self, idx=None, meta=None, rng=None) -> ScorePerformanceSample:
        """Assemble one training sample (reference score_performance.py:312-527
        for the sampling SEMANTICS; the pipeline below — plan window -> cut ->
        re-base -> augment -> variants -> boundaries — is this repo's own).
        Pass an explicit `rng` for thread-safe parallel sampling; RNG draws
        happen in a fixed order so (seed, idx) fully determines the sample."""
        assert idx is not None or meta is not None
        rng = rng if rng is not None else self._rng

        # resolve the (performance, score) pair behind this flat index
        if meta is not None:
            idx, perf_idx = meta.idx, meta.perf_idx
        else:
            perf_idx = int(np.searchsorted(self._sample_ids, idx, side="right")) - 1
        perf_name = self.performance_names[perf_idx]
        score_idx = self.scores._name_to_idx[self._performance_map[perf_name][0]]

        start_bar, end_bar, note_shifts, score_span, perf_span = self._plan_window(
            idx, meta, rng, score_idx, perf_idx
        )
        score_seq, perf_seq = self._cut_sequences(
            score_idx, perf_idx, perf_name, score_span, perf_span
        )
        segments = self._window_segments(score_idx, score_seq, score_span)

        # re-base the Bar stream
        z = self.tokenizer.zero_token
        bar_ids = np.concatenate([score_seq[:, 0], perf_seq[:, 0]]) - z
        bar_offset = self._choose_bar_offset(
            meta, rng, end_bar,
            n_score_bars=len(self._bar_note_lut("score", score_idx)) - 1,
            bar_lo=int(bar_ids.min()), bar_hi=int(bar_ids.max()),
        )
        if bar_offset:
            bar_col = self.tokenizer.types_idx["Bar"]
            score_seq[:, bar_col] += bar_offset
            perf_seq[:, bar_col] += bar_offset

        # shared pitch/velocity/tempo augmentation (velocity/tempo are
        # perf-only inside _augment_sequence)
        augmentations = self._get_augmentations(meta, rng=rng)
        score_seq, mask = self._augment_sequence(score_seq, augmentations, is_perf=False)
        perf_seq, _ = self._augment_sequence(perf_seq, augmentations, is_perf=True)
        segments = [s[mask] for s in segments]

        noisy_perf_seq = noisy_augmentations = None
        if self.noisy_performance:
            noisy_perf_seq, noisy_augmentations = self._make_noisy_perf(perf_seq, meta, rng)

        use_deadpan = (
            meta.is_deadpan if meta is not None
            else self.sample and prob2bool(rng, self.deadpan_performance)
        )
        if use_deadpan:
            perf_seq = np.array(
                self.tokenizer.score_tokens_as_performance(TokSequence(ids=score_seq)).ids
            )

        # SOS/EOS only at true piece boundaries (score_performance.py:467-481)
        n_notes_total = self.scores[score_idx].shape[0]
        pad_sos = self.add_sos_eos and score_span[0] == 0
        pad_eos = self.add_sos_eos and score_span[1] == n_notes_total
        if pad_sos:
            score_seq = self.processor.add_sos_token(score_seq)
            perf_seq = self.processor.add_sos_token(perf_seq)
            if noisy_perf_seq is not None:
                noisy_perf_seq = self.processor.add_sos_token(noisy_perf_seq)
            segments = [np.concatenate([s[:1], s]) for s in segments]
        if pad_eos:
            score_seq = self.processor.add_eos_token(score_seq)
            perf_seq = self.processor.add_eos_token(perf_seq)
            if noisy_perf_seq is not None:
                noisy_perf_seq = self.processor.add_eos_token(noisy_perf_seq)
            segments = [np.concatenate([s, s[-1:]]) for s in segments]

        directions = {}
        if self.performance_directions is not None:
            directions = self._collect_directions(
                score_idx, score_span, mask, pad_sos, pad_eos, score_seq.shape[0]
            )

        meta = ScorePerformanceSampleMeta(
            idx=idx,
            score_idx=score_idx,
            perf_idx=perf_idx,
            start_bar=start_bar,
            end_bar=end_bar,
            start_idx=score_span[0],
            end_idx=score_span[1],
            bar_offset=bar_offset,
            note_shifts=note_shifts,
            augmentations=augmentations,
            noisy_augmentations=noisy_augmentations,
            is_deadpan=use_deadpan,
        )

        return ScorePerformanceSample(
            score=score_seq,
            perf=perf_seq,
            meta=meta,
            noisy_perf=noisy_perf_seq,
            segments=NoteSegments(*segments),
            directions=directions,
            is_deadpan=use_deadpan,
        )

    def __getitem__(self, idx: int) -> ScorePerformanceSample:
        return self.get(idx=idx)

    def __len__(self) -> int:
        return self._length


class LocalScorePerformanceDataset(ScorePerformanceDataset):
    """Disk-backed dataset: metadata.json + tokenizer config.json + per-piece
    token files (score_performance.py:530-697)."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        use_alignments: bool = False,
        auxiliary_data_keys: Optional[List[str]] = None,
        save_auxiliary_data: bool = True,
        zero_out_silent_durations: bool = True,
        delete_silent_notes: bool = False,
        preload: bool = False,
        cache: bool = True,
        **kwargs,
    ):
        self.root = root
        self.split = split

        metadata = load_json(os.path.join(root, "metadata.json"))
        if any(key in metadata for key in ["all", "train", "eval", "val", "test"]):
            metadata = metadata[split]

        performance_names = list(sorted(set(chain.from_iterable(metadata.values()))))
        score_names = list(sorted(metadata.keys()))
        performance_map = {
            perf: (score, idx)
            for score, perfs in metadata.items()
            for idx, perf in enumerate(perfs)
        }

        alignments = None
        if use_alignments:
            alignment_file = os.path.join(root, "alignments.json")
            if os.path.exists(alignment_file):
                alignments = {
                    key: np.array(values)
                    for key, values in load_json(alignment_file).items()
                    if key in performance_map
                }

        tokenizer = load_tokenizer(os.path.join(root, "config.json"))
        processor = TupleTokenSequenceProcessor(tokenizer=tokenizer)

        seq_proc, perf_proc = [], []
        if zero_out_silent_durations:
            seq_proc.append(processor.zero_out_durations)
        if delete_silent_notes:
            perf_proc.append(processor.remove_silent_notes)

        def make_load_fn(funcs):
            def load(path):
                seq = load_tokens_np(path)
                for fn in funcs:
                    seq = fn(seq)
                return seq

            return load

        scores = LocalTokenSequenceDataset(
            root=root, files=score_names, load_fn=make_load_fn(seq_proc), preload=preload, cache=cache
        )
        performances = LocalTokenSequenceDataset(
            root=root,
            files=performance_names,
            load_fn=make_load_fn(seq_proc + perf_proc),
            preload=preload,
            cache=cache,
        )

        auxiliary_data = {}
        for key in auxiliary_data_keys or []:
            data_file = os.path.join(root, f"{key}.json")
            if os.path.exists(data_file):
                auxiliary_data[key] = load_json(data_file)

        super().__init__(
            scores=scores,
            performances=performances,
            metadata=metadata,
            tokenizer=tokenizer,
            alignments=alignments,
            auxiliary_data=auxiliary_data,
            **kwargs,
        )

        if save_auxiliary_data:
            for key in auxiliary_data_keys or []:
                data_file = os.path.join(root, f"{key}.json")
                data = getattr(self, key, None)
                if data is not None and (
                    not os.path.exists(data_file) or len(data) != len(load_json(data_file))
                ):
                    dump_json(data, data_file)

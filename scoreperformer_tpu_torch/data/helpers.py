# Verbatim copy of scoreperformer_tpu/data/helpers.py; the port imports nothing of the JAX package.
"""Token-sequence helpers: augmentation, indexing, boundary tokens.

Counterpart of scoreperformer/data/helpers/{processors.py, indexers.py}.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..tokenizers import EOS, SOS


def sample_integer_shift(rng: np.random.RandomState, low=-6, high=6) -> int:
    return int(rng.randint(low, high + 1))


@dataclass
class TokenSequenceAugmentations:
    pitch_shift: int = 0
    velocity_shift: int = 0
    tempo_shift: int = 0


class TupleTokenSequenceProcessor:
    """(processors.py:56-139)"""

    def __init__(
        self,
        tokenizer,
        pitch_shift_range=(-3, 3),
        velocity_shift_range=(-2, 2),
        tempo_shift_range=(-2, 2),
    ):
        self.tokenizer = tokenizer
        self.pitch_shift_range = pitch_shift_range
        self.velocity_shift_range = velocity_shift_range
        self.tempo_shift_range = tempo_shift_range

    def sample_augmentations(
        self, rng: np.random.RandomState, multiplier: float = 1.0
    ) -> TokenSequenceAugmentations:
        return TokenSequenceAugmentations(
            pitch_shift=int(multiplier * sample_integer_shift(rng, *self.pitch_shift_range)),
            velocity_shift=int(multiplier * sample_integer_shift(rng, *self.velocity_shift_range)),
            tempo_shift=int(multiplier * sample_integer_shift(rng, *self.tempo_shift_range)),
        )

    def augment_sequence(
        self, seq: np.ndarray, augmentations: TokenSequenceAugmentations
    ) -> np.ndarray:
        tok = self.tokenizer
        if augmentations.pitch_shift != 0:
            seq[:, tok.types_idx["Pitch"]] += augmentations.pitch_shift
        if augmentations.velocity_shift != 0:
            idx = tok.types_idx["Velocity"]
            vmin, vmax = tok.zero_token, tok.sizes["Velocity"] - 1
            seq[:, idx] = np.clip(seq[:, idx] + augmentations.velocity_shift, vmin, vmax)
        if augmentations.tempo_shift != 0:
            idx = tok.types_idx["Tempo"]
            vmin, vmax = tok.zero_token, tok.sizes["Tempo"] - 1
            seq[:, idx] = np.clip(seq[:, idx] + augmentations.tempo_shift, vmin, vmax)
        return seq

    def sort_sequence(self, seq: np.ndarray) -> np.ndarray:
        tok = self.tokenizer
        order = np.lexsort(
            (
                seq[:, tok.types_idx["Pitch"]],
                seq[:, tok.types_idx["Position"]],
                seq[:, tok.types_idx["Bar"]],
            )
        )
        return seq[order]

    def add_sos_token(self, seq: np.ndarray) -> np.ndarray:
        return np.concatenate([np.full_like(seq[:1], SOS), seq], axis=0)

    def add_eos_token(self, seq: np.ndarray) -> np.ndarray:
        return np.concatenate([seq, np.full_like(seq[:1], EOS)], axis=0)

    def zero_out_durations(self, seq: np.ndarray) -> np.ndarray:
        """Silent notes get zero-duration tokens (processors.py:114-124)."""
        tok = self.tokenizer
        vel_idx = tok.types_idx["Velocity"]
        if "PerfDuration" in tok.types_idx and seq.shape[-1] == len(tok.types_idx):
            dur_idx = tok.types_idx["PerfDuration"]
        else:
            dur_idx = tok.types_idx["Duration"]
        silent = seq[:, vel_idx] == tok.zero_token
        seq[silent, dur_idx] = tok.zero_token
        return seq

    def remove_silent_notes(self, seq: np.ndarray) -> np.ndarray:
        tok = self.tokenizer
        silent = seq[:, tok.types_idx["Velocity"]] == tok.zero_token
        return seq[~silent]

    def compute_valid_pitch_mask(self, seq: np.ndarray) -> np.ndarray:
        tok = self.tokenizer
        idx = tok.types_idx["Pitch"]
        pmin, pmax = tok.zero_token, tok.sizes["Pitch"] - 1
        return (seq[:, idx] >= pmin) & (seq[:, idx] <= pmax)


class TupleTokenSequenceIndexer:
    """Bar → first-note-index lookup incl. empty bars (indexers.py:16-35)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def compute_bar_indices(self, seq: np.ndarray) -> np.ndarray:
        bar_idx = self.tokenizer.types_idx["Bar"]
        z = self.tokenizer.zero_token

        min_bar = seq[0, bar_idx] - z
        total_bars = seq[-1, bar_idx] - z + 1

        bar_diff = np.concatenate([[min_bar], np.diff(seq[:, bar_idx])])
        bar_changes = np.where(bar_diff > 0)[0]

        bars = np.concatenate([[0], np.cumsum(bar_diff[bar_changes]), [total_bars]])
        bar_changes = np.concatenate([[0], bar_changes, [seq.shape[0]]])

        bar_indices = np.full(bars[-1] + 1, -1, dtype=np.int64)
        bar_indices[bars] = bar_changes

        # backward-fill empty bars from the right
        for idx in range(len(bar_indices) - 2, 0, -1):
            if bar_indices[idx] == -1:
                bar_indices[idx] = bar_indices[idx + 1]

        return bar_indices

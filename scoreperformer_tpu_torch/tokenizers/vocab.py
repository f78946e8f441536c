# Verbatim copy of scoreperformer_tpu/tokenizers/vocab.py; the port imports nothing of the JAX package.
"""Vocabulary and bin-table construction.

Reproduces, with documented provenance, the bin tables the reference builds
through miditok 2.1.6 plus its own heuristics:
- velocities / durations / tempos / time signatures: miditok-compatible
  (verified against /root/reference/data/tokenizers/*.json goldens)
- position shifts: reference spmuple.py:653-666
- relative onset deviations / performed durations:
  SPMuple variant spmuple.py:668-719, SPMuple2 variant spmuple2.py:491-546
"""
from __future__ import annotations

from math import ceil
from typing import Dict, List, Tuple

import numpy as np

from .classes import NUM_SPECIAL
from .config import TokenizerConfig

DEFAULT_TEMPO = 120.0
DEFAULT_TIME_SIGNATURE = (4, 4)


def build_velocities(nb_velocities: int) -> np.ndarray:
    """miditok velocities with the OctupleM 0-velocity prepended
    (octuple_m.py:321)."""
    velocities = np.linspace(0, 127, nb_velocities + 1, dtype=np.intc)[1:]
    return np.concatenate(([0], velocities)).astype(np.int64)


def build_durations(beat_res: Dict[Tuple[int, int], int]) -> List[Tuple[int, int, int]]:
    """miditok duration tuples (beat, pos, res) with the OctupleM 0-duration
    prepended (octuple_m.py:325)."""
    durations: List[Tuple[int, int, int]] = []
    for (start, end), res in beat_res.items():
        durations += [(beat, pos, res) for beat in range(start, end) for pos in range(res)]
    max_beat = max(end for _, end in beat_res)
    durations.append((max_beat, 0, beat_res[max(beat_res)]))
    del durations[0]  # miditok removes the 0-duration entry...
    durations = [(0, 0, durations[0][-1])] + durations  # ...OctupleM re-adds it
    return durations


def duration_values_in_beats(durations: List[Tuple[int, int, int]]) -> np.ndarray:
    """(beat*res+pos)/res per duration tuple (octuple_m.py:536-542)."""
    return np.array(
        [(beat * res + pos) / res if res > 0 else 0 for beat, pos, res in durations]
    )


def duration_ticks(durations: List[Tuple[int, int, int]], ticks_per_beat: int) -> np.ndarray:
    """Integer tick length per duration tuple (miditok _durations_ticks)."""
    return np.array(
        [(beat * res + pos) * ticks_per_beat // res if res > 0 else 0 for beat, pos, res in durations],
        dtype=np.int64,
    )


def build_tempos(tempo_range: Tuple[int, int], nb_tempos: int, log_tempos: bool) -> np.ndarray:
    fn = np.geomspace if log_tempos else np.linspace
    return fn(*tempo_range, nb_tempos).round(2)


def build_time_signatures(time_signature_range: Dict[int, List[int]]) -> List[Tuple[int, int]]:
    time_signatures: List[Tuple[int, int]] = []
    for den, nums in time_signature_range.items():
        if isinstance(nums, list):
            time_signatures.extend((num, den) for num in nums)
        else:
            time_signatures.extend((num, den) for num in range(1, nums + 1))
    return time_signatures


def build_position_shifts(max_beat_res: int) -> np.ndarray:
    """Non-uniform position-shift bins (spmuple.py:653-666)."""
    return np.concatenate(
        [
            np.arange(0, 2 * max_beat_res, 1),
            np.arange(2 * max_beat_res, 4 * max_beat_res, 2),
            np.arange(4 * max_beat_res, 8 * max_beat_res, 8),
            np.arange(8 * max_beat_res, 16 * max_beat_res + 1, 16),
        ]
    )


def build_rel_onset_devs_v1(nb_onset_devs: int) -> np.ndarray:
    """SPMuple relative onset deviation bins (spmuple.py:668-693)."""
    q = (nb_onset_devs - 1) // 8
    devs = np.concatenate(
        [
            np.linspace(0.0, 1 / 24, q + 1),
            np.linspace(1 / 24, 1 / 8, q + 1)[1:],
            np.linspace(1 / 8, 1 / 3, q + 1)[1:],
            np.linspace(1 / 3, 3 / 5, q // 2 + 1)[1:],
            np.linspace(3 / 5, 1.0, q // 4 + 1)[1:],
            (2 ** (8 * np.arange(q // 4 + 1) / q))[1:],
        ]
    )
    devs = np.round(devs, 4)
    return np.sort(np.concatenate([-devs[1:], devs]))


def build_rel_perf_durations_v1(nb_perf_durations: int) -> np.ndarray:
    """SPMuple relative performed duration bins (spmuple.py:695-719)."""
    q = (nb_perf_durations - 1) // 4
    durs = np.concatenate(
        [
            np.linspace(1 / 10, 2 / 5, q + 1),
            np.linspace(2 / 5, 2 / 3, q + 1)[1:],
            np.linspace(2 / 3, 1.0, q + 1)[1:],
            np.linspace(1.0, 5 / 4, q // 2 + 1)[1:],
            np.linspace(5 / 4, 3 / 2, q // 4 + 1)[1:],
            (2 ** (4 * np.arange(q // 4 + 1) / q) * 3 / 2)[1:],
        ]
    )
    return np.round(durs, 4)


def build_rel_onset_devs_v2(nb_onset_devs: int) -> np.ndarray:
    """SPMuple2 relative onset deviation bins (spmuple2.py:491-520)."""
    q = (nb_onset_devs - 1) // 10
    devs = np.concatenate(
        [
            np.linspace(0, 1 / 20, q + 1),
            np.linspace(1 / 20, 1 / 10, q + 1)[1:],
            np.linspace(1 / 10, 1 / 6, q + 1)[1:],
            (2 ** (np.arange(q + 1) / q) * 1 / 6)[1:],
            (2 ** (np.log(3 / 2) / np.log(2) * np.arange(q // 2 + 1) / q * 2) * 1 / 3)[1:],
            (2 ** (np.log(3 / 2) / np.log(2) * np.arange(q // 4 + 1) / q * 4) * 1 / 2)[1:],
            (2 ** (np.log(4 / 3) / np.log(2) * np.arange(q // 8 + 1) / q * 8) * 3 / 4)[1:],
            (2 ** (np.arange(q // 8 + 1) / q * 8))[1:],
        ]
    )
    devs = np.round(devs, 4)
    return np.sort(np.concatenate([-devs[1:], devs]))


def build_rel_perf_durations_v2(nb_perf_durations: int) -> np.ndarray:
    """SPMuple2 relative performed duration bins (spmuple2.py:522-546)."""
    q = (nb_perf_durations - 1) // 5
    durs = np.concatenate(
        [
            np.linspace(1 / 10, 1 / 3, q + 1),
            np.linspace(1 / 3, 4 / 5, 2 * q + 1)[1:],
            np.linspace(4 / 5, 1.0, q + 1)[1:],
            np.linspace(1.0, 5 / 4, q // 2 + 1)[1:],
            np.linspace(5 / 4, 3 / 2, q // 4 + 1)[1:],
            (2 ** (4 * np.arange(q // 4 + 1) / q) * 3 / 2)[1:],
        ]
    )
    return np.round(durs, 4)


def nearest_bin_left(bins: np.ndarray, values) -> np.ndarray:
    """Nearest bin index with ties resolving to the LOWER bin (numpy argmin
    semantics used by miditok for duration/velocity/tempo binning)."""
    bins = np.asarray(bins, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    ids = np.searchsorted(bins, values, side="left")
    ids_hi = np.minimum(ids, len(bins) - 1)
    ids_lo = np.maximum(ids - 1, 0)
    take_lo = np.abs(values - bins[ids_lo]) <= np.abs(bins[ids_hi] - values)
    # exact hits: searchsorted('left') returns the exact index; abs-equal 0 on
    # both sides only when bins repeat, where lower index matches argmin.
    exact = bins[ids_hi] == values
    out = np.where(exact, ids_hi, np.where(take_lo, ids_lo, ids_hi))
    return out.astype(np.int64)


class SPVocabulary:
    """Per-stream vocabulary: bins, sizes, and value tables for one tokenizer
    configuration (counterpart of the reference vocab built in
    octuple_m.py:295-345 and spmuple*.py _create_base_vocabulary)."""

    def __init__(self, config: TokenizerConfig, tokenization_version: int = 2):
        self.config = config
        ap = config.additional_params

        self.max_beat_res = max(config.beat_res.values())
        self.velocities = build_velocities(config.nb_velocities)
        self.durations = build_durations(config.beat_res)
        self.duration_values = duration_values_in_beats(self.durations)
        self.tempos = build_tempos(config.tempo_range, config.nb_tempos, config.log_tempos)
        self.time_signatures = build_time_signatures(config.time_signature_range)
        self.max_nb_beats = max(ceil(4 * num / den) for num, den in self.time_signatures)
        self.nb_positions = self.max_nb_beats * self.max_beat_res

        self.max_bar_embedding = ap.get("max_bar_embedding", 64)
        self.real_max_bar_embedding = ap.get("real_max_bar_embedding", self.max_bar_embedding)

        self.use_position_shifts = ap.get("use_position_shifts", False)
        self.use_onset_indices = ap.get("use_onset_indices", False)
        self.max_notes_in_onset = ap.get("max_notes_in_onset", 12)
        self.rel_onset_dev = ap.get("rel_onset_dev", False)
        self.rel_perf_duration = ap.get("rel_perf_duration", False)

        self.position_shifts = (
            build_position_shifts(self.max_beat_res) if self.use_position_shifts else None
        )

        token_bins = ap.get("token_bins", {}) or {}
        build_devs = build_rel_onset_devs_v2 if tokenization_version == 2 else build_rel_onset_devs_v1
        build_durs = (
            build_rel_perf_durations_v2 if tokenization_version == 2 else build_rel_perf_durations_v1
        )
        self.rel_onset_deviations = None
        self.rel_performed_durations = None
        if self.rel_onset_dev:
            self.rel_onset_deviations = np.asarray(
                token_bins.get("rel_onset_deviations")
                if token_bins.get("rel_onset_deviations")
                else build_devs(ap.get("nb_onset_devs", 161 if tokenization_version == 2 else 129))
            )
        if self.rel_perf_duration:
            self.rel_performed_durations = np.asarray(
                token_bins.get("rel_performed_durations")
                if token_bins.get("rel_performed_durations")
                else build_durs(ap.get("nb_perf_durations", 81 if tokenization_version == 2 else 65))
            )

        self.token_types = self._token_types()
        self.types_idx = {t: i for i, t in enumerate(self.token_types)}
        self.zero_token = NUM_SPECIAL

    def _token_types(self) -> List[str]:
        types = ["Bar", "Position", "Pitch", "Velocity", "Duration"]
        if self.config.use_tempos:
            types.append("Tempo")
        if self.config.use_time_signatures:
            types.append("TimeSig")
        if self.config.use_programs:
            types.append("Program")
        if self.use_position_shifts:
            types.append("PositionShift")
        if self.use_onset_indices:
            types += ["NotesInOnset", "PositionInOnset"]
        if self.rel_onset_dev is not None and "RelOnsetDev" not in types:
            # performance streams present only for SPMuple-family tokenizers;
            # the caller controls this via include_performance_streams
            pass
        return types

    def add_performance_streams(self):
        if self.rel_onset_dev:
            self.token_types.append("RelOnsetDev")
        else:
            self.token_types.append("OnsetDev")
        if self.rel_perf_duration:
            self.token_types.append("RelPerfDuration")
        else:
            self.token_types.append("PerfDuration")
        self.types_idx = {t: i for i, t in enumerate(self.token_types)}

    # ---- sizes ----

    def base_size(self, token_type: str) -> int:
        """Vocabulary length for a stream excluding special tokens."""
        if token_type == "Bar":
            return self.real_max_bar_embedding
        if token_type == "Position":
            return self.nb_positions
        if token_type == "Pitch":
            return self.config.pitch_range[1] - self.config.pitch_range[0]
        if token_type == "Velocity":
            return len(self.velocities)
        if token_type in ("Duration", "PerfDuration"):
            return len(self.durations)
        if token_type == "Tempo":
            return len(self.tempos)
        if token_type == "TimeSig":
            return len(self.time_signatures)
        if token_type == "Program":
            return len(self.config.programs)
        if token_type == "PositionShift":
            return len(self.position_shifts)
        if token_type in ("NotesInOnset", "PositionInOnset"):
            return self.max_notes_in_onset
        if token_type == "OnsetDev":
            return 2 * (self.max_beat_res * 2) + 1
        if token_type == "RelOnsetDev":
            return len(self.rel_onset_deviations)
        if token_type == "RelPerfDuration":
            return len(self.rel_performed_durations)
        raise KeyError(token_type)

    @property
    def sizes(self) -> Dict[str, int]:
        """Model-facing sizes (special tokens included; Bar capped at
        max_bar_embedding — octuple_m.py:522-529)."""
        sizes = {t: self.base_size(t) + NUM_SPECIAL for t in self.token_types}
        sizes["Bar"] -= self.real_max_bar_embedding - self.max_bar_embedding
        return sizes

    def grow_bar_vocab(self, nb_bars: int) -> None:
        """Grow the Bar vocabulary for longer pieces (octuple_m.py:189-198)."""
        if nb_bars > self.real_max_bar_embedding:
            self.real_max_bar_embedding = int(nb_bars)
            self.config.additional_params["real_max_bar_embedding"] = int(nb_bars)

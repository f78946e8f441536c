# Verbatim copy of scoreperformer_tpu/tokenizers/octuple_m.py; the port imports nothing of the JAX package.
"""OctupleM tokenizer: MIDI ⇄ multi-stream token matrices, fully vectorized.

A from-scratch re-design of the reference OctupleM
(scoreperformer/data/tokenizers/common/octuple_m.py) on SoA note arrays:
instead of building per-note Event lists and walking them in Python
(octuple_m.py:90-166), bar/position/tempo/time-sig streams are computed with
vectorized segment arithmetic over the whole piece at once.

Each note becomes a tuple of token ids:
    (Bar, Position, Pitch, Velocity, Duration[, Tempo][, TimeSig][, Program])
Token id = bin index + 4 (the [PAD, MASK, SOS, EOS] specials lead each stream).
"""
from __future__ import annotations

from math import ceil
from typing import Dict, List, Optional, Union

import numpy as np

from ..midi import MidiScore, NoteArray, TempoMap, TimeSigMap, Track
from ..midi.preprocess import fill_unperformed_notes
from ..midi.ops import (
    quantize_time_signature_times,
    remove_duplicated_notes,
)
from .classes import NUM_SPECIAL, TIME_DIVISION, SCORE_KEYS, TokSequence
from .config import TokenizerConfig
from .vocab import (
    DEFAULT_TEMPO,
    DEFAULT_TIME_SIGNATURE,
    SPVocabulary,
    duration_ticks,
    nearest_bin_left,
)


class OctupleM:
    """Modified Octuple encoding (MusicBERT-style), TPU-native implementation."""

    TOKENIZATION_VERSION = 1  # selects SPMuple-v1 bin heuristics in the vocab

    def __init__(self, config: Optional[TokenizerConfig] = None, **kwargs):
        self.config = config or TokenizerConfig(**kwargs)
        self._tweak_config()
        self.vocab = SPVocabulary(self.config, tokenization_version=self.TOKENIZATION_VERSION)
        self._finalize_vocab()
        self._durations_ticks: Dict[int, np.ndarray] = {}

    # ---- configuration ----

    def _tweak_config(self) -> None:
        ap = self.config.additional_params
        ap["max_bar_embedding"] = ap.get("max_bar_embedding", 64)
        ap["real_max_bar_embedding"] = ap.get(
            "real_max_bar_embedding", ap["max_bar_embedding"]
        )
        ap["fill_unperformed_notes"] = True
        ap.setdefault("remove_duplicates", False)

    def _finalize_vocab(self) -> None:
        pass

    # ---- properties ----

    @property
    def types_idx(self) -> Dict[str, int]:
        return self.vocab.types_idx

    @property
    def token_types(self) -> List[str]:
        return self.vocab.token_types

    @property
    def zero_token(self) -> int:
        return NUM_SPECIAL

    @property
    def sizes(self) -> Dict[str, int]:
        return self.vocab.sizes

    @property
    def score_sizes(self) -> Dict[str, int]:
        return {k: v for k, v in self.sizes.items() if k in SCORE_KEYS}

    @property
    def performance_sizes(self) -> Dict[str, int]:
        return self.sizes

    @property
    def max_beat_res(self) -> int:
        return self.vocab.max_beat_res

    def durations_ticks(self, ticks_per_beat: int) -> np.ndarray:
        if ticks_per_beat not in self._durations_ticks:
            self._durations_ticks[ticks_per_beat] = duration_ticks(
                self.vocab.durations, ticks_per_beat
            )
        return self._durations_ticks[ticks_per_beat]

    # ---- preprocessing (vectorized counterparts of the reference loops) ----

    def _quantize_notes(
        self, notes: NoteArray, time_division: int, is_score: bool = True
    ) -> NoteArray:
        """Pitch filter + grid snap (scores only) + velocity binning
        (reference spmuple.py:542-589, octuple_m via miditok)."""
        pr = self.config.pitch_range
        notes = notes[(notes.pitch >= pr[0]) & (notes.pitch < pr[1])]
        if len(notes) == 0:
            return notes
        notes = notes.copy()

        if is_score:
            ticks_per_sample = int(time_division / self.max_beat_res)
            max_duration_ticks = max(end for _, end in self.config.beat_res) * time_division
            start, end = notes.start, notes.end
            start_offset = start % ticks_per_sample
            start = start + np.where(
                start_offset <= ticks_per_sample / 2,
                -start_offset,
                ticks_per_sample - start_offset,
            )
            too_long = (end - start) > max_duration_ticks
            end_offset = end % ticks_per_sample
            quant_end = end + np.where(
                end_offset <= ticks_per_sample / 2,
                -end_offset,
                ticks_per_sample - end_offset,
            )
            quant_end = np.where(quant_end == start, quant_end + ticks_per_sample, quant_end)
            end = np.where(too_long, start + max_duration_ticks, quant_end)
            notes.start = start.astype(np.int64)
            notes.end = end.astype(np.int64)

        velocities = self.vocab.velocities[1:]
        performed = notes.velocity > 0
        binned = velocities[nearest_bin_left(velocities, notes.velocity)]
        notes.velocity = np.where(performed, binned, notes.velocity).astype(np.int64)
        return notes

    def _quantize_tempos(self, midi: MidiScore) -> None:
        """Bin tempo values, drop equal successors, snap times
        (miditok _quantize_tempos semantics)."""
        tempos = self.vocab.tempos
        times = midi.tempos.time.copy()
        values = tempos[nearest_bin_left(tempos, midi.tempos.tempo)]
        if self.config.delete_equal_successive_tempo_changes and len(values) > 1:
            keep = np.ones(len(values), dtype=bool)
            keep[1:] = values[1:] != values[:-1]
            times, values = times[keep], values[keep]
        ticks_per_sample = int(midi.ticks_per_beat / self.max_beat_res)
        rest = times % ticks_per_sample
        times = times + np.where(rest <= ticks_per_sample / 2, -rest, ticks_per_sample - rest)
        midi.tempos = TempoMap(times, values)

    def _quantize_time_signatures(self, midi: MidiScore) -> None:
        ts = midi.time_sigs
        t, n, d = quantize_time_signature_times(
            ts.time, ts.numerator, ts.denominator, midi.ticks_per_beat
        )
        midi.time_sigs = TimeSigMap(t, n, d)

    def _quantize_aux_event_streams(self, midi: MidiScore) -> None:
        """Snap sustain pedals and pitch bends to the sample grid, gated by
        the config flags (reference midi_tokenizer.py:44-52)."""
        from ..midi.ops import quantize_pitch_bends, quantize_sustain_pedals

        ticks_per_sample = int(midi.ticks_per_beat / self.max_beat_res)
        for track in midi.tracks:
            if self.config.use_sustain_pedals and len(track.pedals):
                track.pedals = quantize_sustain_pedals(track.pedals, ticks_per_sample)
            if self.config.use_pitch_bends and len(track.pitch_bends):
                track.pitch_bends = quantize_pitch_bends(track.pitch_bends, ticks_per_sample)

    def preprocess_midi(self, midi: MidiScore, is_score: bool = True) -> MidiScore:
        """In-place preprocessing (reference midi_tokenizer.py:17-71 +
        octuple_m.py:75-88)."""
        if self.config.additional_params.get("fill_unperformed_notes", True):
            fill_unperformed_notes(midi)

        kept_tracks = []
        for track in midi.tracks:
            notes = self._quantize_notes(track.notes, midi.ticks_per_beat, is_score=is_score)
            notes = notes.sort("time")
            if self.config.additional_params.get("remove_duplicates", False):
                notes = remove_duplicated_notes(notes)
            if len(notes) == 0:
                continue
            track.notes = notes
            kept_tracks.append(track)
        midi.tracks = kept_tracks
        self._quantize_aux_event_streams(midi)

        if midi.tracks:
            midi.recompute_max_tick()
            keep = midi.tempos.time < midi.max_tick
            midi.tempos = TempoMap(midi.tempos.time[keep], midi.tempos.tempo[keep])

        if len(midi.time_sigs) == 0:
            midi.time_sigs = TimeSigMap.default()

        if self.config.use_tempos:
            self._quantize_tempos(midi)
        if self.config.use_time_signatures:
            self._quantize_time_signatures(midi)
        return midi

    # ---- encode ----

    def midi_to_tokens(self, midi: MidiScore, preprocess: bool = True) -> TokSequence:
        if preprocess:
            self.preprocess_midi(midi)
        return self._midi_to_tokens(midi)

    def _gather_notes(self, midi: MidiScore):
        """All notes in the reference's global event order: stable sort by
        start tick with track order preserved for ties."""
        notes, track_ids = midi.all_notes(with_track_ids=True)
        order = np.argsort(notes.start, kind="stable")
        programs = np.array(
            [(-1 if t.is_drum else t.program) for t in midi.tracks], dtype=np.int64
        )
        return notes[order], (programs[track_ids[order]] if len(midi.tracks) else programs)

    def _bar_position_streams(self, midi: MidiScore, note_start: np.ndarray):
        """Vectorized bar/position computation over time-signature segments
        (replaces the event walk at octuple_m.py:108-166)."""
        tpb_midi = midi.ticks_per_beat
        ticks_per_sample = tpb_midi / self.max_beat_res

        ts = midi.time_sigs
        ts_times = ts.time.astype(np.int64)
        ts_nums = ts.numerator.astype(np.int64)
        ts_dens = ts.denominator.astype(np.int64)
        if len(ts_times) == 0 or ts_times[0] != 0:
            ts_times = np.concatenate([[0], ts_times])
            ts_nums = np.concatenate([[DEFAULT_TIME_SIGNATURE[0]], ts_nums])
            ts_dens = np.concatenate([[DEFAULT_TIME_SIGNATURE[1]], ts_dens])

        ticks_per_bar = (tpb_midi * 4 * ts_nums / ts_dens).astype(np.int64)
        # bar index at each time-sig boundary
        ts_bars = np.zeros(len(ts_times), dtype=np.int64)
        if len(ts_times) > 1:
            ts_bars[1:] = np.cumsum(np.diff(ts_times) // ticks_per_bar[:-1])

        seg = np.maximum(0, np.searchsorted(ts_times, note_start, side="right") - 1)
        elapsed = note_start - ts_times[seg]
        bars = ts_bars[seg] + elapsed // ticks_per_bar[seg]
        positions = ((elapsed % ticks_per_bar[seg]) / ticks_per_sample).astype(np.int64)
        return bars, positions, (ts_times, ts_nums, ts_dens)

    def _midi_to_tokens(self, midi: MidiScore) -> TokSequence:
        # Bar-vocabulary growth (octuple_m.py:189-198)
        min_ticks_per_bar = min(
            int(midi.ticks_per_beat * 4 * int(n) / int(d))
            for n, d in zip(midi.time_sigs.numerator, midi.time_sigs.denominator)
        )
        nb_bars = ceil(midi.max_tick / min_ticks_per_bar)
        self.vocab.grow_bar_vocab(nb_bars)

        notes, programs = self._gather_notes(midi)
        num = len(notes)
        z = self.zero_token

        bars, positions, (ts_times, ts_nums, ts_dens) = self._bar_position_streams(
            midi, notes.start
        )

        streams = {
            "Bar": bars + z,
            "Position": positions + z,
            "Pitch": notes.pitch - self.config.pitch_range[0] + z,
            "Velocity": np.searchsorted(self.vocab.velocities, notes.velocity) + z,
            "Duration": nearest_bin_left(
                self.durations_ticks(midi.ticks_per_beat), notes.end - notes.start
            )
            + z,
        }

        if self.config.use_tempos:
            tempo_times = midi.tempos.time
            tempo_values = midi.tempos.tempo
            if len(tempo_times) == 0:
                tempo_times, tempo_values = np.array([0]), np.array([DEFAULT_TEMPO])
            seg = np.searchsorted(tempo_times, notes.start, side="right") - 1
            note_tempos = np.where(
                seg >= 0, tempo_values[np.maximum(seg, 0)], DEFAULT_TEMPO
            )
            streams["Tempo"] = nearest_bin_left(self.vocab.tempos, note_tempos) + z

        if self.config.use_time_signatures:
            ts_list = self.vocab.time_signatures
            ts_lut = {t: i for i, t in enumerate(ts_list)}
            seg = np.maximum(0, np.searchsorted(ts_times, notes.start, side="right") - 1)
            sig_ids = np.array(
                [
                    ts_lut.get((int(n), int(d)), ts_lut.get(DEFAULT_TIME_SIGNATURE, 0))
                    for n, d in zip(ts_nums, ts_dens)
                ],
                dtype=np.int64,
            )
            streams["TimeSig"] = sig_ids[seg] + z

        if self.config.use_programs:
            program_list = list(self.config.programs)
            prog_lut = {p: i for i, p in enumerate(program_list)}
            streams["Program"] = (
                np.array([prog_lut.get(int(p), 0) for p in programs], dtype=np.int64) + z
            )

        ids = np.stack(
            [streams[t] for t in self.token_types if t in streams], axis=1
        ).astype(np.int64)
        return TokSequence(ids=ids)

    # ---- decode ----

    def decode_token_type(self, tokens: np.ndarray, token_type: str) -> np.ndarray:
        """Token ids → values for one stream (octuple_m.py:371-390)."""
        idx = tokens[:, self.types_idx[token_type]] - self.zero_token
        if token_type == "Pitch":
            return idx + self.config.pitch_range[0]
        if token_type == "Velocity":
            return self.vocab.velocities[idx]
        if token_type == "Duration":
            return self.vocab.duration_values[idx] * self.max_beat_res
        if token_type == "Tempo":
            return self.vocab.tempos[idx]
        if token_type == "TimeSig":
            return np.array(self.vocab.time_signatures)[idx]
        return idx

    @staticmethod
    def _cumulative_grid(
        seg_start_bars: np.ndarray, seg_step: np.ndarray, n_units: int
    ) -> np.ndarray:
        """Tick grid of `n_units` equal-step units under piecewise-constant
        step sizes: unit u takes the step of the last segment starting at or
        before it; grid[k] = sum of the first k steps (with grid[0] = 0).

        One helper serves both the bar grid (step = ticks per bar) and the
        beat grid (step = ticks per beat) — the semantics of reference
        octuple_m.py:493-494 and :515-516, which spell this out twice.
        """
        seg_ids = np.maximum(
            0, np.searchsorted(seg_start_bars, np.arange(n_units), side="right") - 1
        )
        return np.concatenate([[0], np.cumsum(seg_step[seg_ids])])

    @staticmethod
    def _beats_per_bar(numerators: np.ndarray) -> np.ndarray:
        """Felt beats per bar: compound meters (6/9/12/18/24) group by 3
        (octuple_m.py:508-511)."""
        beats = numerators.copy()
        beats[beats == 6] = 2
        beats[np.isin(beats, (9, 18))] = 3
        beats[np.isin(beats, (12, 24))] = 4
        return beats

    def compute_ticks(
        self,
        tokens: np.ndarray,
        time_division: int = TIME_DIVISION,
        compute_beat_ticks: bool = False,
    ) -> Dict[str, object]:
        """Note-on / time-sig / bar / beat tick positions from tokens.

        Tick semantics of reference octuple_m.py:460-520 (valid for full-length
        or single-time-signature sequences): time-signature change rows define
        segments of constant bar/beat length, and the bar and beat grids are
        cumulative sums over those piecewise-constant steps
        (`_cumulative_grid`).
        """
        tokens = np.asarray(tokens)
        bars = self.decode_token_type(tokens, "Bar")
        positions = self.decode_token_type(tokens, "Position")

        # time-signature segments: change rows in the TimeSig stream
        changes = np.flatnonzero(
            np.r_[True, np.diff(tokens[:, self.types_idx["TimeSig"]]) != 0]
        )
        time_sigs = self.decode_token_type(tokens[changes], "TimeSig")
        seg_bars = bars[changes]

        ticks_per_bar = time_division * 4 * time_sigs[:, 0] / time_sigs[:, 1]
        seg_ticks = np.concatenate(
            [[0], np.cumsum(ticks_per_bar[:-1] * np.diff(seg_bars))]
        )

        bar_ticks = self._cumulative_grid(seg_bars, ticks_per_bar, bars[-1] + 1)
        note_on_ticks = bar_ticks[bars] + positions * (time_division / self.max_beat_res)

        ticks_data = {
            "note_on": note_on_ticks,
            "time_sig": (time_sigs, seg_ticks),
            "bar": bar_ticks,
        }

        if compute_beat_ticks:
            beats_in_bar = self._beats_per_bar(time_sigs[:, 0])
            n_beats = np.sum(
                np.diff(np.concatenate([seg_bars, [bars[-1] + 1]])) * beats_in_bar
            )
            ticks_data["beat"] = self._cumulative_grid(
                seg_bars, ticks_per_bar // beats_in_bar, n_beats + 1
            )

        return ticks_data

    def tokens_to_midi(
        self,
        tokens: Union[TokSequence, np.ndarray],
        time_division: int = TIME_DIVISION,
        output_path=None,
    ) -> MidiScore:
        """Tokens → MIDI (octuple_m.py:203-293)."""
        assert time_division % self.max_beat_res == 0
        if isinstance(tokens, TokSequence):
            tokens = tokens.ids
        tokens = np.asarray(tokens)
        ticks_per_sample = time_division // self.max_beat_res

        midi = MidiScore(ticks_per_beat=time_division)
        ticks_data = self.compute_ticks(tokens, time_division, compute_beat_ticks=True)

        durations = self.decode_token_type(tokens, "Duration") * ticks_per_sample
        velocities = self.decode_token_type(tokens, "Velocity")
        pitches = self.decode_token_type(tokens, "Pitch")

        note_on_ticks = ticks_data["note_on"].astype(np.int64)
        note_off_ticks = (note_on_ticks + durations).astype(np.int64)

        time_sigs, time_sig_ticks = ticks_data["time_sig"]
        midi.time_sigs = TimeSigMap(
            time_sig_ticks.astype(np.int64), time_sigs[:, 0], time_sigs[:, 1]
        )

        tempo_col = tokens[:, self.types_idx["Tempo"]]
        change_rows = np.concatenate([[0], np.flatnonzero(np.diff(tempo_col)) + 1])
        tempos = self.decode_token_type(tokens[change_rows], "Tempo")
        if len(tempos) > 0:
            beat_ticks = ticks_data["beat"]
            # snap each change to the beat grid at/after its note-on
            anchors = np.searchsorted(beat_ticks, note_on_ticks[change_rows])
            change_ticks = beat_ticks[anchors.clip(max=beat_ticks.shape[0] - 1)]
            change_ticks[0] = 0
        else:
            change_ticks = np.array([0])
        midi.tempos = TempoMap(change_ticks.astype(np.int64), np.round(tempos, 3))

        if self.config.use_programs:
            programs = self.decode_token_type(tokens, "Program")
            programs = np.array(self.config.programs)[programs]
        else:
            programs = np.zeros(len(tokens), dtype=np.int64)

        for program in np.unique(programs):
            ids = np.where(programs == program)[0]
            midi.tracks.append(
                Track(
                    notes=NoteArray(
                        pitch=pitches[ids].astype(np.int32),
                        velocity=velocities[ids].astype(np.int32),
                        start=note_on_ticks[ids],
                        end=note_off_ticks[ids],
                    ),
                    program=0 if program == -1 else int(program),
                    is_drum=bool(program == -1),
                )
            )

        midi.max_tick = int(note_off_ticks.max()) + 1

        if output_path:
            from ..midi import write_midi

            write_midi(midi, output_path)
        return midi

    # ---- value tables ----

    def token_values(
        self, normalize: Union[bool, List[str]] = False, special_tokens: bool = True
    ) -> Dict[str, np.ndarray]:
        """Per-stream value tables feeding the continuous embeddings
        (octuple_m.py:392-412)."""
        if isinstance(normalize, bool):
            normalize = list(self.types_idx) if normalize else []
        return {
            key: self.token_type_values(key, key in normalize, special_tokens)
            for key in self.types_idx
        }

    def token_type_values(
        self, token_type: str, normalize: bool = False, special_tokens: bool = True
    ) -> np.ndarray:
        """(octuple_m.py:414-458)"""
        v = self.vocab
        # (raw-table builder, normalizer) per stream; unknown streams map to
        # an all-zero table of the stream's base size
        tables = {
            "Bar": (
                lambda: np.arange(1, v.max_bar_embedding + 1),
                lambda x: x / v.max_bar_embedding,
            ),
            "Position": (
                lambda: np.arange(v.nb_positions),
                lambda x: x / v.max_beat_res / 4,
            ),
            "Pitch": (
                lambda: np.arange(*self.config.pitch_range),
                lambda x: x % 127,
            ),
            "Velocity": (
                lambda: v.velocities,
                lambda x: x / v.velocities[-1],
            ),
            "Duration": (
                lambda: v.duration_values,
                lambda x: np.log2(x + 1),
            ),
            "PerfDuration": (
                lambda: v.duration_values,
                lambda x: np.log2(x + 1),
            ),
            "Tempo": (
                lambda: v.tempos,
                lambda x: np.log2(x / v.tempos[0]),
            ),
            "TimeSig": (
                lambda: np.array([n / d for n, d in v.time_signatures]),
                lambda x: x,
            ),
        }
        entry = tables.get(token_type)
        if entry is None:
            values = np.zeros(v.base_size(token_type))
        else:
            build_table, normalizer = entry
            values = build_table()
            if normalize:
                values = normalizer(values)

        if special_tokens:
            values = np.concatenate([np.zeros(self.zero_token), values])
        return values

    # ---- persistence ----

    def save(self, path) -> None:
        self.config.save(path, tokenization=type(self).__name__)

    @classmethod
    def from_file(cls, path) -> "OctupleM":
        from . import TOKENIZERS

        config, tokenization = TokenizerConfig.from_file(path)
        tok_cls = TOKENIZERS.get(tokenization, cls)
        return tok_cls(config)

# Verbatim copy of scoreperformer_tpu/tokenizers/spmuple.py; the port imports nothing of the JAX package.
"""SPMuple: score-performance tuple encoding (v1, bar/beat local tempos).

Counterpart of scoreperformer/data/tokenizers/spmuple/{base,spmuple}.py on SoA
containers: score streams (PositionShift, NotesInOnset, PositionInOnset) and
performance streams ((Rel)OnsetDev, (Rel)PerfDuration), with beat/bar tempo
majority election.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..midi import MidiScore, NoteArray, TempoMap, TimeSigMap, Track
from ..midi.ops import cut_overlapping_notes
from ..utils import find_closest
from .classes import MASK, NUM_SPECIAL, TIME_DIVISION, TokSequence
from .octuple_m import OctupleM
from .vocab import DEFAULT_TEMPO, nearest_bin_left


class SPMuple(OctupleM):
    """ScorePerformanceMusic-tuple encoding (reference spmuple.py:24-813)."""

    TOKENIZATION_VERSION = 1

    def _tweak_config(self) -> None:
        super()._tweak_config()
        ap = self.config.additional_params
        ap.setdefault("token_bins", {})
        ap["cut_overlapping_notes"] = True
        ap.setdefault("use_position_shifts", False)
        ap.setdefault("onset_position_shifts", True)
        ap.setdefault("use_onset_indices", False)
        ap.setdefault("max_notes_in_onset", 12)
        ap.setdefault("rel_onset_dev", False)
        ap.setdefault("nb_onset_devs", 129)
        ap.setdefault("rel_perf_duration", False)
        ap.setdefault("nb_perf_durations", 65)
        ap.setdefault("bar_tempos", False)

    def _finalize_vocab(self) -> None:
        self.vocab.add_performance_streams()

    # ---- properties ----

    @property
    def position_shifts(self) -> Optional[np.ndarray]:
        return self.vocab.position_shifts

    @property
    def rel_onset_deviations(self) -> Optional[np.ndarray]:
        return self.vocab.rel_onset_deviations

    @property
    def rel_performed_durations(self) -> Optional[np.ndarray]:
        return self.vocab.rel_performed_durations

    @property
    def score_sizes(self):
        from .classes import SCORE_KEYS

        return {k: v for k, v in self.sizes.items() if k in SCORE_KEYS}

    # ---- preprocessing ----

    def preprocess_midi(self, midi: MidiScore, is_score: bool = True) -> MidiScore:
        """(reference spmuple.py:58-91): performance MIDIs skip note-time
        quantization and time-signature quantization."""
        from ..midi.preprocess import fill_unperformed_notes
        from ..midi.ops import remove_duplicated_notes

        fill_unperformed_notes(midi)

        kept = []
        for track in midi.tracks:
            notes = self._quantize_notes(track.notes, midi.ticks_per_beat, is_score=is_score)
            notes = notes.sort("time")
            if self.config.additional_params.get("remove_duplicates", False):
                notes = remove_duplicated_notes(notes)
            if len(notes) == 0:
                continue
            track.notes = notes
            kept.append(track)
        midi.tracks = kept
        self._quantize_aux_event_streams(midi)

        if midi.tracks:
            midi.recompute_max_tick()
            keep = midi.tempos.time < midi.max_tick
            midi.tempos = TempoMap(midi.tempos.time[keep], midi.tempos.tempo[keep])

        if len(midi.time_sigs) == 0:
            midi.time_sigs = TimeSigMap.default()

        if self.config.use_tempos:
            self._quantize_tempos(midi)
        if is_score and self.config.use_time_signatures:
            self._quantize_time_signatures(midi)
        return midi

    def preprocess_score_midi(self, midi: MidiScore) -> MidiScore:
        return self.preprocess_midi(midi, is_score=True)

    def preprocess_performance_midi(self, midi: MidiScore) -> MidiScore:
        return self.preprocess_midi(midi, is_score=False)

    # ---- score encode ----

    def score_midi_to_tokens(self, midi: MidiScore, preprocess: bool = True) -> TokSequence:
        """OctupleM score tokens + PositionShift/NotesInOnset/PositionInOnset
        streams (spmuple.py:93-146)."""
        if preprocess:
            self.preprocess_score_midi(midi)
        seq = self._midi_to_tokens(midi)
        ap = self.config.additional_params
        if not (ap["use_position_shifts"] or ap["use_onset_indices"]):
            return seq

        ids = seq.ids
        time_division = midi.ticks_per_beat
        ticks_per_sample = time_division / self.max_beat_res
        ticks_data = self.compute_ticks(ids, time_division, compute_beat_ticks=True)
        score_positions = ticks_data["note_on"] / ticks_per_sample

        extra = []
        if ap["use_position_shifts"]:
            pos_shifts = self.compute_position_shifts(score_positions)
            extra.append(find_closest(self.position_shifts, pos_shifts) + self.zero_token)

        _, notes_in_onset, pos_in_onset = self.compute_onset_values(score_positions)
        if ap["use_onset_indices"]:
            extra.append(notes_in_onset - 1 + self.zero_token)
            extra.append(pos_in_onset + self.zero_token)

        ids = np.concatenate([ids] + [e[:, None] for e in extra], axis=1)
        return TokSequence(ids=ids.astype(np.int64), meta=seq.meta)

    def compute_position_shifts(
        self, score_positions: np.ndarray, onset_shift: Optional[bool] = None
    ) -> np.ndarray:
        """(spmuple.py:721-736)"""
        if onset_shift is None:
            onset_shift = self.config.additional_params["onset_position_shifts"]
        if onset_shift:
            unique_pos, counts = np.unique(score_positions, return_counts=True)
            owner = np.arange(len(unique_pos)).repeat(counts)
            shifts = unique_pos[owner] - unique_pos[owner - 1]
            # owner 0 wrapped to the last unique position above — those
            # entries reset to the raw score position
            shifts = np.where(shifts < 0, score_positions, shifts)
        else:
            shifts = np.concatenate([score_positions[:1], np.diff(score_positions)])
        return shifts

    def compute_onset_values(self, score_positions: np.ndarray):
        """(spmuple.py:738-754)"""
        max_in_onset = self.config.additional_params["max_notes_in_onset"]
        unique_pos, counts = np.unique(score_positions, return_counts=True)
        pos_ids = np.arange(len(unique_pos)).repeat(counts)

        notes_in_onset = np.minimum(counts[pos_ids], max_in_onset)

        pos_in_onset = np.repeat(np.cumsum(-counts) + counts, counts)
        pos_in_onset = pos_in_onset + np.arange(len(pos_in_onset))
        pos_in_onset = np.minimum(pos_in_onset, max_in_onset - 1)

        return pos_ids, notes_in_onset, pos_in_onset

    # ---- performance encode ----

    def performance_midi_to_tokens(
        self,
        midi: MidiScore,
        score_tokens: TokSequence,
        alignment: Optional[np.ndarray] = None,
        preprocess: bool = True,
    ) -> TokSequence:
        """(reference base.py:71-107)"""
        if preprocess:
            self.preprocess_performance_midi(midi)
        return self._performance_midi_to_tokens(midi, score_tokens, alignment)

    def _performance_base_rows(self, midi: MidiScore) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Build pre-performance token rows for all tracks.

        Returns (ids, perf_positions, perf_durations): ids are the token rows
        sorted by (time, track-desc, pitch); positions/durations stay in the
        pre-sort track-concatenation order (faithful to the reference, which
        snapshots them before sorting — spmuple.py:190-196).
        """
        tps = midi.ticks_per_beat / self.max_beat_res

        notes, track_ids = midi.all_notes(with_track_ids=True)
        descs = np.array(
            [(-1 if t.is_drum else t.program) for t in midi.tracks], dtype=np.int64
        )[track_ids] if len(midi.tracks) else np.empty(0, np.int64)

        perf_positions = notes.start / tps
        perf_durations = (notes.end - notes.start) / tps

        order = np.lexsort((notes.pitch, descs, notes.start))
        sorted_notes = notes[order]
        sorted_descs = descs[order]

        num = len(sorted_notes)
        z = self.zero_token
        # base rows span the score streams only; the two performance streams
        # are appended at the end of the encode
        base_types = [
            t
            for t in self.token_types
            if t not in ("OnsetDev", "RelOnsetDev", "PerfDuration", "RelPerfDuration")
        ]
        columns = {}
        for t in base_types:
            columns[t] = np.full(num, MASK, dtype=np.int64)
        columns["Pitch"] = sorted_notes.pitch - self.config.pitch_range[0] + z
        columns["Velocity"] = np.searchsorted(self.vocab.velocities, sorted_notes.velocity) + z

        if self.config.use_tempos and not self._mask_perf_tempo():
            tempo_times = midi.tempos.time
            tempo_values = midi.tempos.tempo
            if len(tempo_times) == 0:
                tempo_times, tempo_values = np.array([0]), np.array([DEFAULT_TEMPO])
            seg = np.searchsorted(tempo_times, sorted_notes.start, side="right") - 1
            note_tempos = np.where(
                seg >= 0, tempo_values[np.maximum(seg, 0)], DEFAULT_TEMPO
            )
            columns["Tempo"] = nearest_bin_left(self.vocab.tempos, note_tempos) + z

        if self.config.use_programs:
            prog_lut = {p: i for i, p in enumerate(self.config.programs)}
            columns["Program"] = (
                np.array([prog_lut.get(int(p), 0) for p in sorted_descs], dtype=np.int64) + z
            )

        ids = np.stack([columns[t] for t in base_types], axis=1)
        return ids, perf_positions, perf_durations

    def _mask_perf_tempo(self) -> bool:
        """v1 keeps performance-MIDI tempo tokens; v2 masks them
        (spmuple2.py:150-151)."""
        return False

    # -- encode helpers --------------------------------------------------

    def _snap_to_grid(self, ticks: np.ndarray, grid: np.ndarray) -> np.ndarray:
        """Right-snap each tick onto a beat/bar grid (clamped to the last
        grid line)."""
        return grid[np.minimum(np.searchsorted(grid, ticks), len(grid) - 1)]

    def _tempo_grid(self, ticks_data: dict) -> np.ndarray:
        """Grid that tempo anchors snap to: bars under ``bar_tempos``,
        beats otherwise."""
        key = "bar" if self.config.additional_params["bar_tempos"] else "beat"
        return ticks_data[key]

    def _elect_beat_tempos(
        self, note_beats: np.ndarray, tempo_ids: np.ndarray
    ) -> np.ndarray:
        """Majority vote of one tempo token per beat.

        Semantics of reference spmuple.py:223-239 (ties resolve to the lowest
        tempo id) expressed as a single vectorized pass: unique
        (beat, tempo) vote pairs ordered by (beat asc, count desc, tempo asc),
        keeping each beat's leading row. Returns int rows (beat_tick, tempo_id)
        sorted by beat tick.
        """
        votes, counts = np.unique(
            np.stack([note_beats, tempo_ids.astype(float)], axis=1),
            axis=0,
            return_counts=True,
        )
        ranked = votes[np.lexsort((votes[:, 1], -counts, votes[:, 0]))]
        leads = np.r_[True, np.diff(ranked[:, 0]) != 0]
        return ranked[leads].astype(int)

    def _copy_score_streams(self, tokens: np.ndarray, score_ids: np.ndarray) -> None:
        """Overwrite score-owned streams with the aligned score's ids in place
        (spmuple.py:246-254 / spmuple2.py:165-173)."""
        ap = self.config.additional_params
        streams = ["Bar", "Position", "Duration", "TimeSig"]
        if ap["use_position_shifts"]:
            streams.append("PositionShift")
        if ap["use_onset_indices"]:
            streams += ["NotesInOnset", "PositionInOnset"]
        for stream in streams:
            col = self.types_idx[stream]
            tokens[:, col] = score_ids[:, col]

    def _onset_dev_stream(
        self, tokens: np.ndarray, onset_devs: np.ndarray, score_positions: np.ndarray
    ) -> np.ndarray:
        """Quantize onset deviations: relative to inter-onset shifts under
        ``rel_onset_dev`` (spmuple.py:256-270), absolute-clipped otherwise."""
        ap = self.config.additional_params
        if ap["rel_onset_dev"]:
            if ap["use_position_shifts"] and ap["onset_position_shifts"]:
                pos_shifts = self.position_shifts[
                    tokens[:, self.types_idx["PositionShift"]] - self.zero_token
                ].astype(np.float64)
            else:
                pos_shifts = self.compute_position_shifts(score_positions, onset_shift=True)
            pos_shifts[pos_shifts == 0] = 1
            return find_closest(self.rel_onset_deviations, onset_devs / pos_shifts)
        limit = self.max_beat_res * 2
        return np.clip(onset_devs, -limit, limit) + limit

    def _perf_duration_stream(
        self, perf_durations: np.ndarray, score_durations: np.ndarray
    ) -> np.ndarray:
        """Quantize performed durations, relative to score durations under
        ``rel_perf_duration`` (spmuple.py:272-283)."""
        if self.config.additional_params["rel_perf_duration"]:
            return find_closest(
                self.rel_performed_durations, perf_durations / score_durations
            )
        return (
            find_closest(self.vocab.duration_values[1:] * self.max_beat_res, perf_durations)
            + 1
        )

    def _performance_midi_to_tokens(
        self,
        midi: MidiScore,
        score_tokens: TokSequence,
        alignment: Optional[np.ndarray] = None,
    ) -> TokSequence:
        """Performance encode (semantics of spmuple.py:148-294): elect one
        tempo per beat, copy score streams, quantize deviation/duration
        streams."""
        time_division = midi.ticks_per_beat
        ticks_per_sample = time_division / self.max_beat_res

        tokens, perf_positions, perf_durations = self._performance_base_rows(midi)
        score_ids = np.asarray(score_tokens.ids)

        ticks_data = self.compute_ticks(score_ids, time_division, compute_beat_ticks=True)
        note_on_ticks = ticks_data["note_on"]
        note_beats = self._snap_to_grid(note_on_ticks, self._tempo_grid(ticks_data))

        # the election pairs each performance row (pre-alignment order) with
        # its score note's beat; the same permuted beats key the write-back
        # after tokens are brought into score order (spmuple.py:209-245)
        if alignment is not None:
            note_beats = note_beats[np.argsort(alignment)]
        beat_tempos = self._elect_beat_tempos(
            note_beats, tokens[:, self.types_idx["Tempo"]]
        )

        if alignment is not None:
            tokens = tokens[alignment]
            perf_positions = perf_positions[alignment]
            perf_durations = perf_durations[alignment]

        tokens[:, self.types_idx["Tempo"]] = beat_tempos[
            np.searchsorted(beat_tempos[:, 0], note_beats), 1
        ]

        self._copy_score_streams(tokens, score_ids)

        score_positions = note_on_ticks / ticks_per_sample
        score_durations = self.decode_token_type(score_ids, "Duration")

        dev_tokens = self._onset_dev_stream(
            tokens, perf_positions - score_positions, score_positions
        )
        dur_tokens = self._perf_duration_stream(perf_durations, score_durations)

        tokens = np.concatenate(
            [
                tokens,
                dev_tokens[:, None] + self.zero_token,
                dur_tokens[:, None] + self.zero_token,
            ],
            axis=1,
        ).astype(np.int64)

        return TokSequence(ids=tokens)

    # ---- decode ----

    def decode_token_type(self, tokens: np.ndarray, token_type: str) -> np.ndarray:
        """(spmuple.py:756-775)"""
        idx = tokens[:, self.types_idx[token_type]] - self.zero_token
        if token_type == "PositionShift":
            return self.position_shifts[idx]
        if token_type == "OnsetDev":
            return idx - self.max_beat_res * 2
        if token_type == "RelOnsetDev":
            return self.rel_onset_deviations[idx]
        if token_type == "PerfDuration":
            return self.vocab.duration_values[idx] * self.max_beat_res
        if token_type == "RelPerfDuration":
            return self.rel_performed_durations[idx]
        return super().decode_token_type(tokens, token_type)

    def score_tokens_to_midi(
        self, tokens: Union[TokSequence, np.ndarray], time_division: int = TIME_DIVISION, **kw
    ) -> MidiScore:
        return self.tokens_to_midi(tokens, time_division=time_division, **kw)

    def decode_note_ticks(
        self,
        tokens: np.ndarray,
        ticks_data: dict,
        ticks_per_sample: float = 1,
        quantize: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Performed note-on/off ticks from performance tokens.

        The deviation/duration math of spmuple.py:411-447, shared by the MIDI
        decoder (``quantize=True``: integer ticks) and the streaming messenger
        (``quantize=False``: fractional ticks at sample resolution).
        """
        ap = self.config.additional_params
        note_on_ticks = ticks_data["note_on"].astype(float) if not quantize else ticks_data["note_on"]
        durations = self.decode_token_type(tokens, "Duration") * ticks_per_sample

        if ap["use_position_shifts"]:
            pos_shifts = self.decode_token_type(tokens, "PositionShift").astype(np.float64)
        else:
            pos_shifts = self.compute_position_shifts(note_on_ticks / ticks_per_sample)

        if ap["rel_onset_dev"]:
            rel_onset_devs = self.decode_token_type(tokens, "RelOnsetDev")
            pos_shifts[pos_shifts == 0] = 1
            onset_devs = rel_onset_devs * pos_shifts * ticks_per_sample
            if quantize:
                onset_devs = onset_devs.astype(int)
        else:
            onset_devs = self.decode_token_type(tokens, "OnsetDev") * ticks_per_sample

        note_on_ticks = np.maximum(0, note_on_ticks + onset_devs)
        if quantize:
            note_on_ticks = note_on_ticks.astype(int)

        if ap["rel_perf_duration"]:
            rel_perf_durations = self.decode_token_type(tokens, "RelPerfDuration")
            perf_durations = rel_perf_durations * durations
        else:
            perf_durations = self.decode_token_type(tokens, "PerfDuration") * ticks_per_sample
        if quantize:
            perf_durations = perf_durations.astype(int)

        return note_on_ticks, note_on_ticks + perf_durations

    def tempo_change_table(
        self, tokens: np.ndarray, note_on_ticks: np.ndarray, ticks_data: dict
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tempo values, anchor ticks) at Tempo-token change points, anchors
        snapped to the beat/bar grid (spmuple.py:452-470); shared by the MIDI
        decoder and the streaming messenger."""
        changes = np.flatnonzero(
            np.r_[True, np.diff(tokens[:, self.types_idx["Tempo"]]) != 0]
        )
        tempos = self.decode_token_type(tokens[changes], "Tempo")
        anchors = self._snap_to_grid(note_on_ticks[changes], self._tempo_grid(ticks_data))
        return tempos, anchors

    def performance_tokens_to_midi(
        self,
        tokens: Union[TokSequence, np.ndarray],
        time_division: int = TIME_DIVISION,
        output_path=None,
    ) -> MidiScore:
        """(spmuple.py:386-511)"""
        ap = self.config.additional_params
        assert time_division % self.max_beat_res == 0
        if isinstance(tokens, TokSequence):
            tokens = tokens.ids
        tokens = np.asarray(tokens)
        ticks_per_sample = time_division // self.max_beat_res

        midi = MidiScore(ticks_per_beat=time_division)
        ticks_data = self.compute_ticks(tokens, time_division, compute_beat_ticks=True)

        pitches = self.decode_token_type(tokens, "Pitch")
        velocities = self.decode_token_type(tokens, "Velocity")

        note_on_ticks, note_off_ticks = self.decode_note_ticks(
            tokens, ticks_data, ticks_per_sample, quantize=True
        )
        note_off_ticks = note_off_ticks.astype(int)

        time_sigs, time_sig_ticks = ticks_data["time_sig"]
        midi.time_sigs = TimeSigMap(
            time_sig_ticks.astype(np.int64), time_sigs[:, 0], time_sigs[:, 1]
        )

        if len(tokens) > 0:
            tempos, tempo_ticks = self.tempo_change_table(tokens, note_on_ticks, ticks_data)
            tempo_ticks = tempo_ticks.copy()
            tempo_ticks[0] = 0
        else:
            tempos, tempo_ticks = np.empty(0), np.array([0])
        midi.tempos = TempoMap(tempo_ticks.astype(np.int64), np.round(tempos, 3))

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
                        start=note_on_ticks[ids].astype(np.int64),
                        end=note_off_ticks[ids].astype(np.int64),
                    ),
                    program=0 if program == -1 else int(program),
                    is_drum=bool(program == -1),
                )
            )

        midi.max_tick = int(note_off_ticks.max()) + 1

        if ap["cut_overlapping_notes"]:
            for track in midi.tracks:
                track.notes = cut_overlapping_notes(track.notes)
            midi.recompute_max_tick()
            keep = midi.tempos.time < midi.max_tick
            midi.tempos = TempoMap(midi.tempos.time[keep], midi.tempos.tempo[keep])

        if output_path:
            from ..midi import write_midi

            write_midi(midi, output_path)
        return midi

    def score_tokens_as_performance(
        self, score_tokens: Union[TokSequence, np.ndarray]
    ) -> TokSequence:
        """Deadpan performance tokens from score tokens (spmuple.py:513-540)."""
        ap = self.config.additional_params
        if isinstance(score_tokens, TokSequence):
            tokens = score_tokens.ids
        else:
            tokens = np.asarray(score_tokens)

        if ap["rel_onset_dev"]:
            zero_onset_token = (
                int(np.where(self.rel_onset_deviations == 0.0)[0][0]) + self.zero_token
            )
        else:
            zero_onset_token = self.max_beat_res * 2 + self.zero_token
        onset_dev_tokens = np.full_like(tokens[:, 0], fill_value=zero_onset_token)

        if ap["rel_perf_duration"]:
            unit = int(np.where(self.rel_performed_durations == 1.0)[0][0]) + self.zero_token
            perf_duration_tokens = np.full_like(tokens[:, 0], fill_value=unit)
        else:
            perf_duration_tokens = tokens[:, self.types_idx["Duration"]]

        out = np.concatenate(
            [tokens, onset_dev_tokens[:, None], perf_duration_tokens[:, None]], axis=1
        ).astype(np.int64)
        return TokSequence(ids=out)

    # ---- value tables ----

    def token_type_values(
        self, token_type: str, normalize: bool = False, special_tokens: bool = True
    ) -> np.ndarray:
        """(spmuple.py:777-813)"""
        onset_cap = self.config.additional_params["max_notes_in_onset"]
        # (raw-table builder, normalizer) per SPMuple-specific stream; other
        # streams defer to the OctupleM tables
        tables = {
            "PositionShift": (
                lambda: self.position_shifts / self.max_beat_res,
                lambda v: np.log2(v + 1),
            ),
            "NotesInOnset": (
                lambda: np.arange(1, onset_cap + 1),
                lambda v: v / onset_cap,
            ),
            "PositionInOnset": (
                lambda: np.arange(1, onset_cap + 1),
                lambda v: v / onset_cap,
            ),
            "OnsetDev": (
                lambda: np.arange(-2 * self.max_beat_res, 2 * self.max_beat_res + 1)
                / self.max_beat_res,
                lambda v: v / v[-1],
            ),
            "RelOnsetDev": (
                lambda: self.rel_onset_deviations,
                lambda v: np.sign(v) * np.log(np.abs(v) + 1),
            ),
            "RelPerfDuration": (
                lambda: self.rel_performed_durations,
                lambda v: np.log(np.abs(v) + 1),
            ),
        }
        entry = tables.get(token_type)
        if entry is None:
            values = super().token_type_values(token_type, normalize, special_tokens=False)
        else:
            build_table, normalizer = entry
            values = build_table()
            if normalize:
                values = normalizer(values)
        if special_tokens:
            values = np.concatenate([np.zeros(self.zero_token), values])
        return values

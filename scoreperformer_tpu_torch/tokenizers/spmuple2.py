# Verbatim copy of scoreperformer_tpu/tokenizers/spmuple2.py; the port imports nothing of the JAX package.
"""SPMuple2: score-performance encoding with smooth local-window tempos.

Counterpart of scoreperformer/data/tokenizers/spmuple/spmuple2.py: onset pairs
(score tick, performance time) drive an iterative weighted local-tempo
estimate over an 8-second window; onset deviations and performed durations are
expressed in seconds relative to tempo-predicted times. The encoding MATH is
the reference's spec and must match bit-for-bit (golden-tested); the encode
STRUCTURE here is this repo's own: notes are grouped per onset in one
vectorized pass (`_group_by_onset`), the inherently sequential part is
isolated into a minimal carry scan (`_tempo_clamp_scan`) that expresses the
reference's mutate-future-arrays outlier clamp (spmuple2.py:242-251) as a
running offset applied lazily, and all per-note quantities are broadcast
vectorized afterwards. A jittable `lax.scan` decode of the same recursion
lives in `scoreperformer_tpu.ops.tokenizer_ops` for the inference path.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np

from ..midi import MidiScore, NoteArray, TempoMap, TimeSigMap, Track
from ..midi.ops import cut_overlapping_notes
from ..midi.sync import sync_performance_midi
from ..midi.timing import tick_to_time_map
from ..utils import find_closest
from .classes import TIME_DIVISION, TokSequence
from .spmuple import SPMuple
from .vocab import DEFAULT_TEMPO


class SPMuple2(SPMuple):
    """(reference spmuple2.py:23-611)"""

    TOKENIZATION_VERSION = 2

    def _tweak_config(self) -> None:
        ap = self.config.additional_params
        ap["rel_onset_dev"] = True
        ap.setdefault("nb_onset_devs", 161)
        ap["rel_perf_duration"] = True
        ap.setdefault("nb_perf_durations", 81)

        super()._tweak_config()

        ap.setdefault("onset_tempos", False)
        ap.setdefault("tempo_window", 8.0)
        ap.setdefault("tempo_min_onset_dist", 0.5)
        ap.setdefault("tempo_min_onsets", 8)
        ap.setdefault("use_quantized_tempos", True)
        ap.setdefault("decode_recompute_tempos", False)
        ap.setdefault("limit_rel_onset_devs", True)

    def _mask_perf_tempo(self) -> bool:
        return True  # tempos are recomputed from the onset pairs (spmuple2.py:150-151)

    def preprocess_midi(self, midi: MidiScore, is_score: bool = True) -> MidiScore:
        """(spmuple2.py:59-92): performance MIDIs keep raw note times AND raw
        tempo changes (needed for the tick→time map)."""
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

        if is_score:
            if self.config.use_tempos:
                self._quantize_tempos(midi)
            if self.config.use_time_signatures:
                self._quantize_time_signatures(midi)
        return midi

    # ---- tempo machinery (spmuple2.py:548-611) ----

    def filter_onsets_in_window(
        self, onset_pair: np.ndarray, onset_pairs: np.ndarray, index: int
    ) -> np.ndarray:
        ap = self.config.additional_params
        onset_time = onset_pair[1]

        candidates = onset_pairs[:index][
            onset_pairs[:index, 1] <= onset_time - ap["tempo_min_onset_dist"]
        ]
        if len(candidates) == 0:
            candidates = onset_pairs[:index]

        pairs = candidates[candidates[:, 1] >= onset_time - ap["tempo_window"]]

        if len(pairs) < ap["tempo_min_onsets"]:
            pairs = candidates[max(0, len(candidates) - ap["tempo_min_onsets"]):]
            pairs = pairs[pairs[:, 1] >= onset_time - 4 * ap["tempo_window"]]

        if len(pairs) == 0:
            pairs = candidates

        return pairs

    def compute_local_tempo(self, distances: np.ndarray, tempo_scale: float) -> float:
        local_tempos = distances[:, 0] / distances[:, 1] * tempo_scale
        weights = 1 - distances[:, 1] / (distances[:, 1].max() + 0.01)
        weights = weights / weights.sum()

        tempo = max(self.vocab.tempos[0], float((weights * local_tempos).sum()))

        if self.config.use_tempos and self.config.additional_params["use_quantized_tempos"]:
            tempo = float(self.vocab.tempos[find_closest(self.vocab.tempos, tempo)])
        return tempo

    def compute_onset_tempo(
        self, onset_pair: np.ndarray, prev_onset_pair: np.ndarray, tempo_scale: float
    ) -> float:
        if onset_pair[1] <= prev_onset_pair[1]:
            tempo = float(self.vocab.tempos[-1])
        else:
            tempo = float(
                (onset_pair[0] - prev_onset_pair[0]) / (onset_pair[1] - prev_onset_pair[1])
            ) * tempo_scale
        if self.config.use_tempos and self.config.additional_params["use_quantized_tempos"]:
            tempo = float(self.vocab.tempos[find_closest(self.vocab.tempos, tempo)])
        return tempo

    # ---- onset grouping + sequential tempo/clamp scan ----

    @staticmethod
    def _group_by_onset(score_ticks: np.ndarray, is_performed: np.ndarray):
        """Group notes by score onset tick.

        Returns (onset_ticks, group_start, note_onset_id):
        - onset_ticks: unique ticks holding at least one performed note;
        - group_start: first note index (over ALL notes) of each onset group;
        - note_onset_id: per-note group id, -1 for notes whose tick has no
          performed note (those inherit tempos by forward fill later).
        Relies on `score_ticks` being nondecreasing (token rows are lexsorted
        by bar/position upstream).
        """
        onset_ticks = np.unique(score_ticks[is_performed])
        group_start = np.searchsorted(score_ticks, onset_ticks, side="left")
        cand = np.minimum(
            np.searchsorted(onset_ticks, score_ticks), len(onset_ticks) - 1
        )
        note_onset_id = np.where(onset_ticks[cand] == score_ticks, cand, -1)
        return onset_ticks, group_start, note_onset_id

    def _initial_tempo(self, pairs: np.ndarray, tempo_scale: float) -> float:
        """Tempo of the opening 4x-window region (spmuple2.py:209-215)."""
        ap = self.config.additional_params
        head = pairs[pairs[:, 1] <= 4 * ap["tempo_window"]]
        if len(head) < ap["tempo_min_onsets"]:
            head = pairs[: ap["tempo_min_onsets"]]
        return self.compute_local_tempo(head[head[:, 1] > 0.0] - head[0], tempo_scale)

    def _tempo_clamp_scan(
        self,
        pairs: np.ndarray,
        grouped_note_times: list,
        initial_tempo: float,
        tempo_scale: float,
    ):
        """Sequential local-tempo estimation with outlier clamping.

        `pairs` is the (K+1, 2) [tick, raw mean time] table including the
        sentinel row 0; `grouped_note_times[k]` holds the raw performed-note
        times of onset k. The reference expresses the outlier clamp by
        mutating every future time array in place (spmuple2.py:242-251); here
        the same effect is a carried running offset, applied lazily: onset k
        sees `raw + offset`, and a clamp raises the offset for everything
        after it. Mutates `pairs[:, 1]` to their final (clamped) values and
        returns (tempos[K+1], cum_offsets[K]) where cum_offsets[k] is the
        offset owed to all notes from group k's first note onward.
        """
        ap = self.config.additional_params
        dev_limit = self.rel_onset_deviations[-1]
        K = len(pairs) - 1

        # native fast path: the same scan in C++ (tokenizers/native.py),
        # bit-identical for quantized-tempo configs — the O(K^2) windowed
        # filtering dominates dataset-prep time (~75% of performance encode)
        quantized = self.config.use_tempos and ap["use_quantized_tempos"]
        if quantized and os.environ.get("SP_NATIVE_SCAN", "1") != "0":
            from .native import native_available, tempo_scan_native

            if native_available():
                return tempo_scan_native(
                    pairs,
                    grouped_note_times,
                    initial_tempo,
                    tempo_scale,
                    limit_devs=bool(ap["limit_rel_onset_devs"]),
                    dev_limit=float(dev_limit),
                    onset_tempos=bool(ap["onset_tempos"]),
                    tempo_window=float(ap["tempo_window"]),
                    min_onset_dist=float(ap["tempo_min_onset_dist"]),
                    min_onsets=int(ap["tempo_min_onsets"]),
                    quantize=True,
                    bins=self.vocab.tempos,
                    min_tempo=float(self.vocab.tempos[0]),
                )

        tempos = np.empty(K + 1)
        tempos[0] = initial_tempo
        cum_offsets = np.zeros(K)
        offset = 0.0

        for k in range(K):
            pairs[k + 1, 1] += offset
            prev_tick, prev_time = pairs[k]
            dt = (pairs[k + 1, 0] - prev_tick) / tempos[k] * tempo_scale

            if ap["limit_rel_onset_devs"]:
                devs = (grouped_note_times[k] + offset) - (prev_time + dt)
                worst_rel = np.abs(devs / dt).max()
                if worst_rel > dev_limit:
                    clamp = (1.0 - dev_limit / worst_rel) * -devs[np.abs(devs).argmax()]
                    pairs[k + 1, 1] += clamp
                    offset += clamp
            cum_offsets[k] = offset

            if ap["onset_tempos"]:
                tempos[k + 1] = self.compute_onset_tempo(pairs[k + 1], pairs[k], tempo_scale)
            elif pairs[k + 1, 1] < 2 * ap["tempo_min_onset_dist"]:
                tempos[k + 1] = initial_tempo
            else:
                in_window = self.filter_onsets_in_window(pairs[k + 1], pairs, index=k + 1)
                tempos[k + 1] = self.compute_local_tempo(pairs[k + 1] - in_window, tempo_scale)

        return tempos, cum_offsets

    # ---- performance encode ----

    def _performance_midi_to_tokens(
        self,
        midi: MidiScore,
        score_tokens: TokSequence,
        alignment: Optional[np.ndarray] = None,
    ) -> TokSequence:
        ap = self.config.additional_params
        time_division = midi.ticks_per_beat
        ticks_per_sample = time_division / self.max_beat_res
        tempo_scale = 60.0 / time_division

        tokens, perf_positions, perf_durations = self._performance_base_rows(midi)
        score_ids = np.asarray(score_tokens.ids)

        if alignment is not None:
            tokens = tokens[alignment]
            perf_positions = perf_positions[alignment]
            perf_durations = perf_durations[alignment]

        # copy score streams (spmuple2.py:165-173)
        token_types = ["Bar", "Position", "Duration", "TimeSig"]
        if ap["use_position_shifts"]:
            token_types.append("PositionShift")
        if ap["use_onset_indices"]:
            token_types.extend(["NotesInOnset", "PositionInOnset"])
        for token_type in token_types:
            idx = self.types_idx[token_type]
            tokens[:, idx] = score_ids[:, idx]

        tokens = tokens.astype(np.int64)

        ticks_data = self.compute_ticks(score_ids, time_division, compute_beat_ticks=False)
        score_ticks = ticks_data["note_on"]
        duration_ticks = self.decode_token_type(score_ids, "Duration") * ticks_per_sample

        # performance note times via the performance's own tempo map
        ttt_map = tick_to_time_map(midi.tempos, midi.max_tick, midi.ticks_per_beat)
        perf_times = ttt_map[(perf_positions * ticks_per_sample).astype(int)]
        perf_offset_times = ttt_map[
            ((perf_positions + perf_durations) * ticks_per_sample).astype(int)
        ]

        num_tokens = len(tokens)
        is_performed = tokens[:, self.types_idx["Velocity"]] != self.zero_token

        # vectorized onset grouping: one row per unique performed onset, with
        # its raw mean performed time (replaces the reference's per-onset
        # masking passes, spmuple2.py:193-206)
        onset_ticks, group_start, note_onset_id = self._group_by_onset(
            score_ticks, is_performed
        )
        K = len(onset_ticks)
        perf_note_group = note_onset_id[is_performed]
        grouped_note_times = np.split(
            perf_times[is_performed],
            np.cumsum(np.bincount(perf_note_group, minlength=K))[:-1],
        )

        pairs = np.zeros((K + 1, 2))
        pairs[1:, 0] = onset_ticks
        pairs[1:, 1] = [g.mean() for g in grouped_note_times]

        initial_tempo = self._initial_tempo(pairs, tempo_scale)
        if pairs[1, 0] == 0:
            # a piece starting at tick 0 gets a synthetic predecessor one tick
            # back at the initial tempo (spmuple2.py:217-219)
            pairs[0] = (-1.0, -1 / initial_tempo * tempo_scale)
        if ap["onset_tempos"]:
            initial_tempo = self.compute_onset_tempo(pairs[1], pairs[0], tempo_scale)

        # sequential part, isolated: local tempos + outlier-clamp offsets
        tempos, cum_offsets = self._tempo_clamp_scan(
            pairs, grouped_note_times, initial_tempo, tempo_scale
        )

        # lazily apply the clamp offsets to per-note times: note n owes the
        # cumulative offset of the last group whose first note is <= n
        owing = np.searchsorted(group_start, np.arange(num_tokens), side="right") - 1
        note_offset = np.where(owing >= 0, cum_offsets[np.maximum(owing, 0)], 0.0)
        perf_times = perf_times + note_offset
        perf_offset_times = perf_offset_times + note_offset

        # broadcast per-onset results to notes; ticks with no performed note
        # (note_onset_id == -1) forward-fill from the previous grouped note
        hit = note_onset_id >= 0
        gid = note_onset_id[hit]
        note_tempos = np.zeros(num_tokens)
        note_next_tempos = np.zeros(num_tokens)
        note_onsets = np.zeros((num_tokens, 2))
        note_prev_onsets = np.zeros((num_tokens, 2))
        note_tempos[hit] = tempos[gid]
        note_next_tempos[hit] = tempos[gid + 1]
        note_prev_onsets[hit] = pairs[gid]
        note_onsets[hit] = pairs[gid + 1]
        ffill = np.maximum.accumulate(np.where(hit, np.arange(num_tokens), 0))
        note_tempos = note_tempos[ffill]
        note_next_tempos = note_next_tempos[ffill]

        if self.config.use_tempos:
            tokens[:, self.types_idx["Tempo"]] = (
                find_closest(self.vocab.tempos, note_tempos) + self.zero_token
            )

        # deviations and durations in seconds against tempo-predicted times
        # (the seconds-domain encoding is the paper's spec, spmuple2.py:291-308);
        # all divisions are masked to performed notes — a leading unperformed
        # run keeps tempo 0 exactly like the reference's forward fill
        has_tempo = note_tempos > 0.0
        predicted_shift = np.zeros(num_tokens)
        np.divide(
            note_onsets[:, 0] - note_prev_onsets[:, 0],
            note_tempos,
            out=predicted_shift,
            where=has_tempo,
        )
        predicted_shift *= tempo_scale
        rel_devs = np.zeros(num_tokens)
        np.divide(
            perf_times - (note_prev_onsets[:, 1] + predicted_shift),
            predicted_shift,
            out=rel_devs,
            where=is_performed,
        )

        score_secs = np.zeros(num_tokens)
        np.divide(duration_ticks, note_tempos, out=score_secs, where=has_tempo)
        score_secs *= tempo_scale
        rel_durs = np.ones(num_tokens)
        np.divide(
            perf_offset_times - perf_times, score_secs, out=rel_durs, where=is_performed
        )

        tokens = np.concatenate(
            [
                tokens,
                (find_closest(self.rel_onset_deviations, rel_devs) + self.zero_token)[:, None],
                (find_closest(self.rel_performed_durations, rel_durs) + self.zero_token)[:, None],
            ],
            axis=1,
        )

        return TokSequence(ids=tokens, meta={"initial_tempo": initial_tempo})

    # ---- decode (spmuple2.py:329-489) ----

    def decode_onset_times(
        self,
        tokens: np.ndarray,
        note_ticks: np.ndarray,
        duration_ticks: np.ndarray,
        tempo_scale: float,
        initial_tempo: float,
        pairs: Optional[np.ndarray] = None,
        tempo_rows: Optional[np.ndarray] = None,
    ):
        """Sequential onset-time reconstruction from performance tokens.

        The single owner of the decode-side tempo recursion, shared by
        `performance_tokens_to_midi` (fresh state over a full sequence) and
        the streaming messenger (state carried across chunks). Semantics of
        reference spmuple2.py:408-476 / messengers.py:246-328:

        - onsets advance a (tick, time) pair chain; each onset's time is the
          tempo-predicted time plus the mean deviation of its performed notes;
        - per-onset tempo is the mean token tempo, or (under
          ``decode_recompute_tempos``) re-estimated from the local window of
          previous pairs;
        - a chunk boundary can split one onset across calls: when the first
          onset of a call repeats the carried chain's last tick, its notes are
          folded into that row by count-weighted averaging, stepping the
          recursion back one onset (the weights follow the reference,
          messengers.py:259-296).

        ``pairs`` rows are (tick, time, note count); ``tempo_rows`` rows are
        (tempo, tick, time), advanced in lockstep one row per onset. Unlike
        the reference, carried arrays are never mutated in place — callers
        that discard the returned state keep a valid carry.

        Returns (note_times, note_end_times, pairs, tempo_rows).
        """
        ap = self.config.additional_params
        recompute = ap["decode_recompute_tempos"] and not ap["onset_tempos"]

        is_performed = tokens[:, self.types_idx["Velocity"]] != self.zero_token
        token_tempos = self.decode_token_type(tokens, "Tempo")
        rel_devs = self.decode_token_type(tokens, "RelOnsetDev")
        rel_durs = self.decode_token_type(tokens, "RelPerfDuration")

        if tempo_rows is None:
            tempo_rows = np.array([[initial_tempo, 0.0, 0.0]])
        else:
            tempo_rows = tempo_rows.copy()
        if pairs is None:
            if note_ticks[0] > 0:
                pairs = np.array([[0.0, 0.0, 1.0]])
            else:
                # a piece starting at tick 0 anchors on a synthetic
                # predecessor one tick back at the carried tempo
                pairs = np.array([[-1.0, -1.0 / tempo_rows[-1, 0] * tempo_scale, 1.0]])
        else:
            pairs = pairs.copy()

        note_times = np.zeros(len(note_ticks))
        note_end_times = np.zeros(len(note_ticks))

        for tick in np.unique(note_ticks[is_performed]):
            in_onset = note_ticks == tick
            n_notes = int(in_onset.sum())
            merge = tick > 0 and tick == tempo_rows[-1, 1]
            back = 2 if merge else 1
            prev_tick, prev_time, prev_n = pairs[-back]
            tempo = tempo_rows[-back, 0]

            if not recompute:
                seen = token_tempos[in_onset]
                tempo = (
                    (tempo * prev_n + seen.sum()) / (prev_n + n_notes)
                    if merge
                    else seen.mean()
                )

            shift = (tick - prev_tick) / tempo * tempo_scale
            onset_note_times = prev_time + shift + rel_devs[in_onset] * shift
            performed_times = onset_note_times[is_performed[in_onset]]
            if merge:
                onset_time = (pairs[-1, 1] * prev_n + performed_times.sum()) / (
                    prev_n + n_notes
                )
                pairs[-1] = (tick, onset_time, prev_n + n_notes)
            else:
                onset_time = performed_times.mean()
                pairs = np.vstack([pairs, [tick, onset_time, float(n_notes)]])

            note_times[in_onset] = onset_note_times
            note_end_times[in_onset] = (
                onset_note_times
                + rel_durs[in_onset] * duration_ticks[in_onset] / tempo * tempo_scale
            )

            if recompute:
                if onset_time < 2 * ap["tempo_min_onset_dist"]:
                    tempo = initial_tempo
                else:
                    window = self.filter_onsets_in_window(
                        pairs[-1, :2], pairs[:-1, :2], index=len(pairs) - 1
                    )
                    tempo = self.compute_local_tempo(pairs[-1, :2] - window, tempo_scale)

            row = [tempo, tick, onset_time]
            if merge:
                tempo_rows = np.vstack([tempo_rows[:-1], row])
            else:
                tempo_rows = np.vstack([tempo_rows, row])

        return note_times, note_end_times, pairs, tempo_rows

    def performance_tokens_to_midi(
        self,
        tokens: Union[TokSequence, np.ndarray],
        time_division: int = TIME_DIVISION,
        output_path=None,
        initial_tempo: Optional[float] = None,
    ) -> MidiScore:
        ap = self.config.additional_params
        assert time_division % self.max_beat_res == 0
        ticks_per_sample = time_division // self.max_beat_res
        tempo_scale = 60.0 / time_division

        if isinstance(tokens, TokSequence):
            initial_tempo = tokens.meta.get("initial_tempo", initial_tempo)
            tokens = tokens.ids
        tokens = np.asarray(tokens)

        midi = MidiScore(ticks_per_beat=time_division)

        ticks_data = self.compute_ticks(tokens, time_division, compute_beat_ticks=False)
        score_ticks = ticks_data["note_on"]

        duration_ticks = self.decode_token_type(tokens, "Duration") * ticks_per_sample

        time_sigs, time_sig_ticks = ticks_data["time_sig"]
        midi.time_sigs = TimeSigMap(
            time_sig_ticks.astype(np.int64), time_sigs[:, 0], time_sigs[:, 1]
        )

        is_performed = tokens[:, self.types_idx["Velocity"]] != self.zero_token

        # seed the recursion: first-onset mean token tempo, or the provided
        # initial tempo when tempos are re-estimated during decode
        recompute = ap["decode_recompute_tempos"] and not ap["onset_tempos"]
        if not recompute:
            first_onset = np.min(score_ticks[is_performed])
            seed_tempo = float(
                self.decode_token_type(tokens, "Tempo")[score_ticks == first_onset].mean()
            )
        else:
            seed_tempo = initial_tempo or DEFAULT_TEMPO

        perf_times, perf_offset_times, pairs, _ = self.decode_onset_times(
            tokens,
            score_ticks,
            duration_ticks,
            tempo_scale,
            initial_tempo=seed_tempo,
        )
        onset_pairs = pairs[:, :2]

        pitches = self.decode_token_type(tokens, "Pitch")
        velocities = self.decode_token_type(tokens, "Velocity")

        max_tick = int((score_ticks + duration_ticks)[is_performed].max())
        max_time = float(perf_offset_times.max())

        perf_ids = np.where(is_performed)[0]
        midi.tracks.append(
            Track(
                notes=NoteArray(
                    pitch=pitches[perf_ids].astype(np.int32),
                    velocity=velocities[perf_ids].astype(np.int32),
                    start=perf_times[perf_ids],
                    end=perf_offset_times[perf_ids],
                ),
                program=0,
            )
        )
        midi.max_tick = max_tick

        midi = sync_performance_midi(
            score_midi=midi,
            perf_midi=midi,
            onset_pairs=onset_pairs,
            is_absolute_timing=True,
            max_time=max_time,
            bar_sync=False,
            inplace=True,
        )

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

# Verbatim copy of scoreperformer_tpu/midi/sync.py; the port imports nothing of the JAX package.
"""Performance↔score grid synchronization.

Counterpart of scoreperformer/data/midi/sync.py:16-151: resample a performance
MIDI so that its bars/beats land on the score grid, re-deriving per-interval
tempi from the onset pairs. Operates on SoA containers; the note resampling is
fully vectorized.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils import find_closest
from .beats import get_bar_beat_ticks, get_inter_beat_interval, get_performance_beats
from .containers import Marker, MidiScore, NoteArray, TempoMap, TimeSigMap, Track
from .ops import filter_late_events
from .timing import notes_to_absolute_timing, notes_to_symbolic_timing, score_tick_to_time_map


def _sync_unit_spans(
    time_sigs: TimeSigMap, score_tpb: int, bar_sync: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per time-signature span of one sync unit (a bar if ``bar_sync`` else a
    beat): its length in score ticks and in quarter notes.

    Returns ``(sig_start_ticks, span_ticks, span_quarters)``, each of length
    ``len(time_sigs)``.
    """
    n = len(time_sigs)
    span_ticks = np.empty(n, dtype=np.float64)
    span_quarters = np.empty(n, dtype=np.float64)
    for i in range(n):
        num, den = int(time_sigs.numerator[i]), int(time_sigs.denominator[i])
        quarters_per_bar = 4.0 * num / den
        bar_ticks = int(score_tpb * quarters_per_bar)
        beat_ticks = get_inter_beat_interval(num, den, ticks_per_beat=score_tpb)
        beats_per_bar = bar_ticks / beat_ticks
        beat_quarters = quarters_per_bar / beats_per_bar
        if bar_sync:
            span_ticks[i] = beat_ticks * beats_per_bar
            span_quarters[i] = beat_quarters * beats_per_bar
        else:
            span_ticks[i] = beat_ticks
            span_quarters[i] = beat_quarters
    return time_sigs.time.astype(np.float64), span_ticks, span_quarters


def sync_performance_midi(
    score_midi: MidiScore,
    perf_midi: MidiScore,
    onset_pairs: np.ndarray,
    *,
    bar_sync: bool = True,
    is_absolute_timing: bool = False,
    max_time: "float | None" = None,
    inplace: bool = True,
    ticks_per_beat: int = 480,
) -> "MidiScore | None":
    """Synchronize ``perf_midi`` with ``score_midi`` bars/beats through onset
    pairs. Returns a new :class:`MidiScore` at ``ticks_per_beat`` resolution,
    or ``None`` when the onset intervals are non-monotonic."""
    perf_midi = perf_midi if inplace else perf_midi.copy()

    filter_late_events(perf_midi)

    if is_absolute_timing:
        if max_time is None:
            raise ValueError("absolute-timing MIDI needs an explicit `max_time`")
        tick_to_time = None
    else:
        tick_to_time = score_tick_to_time_map(perf_midi)
        max_time = float(tick_to_time[-1])

    # align score bar/beat ticks with performance wall-clock times
    bar_grid, beat_grid = get_bar_beat_ticks(score_midi)
    grid_onsets, onset_times = get_performance_beats(
        bar_grid if bar_sync else beat_grid,
        onset_pairs,
        monotonic_times=True,
        ticks_per_beat=ticks_per_beat,
        max_tick=score_midi.max_tick - 1,
        max_time=max_time,
    )

    # rebase wall-clock so the first synced onset is t=0
    time_origin = onset_times[0]
    onset_times = onset_times - time_origin
    max_time = max_time - time_origin

    onset_gaps_sec = np.diff(onset_times)
    if (onset_gaps_sec <= 0.0).any():
        return None

    # per-gap sync-unit spans, looked up through the active time signature
    sig_ticks, span_ticks, span_quarters = _sync_unit_spans(
        score_midi.time_sigs, score_midi.ticks_per_beat, bar_sync
    )
    gap_sig = (np.searchsorted(sig_ticks, grid_onsets, side="right") - 1)[:-1]
    # fraction of a full sync unit each score gap covers (e.g. pickup bars < 1)
    gap_scale = np.diff(grid_onsets) / span_ticks[gap_sig]
    bpm = 60.0 / onset_gaps_sec * span_quarters[gap_sig] * gap_scale

    # absolute (wall-clock) note timing of all tracks
    abs_tracks = []
    for track in perf_midi.tracks:
        if is_absolute_timing:
            abs_notes = NoteArray(
                track.notes.pitch,
                track.notes.velocity,
                np.asarray(track.notes.start, np.float64),
                np.asarray(track.notes.end, np.float64),
            )
        else:
            abs_notes = notes_to_absolute_timing(track.notes, tick_to_time, -time_origin)
        abs_tracks.append((track, abs_notes))

    # new tick grid: each onset gap divided uniformly into its target tick count
    tick_scale = ticks_per_beat / score_midi.ticks_per_beat
    gap_tick_counts = span_ticks[gap_sig] * tick_scale * gap_scale
    segments = [
        np.linspace(lo, hi, num=int(n_ticks) + 1)[:-1]
        for lo, hi, n_ticks in zip(onset_times[:-1], onset_times[1:], gap_tick_counts)
    ]
    segments.append(np.asarray([max_time]))
    grid_times = np.concatenate(segments).round(6)

    synced = MidiScore(ticks_per_beat=ticks_per_beat)

    # wall-clock → symbolic on the new grid
    for track, abs_notes in abs_tracks:
        synced.tracks.append(
            Track(
                notes=notes_to_symbolic_timing(abs_notes, grid_times),
                program=track.program,
                is_drum=track.is_drum,
                name=track.name,
            )
        )

    # markers: re-grid marker times (only meaningful with symbolic input)
    markers = []
    if tick_to_time is not None:

        def _regrid(tick: int) -> int:
            return int(find_closest(grid_times, float(tick_to_time[tick]) - time_origin))

        for marker in perf_midi.markers:
            text = marker.text
            if text.startswith("NoteI"):
                fields = [int(f) for f in text.split("_")[1:]]
                text = f"NoteI_{fields[0]}_{_regrid(fields[1])}_{_regrid(fields[2])}"
            markers.append(Marker(_regrid(marker.time), text))

    # tempo changes pinned to the grid ticks of the synced onsets
    onset_grid_ticks = find_closest(grid_times, onset_times)[:-1]
    in_range = onset_grid_ticks < grid_times.shape[0]
    synced.tempos = TempoMap(onset_grid_ticks[in_range], bpm[in_range])

    markers = [Marker(0, f"Shift_{time_origin:.6f}")] + markers

    synced.time_sigs = score_midi.time_sigs.copy()
    synced.markers = markers
    synced.max_tick = grid_times.shape[0]

    return synced

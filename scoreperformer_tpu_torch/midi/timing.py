# Verbatim copy of scoreperformer_tpu/midi/timing.py; the port imports nothing of the JAX package.
"""Tick ↔ time conversion (vectorized).

Counterpart of miditoolkit's ``get_tick_to_time_mapping`` and the reference's
scoreperformer/data/midi/timing.py:11-67, on SoA containers.
"""
from __future__ import annotations

import numpy as np

from ..utils import find_closest
from .containers import MidiScore, NoteArray, TempoMap


def tick_to_time_map(tempos: TempoMap, max_tick: int, ticks_per_beat: int) -> np.ndarray:
    """Seconds at every tick in ``[0, max_tick]`` (length ``max_tick + 1``)."""
    max_tick = int(max_tick)
    change_ticks = np.asarray(tempos.time, dtype=np.int64)
    bpm = np.asarray(tempos.tempo, dtype=np.float64)
    if len(change_ticks) == 0 or change_ticks[0] != 0:
        change_ticks = np.concatenate([[0], change_ticks])
        bpm = np.concatenate([[120.0], bpm])
    seconds_per_tick = 60.0 / (bpm * ticks_per_beat)

    # cumulative time at each tempo-change boundary
    boundary_times = np.zeros(len(change_ticks))
    if len(change_ticks) > 1:
        segment_durations = np.diff(change_ticks) * seconds_per_tick[:-1]
        boundary_times[1:] = np.cumsum(segment_durations)

    ticks = np.arange(max_tick + 1, dtype=np.int64)
    seg = np.maximum(0, np.searchsorted(change_ticks, ticks, side="right") - 1)
    return boundary_times[seg] + (ticks - change_ticks[seg]) * seconds_per_tick[seg]


def ticks_to_times(ticks, tempos: TempoMap, ticks_per_beat: int) -> np.ndarray:
    """Seconds for arbitrary tick values without materializing a full map."""
    ticks = np.asarray(ticks)
    change_ticks = np.asarray(tempos.time, dtype=np.int64)
    bpm = np.asarray(tempos.tempo, dtype=np.float64)
    if len(change_ticks) == 0 or change_ticks[0] != 0:
        change_ticks = np.concatenate([[0], change_ticks])
        bpm = np.concatenate([[120.0], bpm])
    seconds_per_tick = 60.0 / (bpm * ticks_per_beat)
    boundary_times = np.zeros(len(change_ticks))
    if len(change_ticks) > 1:
        boundary_times[1:] = np.cumsum(np.diff(change_ticks) * seconds_per_tick[:-1])
    seg = np.maximum(0, np.searchsorted(change_ticks, ticks, side="right") - 1)
    return boundary_times[seg] + (ticks - change_ticks[seg]) * seconds_per_tick[seg]


def notes_to_absolute_timing(
    notes: NoteArray, tick_to_time: np.ndarray, time_shift: float = 0.0
) -> NoteArray:
    """Symbolic (tick) → absolute (seconds) note timing
    (timing.py:11-33 equivalent, vectorized)."""
    starts = tick_to_time[np.asarray(notes.start, dtype=np.int64)] + time_shift
    ends = tick_to_time[np.asarray(notes.end, dtype=np.int64)] + time_shift
    return NoteArray(notes.pitch.copy(), notes.velocity.copy(), starts, ends)


def notes_to_symbolic_timing(notes: NoteArray, time_to_tick: np.ndarray) -> NoteArray:
    """Absolute (seconds) → symbolic (tick) note timing via nearest resampled
    grid point (timing.py:36-67 equivalent). Zero-length results get 1 tick."""
    start_ticks = find_closest(time_to_tick, np.asarray(notes.start, dtype=np.float64))
    end_ticks = find_closest(time_to_tick, np.asarray(notes.end, dtype=np.float64))
    end_ticks = np.where(start_ticks == end_ticks, end_ticks + 1, end_ticks)
    return NoteArray(
        notes.pitch.copy(),
        notes.velocity.copy(),
        start_ticks.astype(np.int64),
        end_ticks.astype(np.int64),
    )


def score_tick_to_time_map(score: MidiScore, extra_ticks: int = 0) -> np.ndarray:
    return tick_to_time_map(score.tempos, score.max_tick + extra_ticks, score.ticks_per_beat)

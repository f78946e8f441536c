# Verbatim copy of scoreperformer_tpu/midi/beats.py; the port imports nothing of the JAX package.
"""Bar/beat grid computation (counterpart of scoreperformer/data/midi/beats.py)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .containers import MidiScore, TimeSigMap

# Compound meters group their numerator into dotted beats: every 3 eighth
# (or sixteenth) notes form one felt beat, so e.g. 6/8 has 2 beats and 12/8
# has 4. Simple meters (anything not listed) count the numerator directly.
# (behavioral counterpart of reference beats.py:6-12)
COMPOUND_METER_BEATS = {num: num // 3 for num in (6, 9, 12, 18, 24)}


def get_ticks_per_bar(numerator: int, denominator: int, ticks_per_beat: int = 480) -> int:
    return ticks_per_beat * 4 * numerator // denominator


def get_inter_beat_interval(
    numerator: int,
    denominator: int,
    ticks_per_bar: "int | None" = None,
    ticks_per_beat: int = 480,
) -> int:
    bar_len = (
        get_ticks_per_bar(numerator, denominator, ticks_per_beat)
        if ticks_per_bar is None
        else ticks_per_bar
    )
    num_beats_in_bar = COMPOUND_METER_BEATS.get(int(numerator), int(numerator))
    return int(bar_len / num_beats_in_bar)


def get_bar_beat_ticks(
    midi: "MidiScore | None" = None,
    *,
    time_sigs: "TimeSigMap | None" = None,
    ticks_per_beat: "int | None" = None,
    max_tick: "int | None" = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tick positions of every bar line and beat (beats.py:34-65)."""
    if midi is not None:
        time_sigs, ticks_per_beat = midi.time_sigs, midi.ticks_per_beat
        max_tick = int(midi.max_tick) - 1

    bar_runs = []
    beat_runs = []
    n = len(time_sigs)
    for i in range(n):
        last_tick = int(time_sigs.time[i + 1]) if i < n - 1 else int(max_tick)
        num = int(time_sigs.numerator[i])
        den = int(time_sigs.denominator[i])
        start = int(time_sigs.time[i])
        ticks_per_bar = get_ticks_per_bar(num, den, ticks_per_beat)
        bar_runs.append(np.arange(start, last_tick, ticks_per_bar))
        ibi = get_inter_beat_interval(num, den, ticks_per_bar, ticks_per_beat)
        beat_runs.append(np.arange(start, last_tick, ibi))

    return np.concatenate(bar_runs), np.concatenate(beat_runs)


def get_performance_beats(
    score_beats: np.ndarray,
    position_pairs: np.ndarray,
    *,
    monotonic_times: bool = False,
    max_tick: "int | None" = None,
    max_time: "float | None" = None,
    ticks_per_beat: int = 480,
) -> Tuple[np.ndarray, np.ndarray]:
    """Map score beat ticks to performance times by interpolating onset pairs
    (beats.py:68-119). ``position_pairs`` is an (N, 2) array of
    (score_tick, perf_time)."""
    position_pairs = np.asarray(position_pairs, dtype=np.float64)

    if monotonic_times:
        # Keep only pairs that advance both tick and time relative to their
        # input predecessor, AND whose implied tempo relative to the last
        # *kept* pair stays under 600 BPM (time must grow by at least
        # tick_delta / ticks_per_beat / 10 seconds).
        ticks = position_pairs[:, 0]
        times = position_pairs[:, 1]
        kept = [0]
        for j in range(1, len(position_pairs)):
            if ticks[j] == ticks[j - 1] or times[j] <= times[j - 1]:
                continue
            anchor = kept[-1]
            time_floor = times[anchor] + (ticks[j] - ticks[anchor]) / (10.0 * ticks_per_beat)
            if times[j] > time_floor:
                kept.append(j)
        position_pairs = position_pairs[np.asarray(kept)]

    score_beats = np.asarray(score_beats, dtype=np.float64)
    close_end = not (max_tick is None or max_time is None)
    if close_end:
        # anchor the interpolation grid (and the beat list) at the piece end
        end_pair = np.array([[max_tick, max_time]], dtype=np.float64)
        position_pairs = np.vstack([position_pairs, end_pair])
        score_beats = np.append(score_beats, float(max_tick))

    pair_ticks = position_pairs[:, 0]
    pair_times = position_pairs[:, 1]
    idx = np.searchsorted(pair_ticks, score_beats).clip(max=pair_ticks.shape[0] - 1)

    exact = pair_ticks[idx] == score_beats
    # interpolation indices: shift to 1 where idx==0 or first beat
    interp_idx = idx.copy()
    interp_idx[(np.arange(len(score_beats)) == 0) | (interp_idx == 0)] += 1
    interp_idx = interp_idx.clip(max=pair_ticks.shape[0] - 1)

    lo_tick, hi_tick = pair_ticks[interp_idx - 1], pair_ticks[interp_idx]
    lo_time, hi_time = pair_times[interp_idx - 1], pair_times[interp_idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = (score_beats - lo_tick) / (hi_tick - lo_tick)
        interp = lo_time + frac * (hi_time - lo_time)
    perf_beats = np.where(exact, pair_times[idx], interp)

    if close_end and len(score_beats) >= 2 and score_beats[-1] == score_beats[-2]:
        # the appended end anchor duplicated the final beat — drop it again
        score_beats, perf_beats = score_beats[:-1], perf_beats[:-1]

    return score_beats, perf_beats

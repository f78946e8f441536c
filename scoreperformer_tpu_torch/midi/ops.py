# Verbatim copy of scoreperformer_tpu/midi/ops.py; the port imports nothing of the JAX package.
"""Vectorized note-array operations.

Counterparts of the reference's list-of-Note loops
(scoreperformer/data/midi/utils.py, quantization.py), re-written as numpy
array transforms over :class:`NoteArray`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .containers import MidiScore, NoteArray


def cut_overlapping_notes(notes: NoteArray) -> NoteArray:
    """Cut the first of two same-pitch overlapping notes (utils.py:31-56).

    Returns time-sorted notes; the pairwise rules match the reference:
    for consecutive same-pitch notes with prev.end >= cur.start,
    cur.start <= 1 is bumped to 2, prev.end = cur.start - 1, and a
    now-invalid prev gets start = end - 1.
    """
    if len(notes) < 2:
        return notes.sort("time")
    n = notes.sort("pitch").copy()
    start, end, pitch = n.start, n.end, n.pitch

    same = pitch[1:] == pitch[:-1]
    overlap = same & (end[:-1] >= start[1:])
    # bump very-early starts of the later note
    bump = overlap & (start[1:] <= 1)
    start[1:][bump] = 2
    # cut the earlier note
    end[:-1][overlap] = start[1:][overlap] - 1
    # fix earlier notes that became invalid
    invalid = np.zeros(len(n), dtype=bool)
    invalid[:-1] = overlap & (start[:-1] >= end[:-1])
    start[invalid] = end[invalid] - 1

    return n.sort("time")


def remove_duplicated_notes(notes: NoteArray) -> NoteArray:
    """Keep the shortest of exactly-duplicated (pitch, start) notes
    (utils.py:59-79)."""
    if len(notes) < 2:
        return notes.sort("time")
    n = notes.sort("pitch")
    dup = np.zeros(len(n), dtype=bool)
    dup[1:] = (n.pitch[1:] == n.pitch[:-1]) & (n.start[1:] == n.start[:-1]) & (
        n.end[1:] >= n.end[:-1]
    )
    return n[~dup].sort("time")


def remove_short_notes(
    notes: NoteArray, time_division: int, max_beat_res: int = 32
) -> NoteArray:
    """Drop notes shorter than half a sample (utils.py:82-96). The first note
    is always kept (the reference loop never visits index 0)."""
    ticks_per_sample = int(time_division / max_beat_res)
    keep = (notes.end - notes.start) >= (ticks_per_sample // 2)
    if len(keep):
        keep[0] = True
    return notes[keep]


def quantize_note_times(
    notes: NoteArray,
    time_division: int,
    max_beat_res: int = 32,
    max_duration_ticks: Optional[int] = None,
) -> NoteArray:
    """Snap note starts/ends to the sample grid, round-half-down
    (reference spmuple.py:542-589 / quantization.py:6-40 semantics).

    Offsets <= half a sample round down, otherwise up. Durations longer than
    ``max_duration_ticks`` are clipped (end unquantized beyond the clip);
    zero-length results get one sample.
    """
    ticks_per_sample = int(time_division / max_beat_res)
    n = notes.copy()
    start, end = n.start, n.end

    start_offset = start % ticks_per_sample
    start = start + np.where(
        start_offset <= ticks_per_sample / 2, -start_offset, ticks_per_sample - start_offset
    )

    if max_duration_ticks is not None:
        too_long = (end - start) > max_duration_ticks
    else:
        too_long = np.zeros(len(n), dtype=bool)

    end_offset = end % ticks_per_sample
    quant_end = end + np.where(
        end_offset <= ticks_per_sample / 2, -end_offset, ticks_per_sample - end_offset
    )
    quant_end = np.where(quant_end == start, quant_end + ticks_per_sample, quant_end)
    end = np.where(too_long, start + (max_duration_ticks or 0), quant_end)

    n.start, n.end = start.astype(notes.start.dtype), end.astype(notes.end.dtype)
    return n


def filter_pitch_range(notes: NoteArray, pitch_range: Tuple[int, int]) -> NoteArray:
    keep = (notes.pitch >= pitch_range[0]) & (notes.pitch < pitch_range[1])
    return notes[keep]


def quantize_tempo_times(
    times: np.ndarray, tempos: np.ndarray, time_division: int, max_beat_res: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize tempo-change times to the sample grid and drop successive
    equal tempos (quantization.py:43-64). Returns (times, tempos)."""
    keep = np.ones(len(times), dtype=bool)
    keep[1:] = tempos[1:] != tempos[:-1]
    times, tempos = times[keep], tempos[keep]
    ticks_per_sample = int(time_division / max_beat_res)
    rest = times % ticks_per_sample
    times = times + np.where(rest <= ticks_per_sample / 2, -rest, ticks_per_sample - rest)
    return times, tempos


def quantize_key_signature_times(
    key_sigs: List[Tuple[int, str]], time_division: int, max_beat_res: int = 32
) -> List[Tuple[int, str]]:
    """Quantize key-signature change times to the sample grid and drop
    successive identical keys (quantization.py:120-141)."""
    ticks_per_sample = int(time_division / max_beat_res)
    out: List[Tuple[int, str]] = []
    prev_key = None
    for tick, key in key_sigs:
        if key == prev_key:
            continue
        rest = tick % ticks_per_sample
        tick += -rest if rest <= ticks_per_sample / 2 else ticks_per_sample - rest
        out.append((int(tick), key))
        prev_key = key
    return out


def quantize_time_signature_times(
    times: np.ndarray, numerators: np.ndarray, denominators: np.ndarray, time_division: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Move time-signature changes to bar lines, dedup (quantization.py:78-124).

    Sequential by nature (each bar grid depends on the previous change) but
    the number of changes is tiny, so the scalar loop is fine.
    """
    times = list(int(t) for t in times)
    sigs = list(zip((int(x) for x in numerators), (int(x) for x in denominators)))

    all_different = False
    while not all_different:
        all_different = True
        # dedup neighbours with same value or same time
        i = 1
        while i < len(times):
            if sigs[i] == sigs[i - 1] or times[i] == times[i - 1]:
                del times[i], sigs[i]
                all_different = False
                continue
            i += 1
        # snap each change to the next bar line of the previous signature
        ticks_per_bar = int(time_division * 4 * sigs[0][0] / sigs[0][1])
        previous_tick = 0
        for i in range(1, len(times)):
            bar_offset, rest = divmod(times[i] - previous_tick, ticks_per_bar)
            if rest > 0:
                bar_offset += 1
                times[i] = previous_tick + bar_offset * ticks_per_bar
            ticks_per_bar = int(time_division * 4 * sigs[i][0] / sigs[i][1])
            previous_tick = times[i]

    return (
        np.array(times, np.int64),
        np.array([s[0] for s in sigs], np.int64),
        np.array([s[1] for s in sigs], np.int64),
    )


def derive_sustain_pedals(control_changes: np.ndarray) -> np.ndarray:
    """Sustain-pedal intervals from CC64 runs.

    A pedal starts at the first CC64 with value >= 64 while the pedal is up
    and ends at the next CC64 with value < 64 (an unterminated press ends at
    the last CC time). This is the interval model the reference's Track
    objects carry as first-class ``pedals``. Returns (N, 2) [start, end].
    """
    if len(control_changes) == 0:
        return np.empty((0, 2), np.int64)
    cc64 = control_changes[control_changes[:, 1] == 64]
    if len(cc64) == 0:
        return np.empty((0, 2), np.int64)
    cc64 = cc64[np.argsort(cc64[:, 0], kind="stable")]
    down = cc64[:, 2] >= 64
    # state transitions: a press is a down event whose previous state was up
    prev_down = np.r_[False, down[:-1]]
    starts = cc64[down & ~prev_down, 0]
    ends = cc64[~down & prev_down, 0]
    if len(starts) > len(ends):
        ends = np.r_[ends, cc64[-1, 0]]
    pedals = np.stack([starts, ends[: len(starts)]], axis=1).astype(np.int64)
    return pedals[pedals[:, 1] > pedals[:, 0]]


def _snap_to_sample(times: np.ndarray, ticks_per_sample: int) -> np.ndarray:
    """Nearest-sample rounding with ties toward the earlier sample (the
    reference tokenizer's pedal/bend quantization rule)."""
    offset = times % ticks_per_sample
    up = offset > ticks_per_sample / 2
    return times - offset + np.where(up, ticks_per_sample, 0)


def quantize_sustain_pedals(pedals: np.ndarray, ticks_per_sample: int) -> np.ndarray:
    """Snap pedal on/off times to the sample grid; presses that collapse to
    zero length keep one sample (reference midi_tokenizer.py:45-48 hook,
    tokenizer-base semantics)."""
    if len(pedals) == 0:
        return pedals
    start = _snap_to_sample(pedals[:, 0], ticks_per_sample)
    end = _snap_to_sample(pedals[:, 1], ticks_per_sample)
    end = np.where(end == start, end + ticks_per_sample, end)
    return np.stack([start, end], axis=1).astype(np.int64)


def quantize_pitch_bends(pitch_bends: np.ndarray, ticks_per_sample: int) -> np.ndarray:
    """Snap bend times to the sample grid; of several bends landing on one
    sample keep the largest-magnitude one, later events winning ties
    (reference midi_tokenizer.py:49-52 hook, tokenizer-base semantics)."""
    if len(pitch_bends) == 0:
        return pitch_bends
    times = _snap_to_sample(pitch_bends[:, 0], ticks_per_sample)
    values = pitch_bends[:, 1]
    # rank within each snapped time by (|value|, original order); keep the top
    order = np.lexsort((np.arange(len(times)), np.abs(values), times))
    times, values = times[order], values[order]
    keep = np.r_[np.diff(times) != 0, True]
    return np.stack([times[keep], values[keep]], axis=1).astype(np.int64)


def filter_late_events(midi: MidiScore, max_tick: Optional[int] = None) -> MidiScore:
    """Drop control changes / pedals / pitch bends past ``max_tick``
    (utils.py:99-124)."""
    max_tick = max_tick or midi.max_tick
    for track in midi.tracks:
        if len(track.control_changes):
            track.control_changes = track.control_changes[
                track.control_changes[:, 0] <= max_tick
            ]
        if len(track.pedals):
            track.pedals = track.pedals[track.pedals[:, 1] <= max_tick]
        if len(track.pitch_bends):
            track.pitch_bends = track.pitch_bends[track.pitch_bends[:, 0] <= max_tick]
    return midi


def resample_midi(midi: MidiScore, ticks_per_beat: int, inplace: bool = True) -> MidiScore:
    """Rescale all tick values to a new resolution (utils.py:180-212)."""
    if midi.ticks_per_beat == ticks_per_beat:
        return midi
    midi = midi if inplace else midi.copy()
    scale = ticks_per_beat / midi.ticks_per_beat
    for track in midi.tracks:
        track.notes.start = (scale * track.notes.start).astype(np.int64)
        track.notes.end = (scale * track.notes.end).astype(np.int64)
        if len(track.control_changes):
            track.control_changes[:, 0] = (scale * track.control_changes[:, 0]).astype(np.int64)
        if len(track.pitch_bends):
            track.pitch_bends[:, 0] = (scale * track.pitch_bends[:, 0]).astype(np.int64)
        if len(track.pedals):
            track.pedals = (scale * track.pedals).astype(np.int64)
    midi.tempos.time = (scale * midi.tempos.time).astype(np.int64)
    midi.time_sigs.time = (scale * midi.time_sigs.time).astype(np.int64)
    midi.key_sigs = [(int(scale * t), k) for t, k in midi.key_sigs]
    for marker in midi.markers:
        marker.time = int(scale * marker.time)
    midi.ticks_per_beat = ticks_per_beat
    midi.recompute_max_tick()
    midi.max_tick += 1
    return midi


def shift_midi_notes(
    midi: MidiScore,
    time_shift: float = 0.0,
    offset: float = 0.0,
    inplace: bool = True,
) -> MidiScore:
    """Shift notes (and control changes) later than `offset` seconds by
    `time_shift` seconds, re-snapping to the tick grid (utils.py:127-177)."""
    from ..utils import find_closest
    from .timing import tick_to_time_map

    midi = midi if inplace else midi.copy()
    ttt = tick_to_time_map(midi.tempos, midi.max_tick * 4, midi.ticks_per_beat)

    for track in midi.tracks:
        notes = track.notes
        start_times = ttt[np.clip(notes.start, 0, len(ttt) - 1)]
        end_times = ttt[np.clip(notes.end, 0, len(ttt) - 1)]
        new_start = find_closest(ttt, start_times + time_shift)
        new_end = find_closest(ttt, end_times + time_shift)
        new_end = np.where(new_start == new_end, new_end + 1, new_end)
        apply = start_times >= offset
        notes.start = np.where(apply, new_start, notes.start).astype(np.int64)
        notes.end = np.where(apply, new_end, notes.end).astype(np.int64)
        if len(track.control_changes):
            cc = track.control_changes
            times = ttt[np.clip(cc[:, 0], 0, len(ttt) - 1)]
            new_ticks = find_closest(ttt, times + time_shift)
            cc[:, 0] = np.where(times >= offset, new_ticks, cc[:, 0])

    midi.recompute_max_tick()
    midi.max_tick += 1
    return midi


def merge_tracks(midi: MidiScore) -> MidiScore:
    """Merge all tracks into one (preprocess.py single-track path)."""
    if len(midi.tracks) <= 1:
        return midi
    notes = midi.tracks[0].notes
    ccs = [midi.tracks[0].control_changes]
    pbs = [midi.tracks[0].pitch_bends]
    for track in midi.tracks[1:]:
        notes = notes.concat(track.notes)
        ccs.append(track.control_changes)
        pbs.append(track.pitch_bends)
    first = midi.tracks[0]
    first.notes = notes.sort("time")
    first.control_changes = np.concatenate(ccs) if ccs else first.control_changes
    first.pitch_bends = np.concatenate(pbs) if pbs else first.pitch_bends
    midi.tracks = [first]
    return midi

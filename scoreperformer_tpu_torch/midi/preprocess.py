# Verbatim copy of scoreperformer_tpu/midi/preprocess.py; the port imports nothing of the JAX package.
"""Standalone MIDI preprocessing pipeline
(counterpart of scoreperformer/data/midi/preprocess.py:11-91)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .containers import Marker, MidiScore, NoteArray, Track
from . import ops


def preprocess_midi(
    midi: MidiScore,
    to_single_track: bool = True,
    sort_events: bool = True,
    clean_duplicates: bool = True,
    cut_overlapped_notes: bool = False,
    clean_short_notes: bool = False,
    quantize_notes: bool = False,
    quantize_midi_changes: bool = False,
    filter_late_events: bool = True,
    target_ticks_per_beat: Optional[int] = None,
) -> MidiScore:
    if len(midi.tracks) == 0:
        return midi

    if len(midi.tracks) > 1 and to_single_track:
        ops.merge_tracks(midi)

    for track in midi.tracks:
        if clean_duplicates:
            track.notes = ops.remove_duplicated_notes(track.notes)
        if cut_overlapped_notes:
            track.notes = ops.cut_overlapping_notes(track.notes)
        if clean_short_notes:
            track.notes = ops.remove_short_notes(track.notes, time_division=midi.ticks_per_beat)
        if quantize_notes:
            track.notes = ops.quantize_note_times(track.notes, time_division=midi.ticks_per_beat)
            if clean_duplicates:
                track.notes = ops.remove_duplicated_notes(track.notes)

    if sort_events:
        for track in midi.tracks:
            track.notes = track.notes.sort("time")
    midi.recompute_max_tick()
    if not sort_events:
        midi.max_tick += 1

    midi.tracks = [t for t in midi.tracks if len(t.notes) > 0]

    if filter_late_events:
        ops.filter_late_events(midi)

    if quantize_midi_changes:
        ts = midi.time_sigs
        t, n, d = ops.quantize_time_signature_times(
            ts.time, ts.numerator, ts.denominator, time_division=midi.ticks_per_beat
        )
        midi.time_sigs.time, midi.time_sigs.numerator, midi.time_sigs.denominator = t, n, d
        tt, tp = ops.quantize_tempo_times(
            midi.tempos.time, midi.tempos.tempo, time_division=midi.ticks_per_beat
        )
        midi.tempos.time, midi.tempos.tempo = tt, tp
        midi.key_sigs = ops.quantize_key_signature_times(
            midi.key_sigs, time_division=midi.ticks_per_beat
        )

    if target_ticks_per_beat is not None:
        ops.resample_midi(midi, ticks_per_beat=target_ticks_per_beat)

    return midi


def parse_silent_note_markers(markers) -> NoteArray:
    """Extract unperformed notes encoded as ``NoteS_pitch_start_end`` markers
    (reference octuple_m.py:59-73)."""
    tuples = []
    for m in markers:
        if m.text.startswith("NoteS"):
            pitch, start_tick, end_tick = map(int, m.text.split("_")[1:])
            tuples.append((pitch, 0, start_tick, end_tick))
    return NoteArray.from_tuples(tuples)


def insert_silent_notes(midi: MidiScore, markers=None, track_idx: Optional[int] = None) -> MidiScore:
    """Add unperformed notes from markers as a dedicated track
    (preprocess.py:68-91)."""
    markers = markers if markers is not None else midi.markers
    notes = parse_silent_note_markers(markers)
    if track_idx is None:
        midi.tracks.append(Track(notes=notes, program=0, is_drum=False, name="Unperformed Notes"))
    else:
        midi.tracks[track_idx].notes = midi.tracks[track_idx].notes.concat(notes)
    return midi


def fill_unperformed_notes(midi: MidiScore) -> MidiScore:
    """Append unperformed notes (from ``NoteS`` markers) as a separate track
    unless already present (reference octuple_m.py:59-73)."""
    if midi.tracks and midi.tracks[-1].name == "Unperformed Notes":
        return midi
    notes = parse_silent_note_markers(midi.markers)
    if len(notes):
        midi.tracks.append(Track(notes=notes, program=0, is_drum=False, name="Unperformed Notes"))
    return midi

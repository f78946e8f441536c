# Verbatim copy of scoreperformer_tpu/utils/playback.py; the port imports nothing of the JAX package.
"""Playback helpers (counterpart of scoreperformer/utils/playback.py).

Audio synthesis requires fluidsynth/note_seq (unavailable in this
environment); `midi_to_audio` degrades gracefully. `cut_midi` is fully
supported on SoA containers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..midi import Marker, MidiScore, TempoMap


def cut_midi(
    midi: MidiScore,
    min_tick: int = 0,
    max_tick: int = int(1e9),
    cut_end_tick: bool = True,
    save_path: Optional[str] = None,
) -> MidiScore:
    """Slice a MIDI to a tick window, re-basing times (playback.py:9-46)."""
    midi = midi.copy()
    for track in midi.tracks:
        notes = track.notes
        keep = (notes.start >= min_tick) & (notes.start <= max_tick)
        notes = notes[keep]
        notes.start = notes.start - min_tick
        ends = np.minimum(notes.end, max_tick) if cut_end_tick else notes.end
        notes.end = ends - min_tick
        track.notes = notes
        if len(track.control_changes):
            cc = track.control_changes
            cc = cc[(cc[:, 0] >= min_tick) & (cc[:, 0] <= max_tick)]
            cc[:, 0] -= min_tick
            track.control_changes = cc

    keep = (midi.tempos.time >= min_tick) & (midi.tempos.time <= max_tick)
    midi.tempos = TempoMap(midi.tempos.time[keep] - min_tick, midi.tempos.tempo[keep])
    if len(midi.tempos) == 0:
        midi.tempos = TempoMap.default()
    midi.markers = [
        Marker(m.time - min_tick, m.text)
        for m in midi.markers
        if min_tick <= m.time <= max_tick
    ]
    midi.recompute_max_tick()
    if len(midi.tempos):
        midi.max_tick = max(midi.max_tick, int(midi.tempos.time[-1]) + 1)

    if save_path is not None:
        from ..midi import write_midi

        write_midi(midi, save_path)
    return midi


def midi_to_audio(path: str, sample_rate: int = 22050, play: bool = True):
    """Synthesize audio from a MIDI file (requires note_seq + fluidsynth)."""
    try:
        import note_seq
        from note_seq import midi_file_to_note_sequence
    except ImportError as e:
        raise ImportError(
            "midi_to_audio requires the optional `note_seq` + fluidsynth stack, "
            "which is not installed in this environment"
        ) from e
    ns = midi_file_to_note_sequence(path)
    audio = note_seq.fluidsynth(ns, sample_rate=sample_rate)
    if play:
        import IPython.display as ipd

        ipd.display(ipd.Audio(audio, rate=sample_rate))
    return audio

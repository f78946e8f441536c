# Verbatim copy of scoreperformer_tpu/data/music_constants.py; the port imports nothing of the JAX package.
"""Pitch ↔ scientific-pitch (sitch) conversion
(counterpart of scoreperformer/data/music_constants.py)."""
from __future__ import annotations

PITCH_CLASSES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
FLAT_EQUIVALENTS = {"Db": "C#", "Eb": "D#", "Gb": "F#", "Ab": "G#", "Bb": "A#"}


def pitch_to_sitch(pitch: int) -> str:
    """MIDI pitch number → scientific pitch name (60 → 'C4')."""
    return f"{PITCH_CLASSES[pitch % 12]}{pitch // 12 - 1}"


def sitch_to_pitch(sitch: str) -> int:
    """Scientific pitch name → MIDI pitch number ('C4' → 60)."""
    name = sitch.rstrip("-0123456789")
    octave = int(sitch[len(name):])
    name = FLAT_EQUIVALENTS.get(name, name)
    return PITCH_CLASSES.index(name) + (octave + 1) * 12

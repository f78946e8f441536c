# Verbatim copy of scoreperformer_tpu/midi/containers.py; the port imports nothing of the JAX package.
"""Structure-of-arrays MIDI containers.

A TPU-first re-design of the reference's miditoolkit object model: instead of
Python lists of Note objects (reference scoreperformer/data/midi/containers.py
and miditoolkit), notes live in numpy arrays so every downstream transform
(quantization, tokenization, augmentation) is vectorized and can be shipped to
the device as-is.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class NoteArray:
    """Notes as parallel arrays. ``start``/``end`` are ticks (int64) by default
    but may hold seconds (float64) for absolute-timing intermediates."""

    pitch: np.ndarray
    velocity: np.ndarray
    start: np.ndarray
    end: np.ndarray

    def __post_init__(self):
        self.pitch = np.asarray(self.pitch)
        self.velocity = np.asarray(self.velocity)
        self.start = np.asarray(self.start)
        self.end = np.asarray(self.end)

    @classmethod
    def empty(cls, time_dtype=np.int64) -> "NoteArray":
        return cls(
            pitch=np.empty(0, np.int32),
            velocity=np.empty(0, np.int32),
            start=np.empty(0, time_dtype),
            end=np.empty(0, time_dtype),
        )

    @classmethod
    def from_tuples(cls, tuples, time_dtype=np.int64) -> "NoteArray":
        """Build from an iterable of (pitch, velocity, start, end)."""
        if not len(tuples):
            return cls.empty(time_dtype)
        arr = np.asarray(tuples)
        return cls(
            pitch=arr[:, 0].astype(np.int32),
            velocity=arr[:, 1].astype(np.int32),
            start=arr[:, 2].astype(time_dtype),
            end=arr[:, 3].astype(time_dtype),
        )

    def __len__(self) -> int:
        return len(self.pitch)

    def __getitem__(self, idx) -> "NoteArray":
        return NoteArray(self.pitch[idx], self.velocity[idx], self.start[idx], self.end[idx])

    @property
    def duration(self) -> np.ndarray:
        return self.end - self.start

    def copy(self) -> "NoteArray":
        return NoteArray(
            self.pitch.copy(), self.velocity.copy(), self.start.copy(), self.end.copy()
        )

    def sort(self, order: str = "time", return_indices: bool = False):
        """Sort notes. ``time``: (start, pitch, end); ``pitch``: (pitch, start, end)."""
        if order == "time":
            ids = np.lexsort((self.end, self.pitch, self.start))
        elif order == "pitch":
            ids = np.lexsort((self.end, self.start, self.pitch))
        else:
            raise ValueError(f"unknown sort order {order!r}")
        sorted_notes = self[ids]
        if return_indices:
            return sorted_notes, ids
        return sorted_notes

    def concat(self, other: "NoteArray") -> "NoteArray":
        return NoteArray(
            np.concatenate([self.pitch, other.pitch]),
            np.concatenate([self.velocity, other.velocity]),
            np.concatenate([self.start, other.start]),
            np.concatenate([self.end, other.end]),
        )


@dataclass
class Track:
    notes: NoteArray
    program: int = 0
    is_drum: bool = False
    name: str = ""
    # control changes (N, 3) [time, number, value]; pitch bends (N, 2)
    # [time, value]; sustain pedals (N, 2) [start, end] — derived from CC64
    # runs at parse time (reference Track counterpart carries Pedal objects)
    control_changes: np.ndarray = field(default_factory=lambda: np.empty((0, 3), np.int64))
    pitch_bends: np.ndarray = field(default_factory=lambda: np.empty((0, 2), np.int64))
    pedals: np.ndarray = field(default_factory=lambda: np.empty((0, 2), np.int64))


@dataclass
class TempoMap:
    """Tempo changes: ``time`` ticks, ``tempo`` BPM (float)."""

    time: np.ndarray
    tempo: np.ndarray

    def __post_init__(self):
        self.time = np.asarray(self.time, dtype=np.int64)
        self.tempo = np.asarray(self.tempo, dtype=np.float64)

    @classmethod
    def default(cls, bpm: float = 120.0) -> "TempoMap":
        return cls(np.array([0]), np.array([bpm]))

    def __len__(self) -> int:
        return len(self.time)

    def __getitem__(self, idx) -> "TempoMap":
        return TempoMap(np.atleast_1d(self.time[idx]), np.atleast_1d(self.tempo[idx]))

    def copy(self) -> "TempoMap":
        return TempoMap(self.time.copy(), self.tempo.copy())


@dataclass
class TimeSigMap:
    """Time signature changes: ``time`` ticks, ``numerator``, ``denominator``."""

    time: np.ndarray
    numerator: np.ndarray
    denominator: np.ndarray

    def __post_init__(self):
        self.time = np.asarray(self.time, dtype=np.int64)
        self.numerator = np.asarray(self.numerator, dtype=np.int64)
        self.denominator = np.asarray(self.denominator, dtype=np.int64)

    @classmethod
    def default(cls) -> "TimeSigMap":
        return cls(np.array([0]), np.array([4]), np.array([4]))

    def __len__(self) -> int:
        return len(self.time)

    def __getitem__(self, idx) -> "TimeSigMap":
        return TimeSigMap(
            np.atleast_1d(self.time[idx]),
            np.atleast_1d(self.numerator[idx]),
            np.atleast_1d(self.denominator[idx]),
        )

    def copy(self) -> "TimeSigMap":
        return TimeSigMap(self.time.copy(), self.numerator.copy(), self.denominator.copy())


@dataclass
class Marker:
    time: int
    text: str


@dataclass
class MidiScore:
    """A full MIDI piece in SoA form (counterpart of miditoolkit.MidiFile)."""

    ticks_per_beat: int = 480
    tracks: List[Track] = field(default_factory=list)
    tempos: TempoMap = field(default_factory=TempoMap.default)
    time_sigs: TimeSigMap = field(default_factory=TimeSigMap.default)
    key_sigs: List[Tuple[int, str]] = field(default_factory=list)
    markers: List[Marker] = field(default_factory=list)
    max_tick: int = 0

    def recompute_max_tick(self) -> int:
        ends = [int(t.notes.end.max()) for t in self.tracks if len(t.notes)]
        self.max_tick = max(ends) if ends else 0
        return self.max_tick

    @property
    def num_notes(self) -> int:
        return sum(len(t.notes) for t in self.tracks)

    def all_notes(self, with_track_ids: bool = False):
        """All notes across tracks, concatenated in track order."""
        if not self.tracks:
            out = NoteArray.empty()
            return (out, np.empty(0, np.int32)) if with_track_ids else out
        notes = self.tracks[0].notes
        track_ids = np.zeros(len(notes), np.int32)
        for i, track in enumerate(self.tracks[1:], start=1):
            notes = notes.concat(track.notes)
            track_ids = np.concatenate([track_ids, np.full(len(track.notes), i, np.int32)])
        if with_track_ids:
            return notes, track_ids
        return notes

    def copy(self) -> "MidiScore":
        return MidiScore(
            ticks_per_beat=self.ticks_per_beat,
            tracks=[
                Track(
                    notes=t.notes.copy(),
                    program=t.program,
                    is_drum=t.is_drum,
                    name=t.name,
                    control_changes=t.control_changes.copy(),
                    pitch_bends=t.pitch_bends.copy(),
                    pedals=t.pedals.copy(),
                )
                for t in self.tracks
            ],
            tempos=self.tempos.copy(),
            time_sigs=self.time_sigs.copy(),
            key_sigs=list(self.key_sigs),
            markers=[Marker(m.time, m.text) for m in self.markers],
            max_tick=self.max_tick,
        )

# Copy of synthetic_score from scoreperformer_tpu/data/synthetic.py; the port imports nothing of the JAX package.
"""Synthetic score generation (the score that `chip_smoke.py` renders)."""
from __future__ import annotations

import numpy as np

from ..midi import MidiScore, NoteArray, TempoMap, Track

MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])


def synthetic_score(
    rng: np.random.RandomState,
    n_bars: int = 16,
    tpb: int = 480,
    base_pitch: int = 48,
) -> MidiScore:
    """A few-voice piece: melody eighths + bass + occasional chords."""
    notes = []
    for bar in range(n_bars):
        bar_start = bar * 4 * tpb
        # melody: eighth notes on a scale walk
        for i in range(8):
            start = bar_start + i * tpb // 2
            degree = int(rng.randint(0, 14))
            pitch = base_pitch + 12 + MAJOR[degree % 7] + 12 * (degree // 7)
            notes.append((pitch, int(rng.randint(55, 100)), start, start + tpb // 2))
        # bass: half notes
        for i in range(2):
            start = bar_start + i * 2 * tpb
            pitch = base_pitch + MAJOR[int(rng.randint(0, 5))]
            notes.append((pitch, int(rng.randint(45, 80)), start, start + 2 * tpb))
        # chord on downbeat
        if rng.rand() < 0.5:
            for interval in (4, 7):
                pitch = base_pitch + 12 + interval
                notes.append((pitch, int(rng.randint(50, 90)), bar_start, bar_start + tpb))
    score = MidiScore(ticks_per_beat=tpb)
    score.tracks.append(Track(notes=NoteArray.from_tuples(notes)))
    score.tempos = TempoMap([0], [120.0])
    score.recompute_max_tick()
    return score

# Verbatim copy of scoreperformer_tpu/data/synthetic.py; the port imports nothing of the JAX package.
"""Synthetic score-performance dataset generation.

Builds small but musically-plausible datasets (scores + rubato performances)
in the on-disk layout the reference uses (metadata.json + config.json +
per-piece token JSONs), for tests, training smoke runs, and benchmarks.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..midi import MidiScore, NoteArray, TempoMap, Track
from ..tokenizers import SPMupleWindow, TokenizerConfig
from ..utils import dump_json

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


PATHOLOGY_KINDS = (
    "mid_bar_tempo",
    "time_sig_changes",
    "overlapping_voices",
    "dense_pedals",
    "anacrusis",
)


def synthetic_pathological_score(
    rng: np.random.RandomState,
    kind: str,
    n_bars: int = 12,
    tpb: int = 480,
    base_pitch: int = 48,
) -> MidiScore:
    """Scores exhibiting real-corpus pathologies the preprocessing pipeline
    must survive (reference edge cases: data/midi/preprocess.py:11-91 and
    data/midi/utils.py:31-177):

    - ``mid_bar_tempo``: tempo changes on off-beat ticks inside bars,
      including two changes within one bar.
    - ``time_sig_changes``: 4/4 -> 3/4 -> 6/8 sections plus one time-sig
      event on a misaligned (non-bar) tick.
    - ``overlapping_voices``: same-pitch overlapping notes and duplicated
      onsets (cut_overlapping_notes / remove_duplicated_notes paths).
    - ``dense_pedals``: sustain-pedal runs re-pressed every bar covering
      nearly the whole piece.
    - ``anacrusis``: a pickup encoded as a short 1/4 first bar before the
      4/4 body.
    """
    if kind not in PATHOLOGY_KINDS:
        raise ValueError(f"unknown pathology kind: {kind!r}")
    score = synthetic_score(rng, n_bars=n_bars, tpb=tpb, base_pitch=base_pitch)
    bar = 4 * tpb

    if kind == "mid_bar_tempo":
        # off-beat mid-bar changes; bar 5 gets two changes
        times = [0, bar + tpb // 2 + 7, 3 * bar + 3 * tpb, 5 * bar + tpb // 3,
                 5 * bar + 2 * tpb + 11, 8 * bar + tpb]
        bpms = [120.0, 96.0, 132.0, 84.0, 108.0, 140.0]
        score.tempos = TempoMap(np.array(times), np.array(bpms))

    elif kind == "time_sig_changes":
        from ..midi import TimeSigMap

        # 4 bars of 4/4, then 3/4, then 6/8; one event lands mid-bar
        ts_times = [0, 4 * bar, 4 * bar + 4 * 3 * tpb + tpb // 2]
        score.time_sigs = TimeSigMap(
            np.array(ts_times), np.array([4, 3, 6]), np.array([4, 4, 8])
        )

    elif kind == "overlapping_voices":
        notes = score.tracks[0].notes
        # clone a slice of the melody shifted by a quarter so the same
        # pitches overlap their originals; duplicate a few onsets exactly
        sel = np.arange(len(notes)) % 3 == 0
        over = notes[sel].copy()
        over.start = over.start + tpb // 4
        over.end = over.end + tpb
        dup = notes[np.arange(len(notes)) % 7 == 0].copy()
        score.tracks[0].notes = notes.concat(over).concat(dup).sort("time")

    elif kind == "dense_pedals":
        # pedal down for ~95% of every bar, re-pressed at each downbeat
        starts = np.arange(n_bars) * bar
        ends = starts + int(bar * 0.95)
        score.tracks[0].pedals = np.stack([starts, ends], axis=1).astype(np.int64)

    elif kind == "anacrusis":
        from ..midi import TimeSigMap

        # short 1/4 pickup bar: two eighth notes, then the 4/4 body shifted
        notes = score.tracks[0].notes
        notes.start = notes.start + tpb
        notes.end = notes.end + tpb
        pickup = NoteArray.from_tuples(
            [
                (base_pitch + 12 + int(MAJOR[4]), 60, 0, tpb // 2),
                (base_pitch + 12 + int(MAJOR[5]), 64, tpb // 2, tpb),
            ]
        )
        score.tracks[0].notes = pickup.concat(notes).sort("time")
        score.time_sigs = TimeSigMap(
            np.array([0, tpb]), np.array([1, 4]), np.array([4, 4])
        )

    score.recompute_max_tick()
    return score


def synthetic_performance(
    score: MidiScore,
    rng: np.random.RandomState,
    tempo_base: float = 110.0,
    tempo_amp: float = 15.0,
    jitter_std: float = 0.006,
    vel_std: float = 6.0,
) -> MidiScore:
    """Rubato rendition: sinusoidal tempo + onset jitter + velocity shaping.
    Times are converted back to ticks at the score's nominal tempo map."""
    tpb = score.ticks_per_beat
    notes = score.all_notes().sort("time")

    grid = np.arange(0, score.max_tick + 1)
    phase = grid / (16.0 * tpb) * 2 * np.pi
    tempo_curve = tempo_base + tempo_amp * np.sin(phase)
    sec_per_tick = 60.0 / (tempo_curve * tpb)
    cum = np.concatenate([[0], np.cumsum(sec_per_tick)])

    starts_sec = np.maximum(cum[notes.start] + rng.normal(0, jitter_std, len(notes)), 0)
    ends_sec = cum[notes.end] + rng.normal(0, jitter_std / 2, len(notes))
    ends_sec = np.maximum(ends_sec, starts_sec + 0.02)

    velocities = np.clip(
        notes.velocity + rng.normal(0, vel_std, len(notes)), 20, 127
    ).astype(np.int64)

    # performance MIDI at fixed 120bpm (seconds -> ticks at 2*tpb ticks/sec)
    perf = MidiScore(ticks_per_beat=tpb)
    perf.tracks.append(
        Track(
            notes=NoteArray(
                pitch=notes.pitch.copy(),
                velocity=velocities,
                start=np.round(starts_sec * 2 * tpb).astype(np.int64),
                end=np.round(ends_sec * 2 * tpb).astype(np.int64),
            )
        )
    )
    perf.tempos = TempoMap([0], [120.0])
    perf.recompute_max_tick()
    return perf


def build_synthetic_dataset(
    root: str,
    n_scores: int = 3,
    n_perfs_per_score: int = 2,
    n_bars: int = 16,
    seed: int = 0,
    max_bar_embedding: int = 256,
    with_directions: bool = True,
    splits: bool = False,
    pathologies: bool = False,
) -> str:
    """Write a full dataset directory; returns `root`.

    With ``pathologies=True``, one extra score per ``PATHOLOGY_KINDS`` entry
    (mid-bar tempo changes, time-sig sections, overlapping voices, dense
    pedals, anacrusis) is appended so the whole train/render lifecycle
    exercises real-corpus edge cases."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)

    tokenizer = SPMupleWindow(
        TokenizerConfig(additional_params={"max_bar_embedding": max_bar_embedding})
    )
    tokenizer.save(os.path.join(root, "config.json"))

    kinds = list(PATHOLOGY_KINDS) if pathologies else []
    metadata = {}
    directions_dict = {}
    for si in range(n_scores + len(kinds)):
        score_name = f"score_{si:03d}"
        if si < n_scores:
            score = synthetic_score(rng, n_bars=n_bars, base_pitch=44 + 4 * si)
        else:
            score = synthetic_pathological_score(
                rng, kinds[si - n_scores], n_bars=n_bars, base_pitch=48
            )
        score_seq = tokenizer.score_midi_to_tokens(score)
        dump_json({"ids": score_seq.ids.tolist()}, os.path.join(root, score_name + ".json"))

        perf_names = []
        for pi in range(n_perfs_per_score):
            perf_name = f"{score_name}_perf_{pi}"
            perf = synthetic_performance(
                score, rng, tempo_base=float(rng.randint(90, 140))
            )
            perf_seq = tokenizer.performance_midi_to_tokens(perf, score_seq)
            dump_json(
                {"ids": perf_seq.ids.tolist(), "meta": {"initial_tempo": perf_seq.meta["initial_tempo"]}},
                os.path.join(root, perf_name + ".json"),
            )
            perf_names.append(perf_name)
        metadata[score_name] = perf_names

        if with_directions:
            # mark a crescendo over bars 2-4 and staccato on a few notes
            tpb = 480
            directions_dict[score_name] = [
                {"type": "dynamic/crescendo", "start": 2 * 4 * tpb, "end": 4 * 4 * tpb},
                {"type": "articulation/staccato", "offset": int(rng.randint(0, 8))},
            ]

    if splits:
        names = list(metadata.keys())
        train = {k: metadata[k] for k in names[: max(1, len(names) - 1)]}
        eval_ = {k: metadata[k] for k in names[max(1, len(names) - 1):]}
        dump_json({"train": train, "eval": eval_}, os.path.join(root, "metadata.json"))
    else:
        dump_json(metadata, os.path.join(root, "metadata.json"))

    if with_directions:
        dump_json(directions_dict, os.path.join(root, "score_directions.json"))
        dump_json(
            {
                "dynamics": ["dynamic/crescendo"],
                "articulations": ["articulation/staccato"],
            },
            os.path.join(root, "direction_classes.json"),
        )

    return root

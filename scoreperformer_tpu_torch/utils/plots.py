# Verbatim copy of scoreperformer_tpu/utils/plots.py; the port imports nothing of the JAX package.
"""Visualization helpers (counterpart of scoreperformer/utils/plots.py).

Pianoroll rendering is self-contained (no librosa/pretty_midi): the roll is
rasterized from the SoA note arrays directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..midi import MidiScore, tick_to_time_map


def plot_performance_parameter(tokenizer, total_seq, perf_seq, token_type: str = "Tempo"):
    """Generated-vs-target curves for one performance stream (plots.py:10-54)."""
    import matplotlib.pyplot as plt

    type_idx = tokenizer.types_idx[token_type]
    preds_tok = np.asarray(total_seq)[:, type_idx] - tokenizer.zero_token
    targets_tok = np.asarray(perf_seq)[: len(total_seq), type_idx] - tokenizer.zero_token

    values_map = tokenizer.token_type_values(token_type, special_tokens=False)
    preds = values_map[np.clip(preds_tok, 0, len(values_map) - 1)]
    targets = values_map[np.clip(targets_tok, 0, len(values_map) - 1)]

    fig, axes = plt.subplots(nrows=2, sharex=True, figsize=(15, 10))
    top, bottom = axes
    for label, series in (("Generated", preds), ("Target", targets)):
        top.plot(series, label=label)
    bottom.plot(preds - targets, label="Difference", color="tab:red")
    bottom.set_xlabel("note index", fontsize=15)
    for axis in axes:
        axis.legend(fontsize=15)
        axis.tick_params(labelsize=13)
        axis.set_ylabel(token_type.lower(), fontsize=15)
    fig.suptitle(f"{token_type}: generated vs target", fontsize=18)
    fig.tight_layout()
    return fig


def midi_to_pianoroll(
    midi: MidiScore,
    fs: int = 100,
    min_pitch: int = 21,
    max_pitch: int = 109,
    max_velocity: float = 127.0,
) -> np.ndarray:
    """Rasterize a MidiScore into a (pitches, time-steps) velocity roll."""
    ttt = tick_to_time_map(midi.tempos, midi.max_tick, midi.ticks_per_beat)
    notes = midi.all_notes()
    n_pitches = max_pitch - min_pitch + 1
    end_time = float(ttt[-1]) if len(ttt) else 0.0
    n_steps = max(1, int(np.ceil(end_time * fs)) + 1)
    roll = np.zeros((n_pitches, n_steps), dtype=np.float32)

    starts = np.clip(np.asarray(notes.start, np.int64), 0, len(ttt) - 1)
    ends = np.clip(np.asarray(notes.end, np.int64), 0, len(ttt) - 1)
    s_steps = (ttt[starts] * fs).astype(int)
    e_steps = np.maximum((ttt[ends] * fs).astype(int), s_steps + 1)
    for pitch, vel, s, e in zip(notes.pitch, notes.velocity, s_steps, e_steps):
        if min_pitch <= pitch <= max_pitch:
            roll[pitch - min_pitch, s:e] = np.maximum(
                roll[pitch - min_pitch, s:e], min(vel, max_velocity)
            )
    return roll


def plot_pianoroll(
    midi: MidiScore,
    fs: int = 100,
    min_pitch: int = 21,
    max_pitch: int = 109,
    max_velocity: float = 127.0,
    figsize=(14, 6),
    fig=None,
    ax=None,
):
    """(plots.py:62-114)"""
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    colors = plt.get_cmap("Reds", 256)(np.linspace(0, 1, 256))
    colors[:1, :] = np.array([1, 1, 1, 1])
    cmap = ListedColormap(colors)

    if ax is None or fig is None:
        fig, ax = plt.subplots(figsize=figsize)

    roll = midi_to_pianoroll(midi, fs, min_pitch, max_pitch, max_velocity)
    extent = (0, roll.shape[1] / fs, min_pitch, max_pitch + 1)
    im = ax.imshow(
        roll, aspect="auto", origin="lower", cmap=cmap, extent=extent,
        vmin=0, vmax=max_velocity, interpolation="nearest",
    )
    cbar = fig.colorbar(im, ax=ax, fraction=0.15, pad=0.02, aspect=15)
    cbar.set_ticks(np.arange(0, max_velocity, 12))

    ax.set_xlabel("time (s)", fontsize=16)
    ax.set_ylabel("pitch", fontsize=16)
    ax.tick_params(labelsize=14)

    ax.grid(alpha=0.5)
    sounding = min_pitch + np.flatnonzero(roll.any(axis=1))
    if sounding.size:
        # zoom to the octave-aligned sounding range
        lo = max(min_pitch, sounding[0] - sounding[0] % 12) - 2.5
        hi = min(max_pitch, sounding[-1] + 12 - sounding[-1] % 12) + 1.5
        ax.set_ylim(lo, hi)
    return fig, ax

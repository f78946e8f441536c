# Copy of scoreperformer_tpu/data/prepare.py (its spawn note names CUDA); the port imports nothing of the JAX package.
"""Dataset preparation: (score.mid, performance.mid[, score.musicxml]) pairs →
the on-disk training layout (metadata.json + config.json + token JSONs +
direction maps + aux data).

The reference repo ships only pre-tokenized datasets; this is the missing
offline pipeline, built on this framework's tokenizers. Score↔performance
note alignment uses onset-ordered pitch matching (greedy per onset window)
when note counts differ; exactly-matching streams align positionally.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..midi import MidiScore, read_midi
from ..tokenizers import TOKENIZERS, TokenizerConfig, TokSequence
from ..utils import dump_json


def align_performance_to_score(
    score_notes: np.ndarray,  # (N, 2): [onset_tick, pitch] in score order
    perf_notes: np.ndarray,  # (M, 2): [onset_tick, pitch] in perf order
    max_onset_window: float = 2.0,  # beats
    ticks_per_beat: int = 480,
) -> np.ndarray:
    """Greedy alignment: for each score note (in order) find the nearest
    unmatched performance note of the same pitch within an onset window.
    Returns, per score note, the matched perf index or -1 (unperformed)."""
    window = max_onset_window * ticks_per_beat
    by_pitch: Dict[int, List[int]] = {}
    for j, (_, pitch) in enumerate(perf_notes):
        by_pitch.setdefault(int(pitch), []).append(j)
    used = np.zeros(len(perf_notes), dtype=bool)

    # rough global time mapping: normalize onsets to [0, 1] (spans and
    # normalized perf onsets are loop-invariant — computed once)
    s_min = score_notes[:, 0].min() if len(score_notes) else 0
    s_span = max(1, score_notes[:, 0].max() - s_min) if len(score_notes) else 1
    p_min = perf_notes[:, 0].min() if len(perf_notes) else 0
    p_span = max(1, perf_notes[:, 0].max() - p_min) if len(perf_notes) else 1
    p_rel_all = (perf_notes[:, 0] - p_min) / p_span if len(perf_notes) else perf_notes

    out = np.full(len(score_notes), -1, dtype=np.int64)
    for i, (s_tick, pitch) in enumerate(score_notes):
        cands = by_pitch.get(int(pitch), [])
        s_rel = (s_tick - s_min) / s_span
        best, best_dist = -1, None
        for j in cands:
            if used[j]:
                continue
            dist = abs(p_rel_all[j] - s_rel) * s_span
            if dist > window:
                continue
            if best_dist is None or dist < best_dist:
                best, best_dist = j, dist
        if best >= 0:
            used[best] = True
            out[i] = best
    return out


def build_aligned_performance(
    tokenizer,
    score_midi: MidiScore,
    perf_midi: MidiScore,
    score_seq: TokSequence,
) -> Tuple[MidiScore, Optional[np.ndarray]]:
    """Make the performance MIDI note-for-note alignable with the score:
    if counts differ, unmatched score notes are inserted as silent (velocity
    0) notes at their tempo-mapped times, and extra perf notes are dropped.
    Returns (aligned perf midi, alignment or None when positional)."""
    from ..midi import NoteArray, Track

    perf_work = perf_midi.copy()
    tokenizer.preprocess_performance_midi(perf_work)
    perf_notes = perf_work.all_notes().sort("time")

    ticks = tokenizer.compute_ticks(score_seq.ids, score_midi.ticks_per_beat)["note_on"]
    pitches = tokenizer.decode_token_type(score_seq.ids, "Pitch")

    matches = align_performance_to_score(
        np.stack([ticks, pitches], 1),
        np.stack([perf_notes.start, perf_notes.pitch], 1),
        ticks_per_beat=score_midi.ticks_per_beat,
    )

    # tempo-scaled fallback times for unperformed notes
    scale = (
        (perf_notes.start.max() - perf_notes.start.min()) / max(1, ticks.max() - ticks.min())
        if len(perf_notes)
        else 1.0
    )

    n = len(ticks)
    jc = np.maximum(matches, 0)
    performed = matches >= 0
    # silent-note fallback: tempo-mapped position, duration from score tokens
    durs = tokenizer.decode_token_type(score_seq.ids, "Duration")
    tps = score_midi.ticks_per_beat / tokenizer.max_beat_res
    silent_start = (ticks * scale).astype(np.int64)
    silent_end = silent_start + np.maximum(1, (durs * tps * scale).astype(np.int64))
    if len(perf_notes):
        new_pitch = np.where(performed, perf_notes.pitch[jc], pitches).astype(np.int32)
        new_vel = np.where(performed, perf_notes.velocity[jc], 0).astype(np.int32)
        new_start = np.where(performed, perf_notes.start[jc], silent_start).astype(np.int64)
        new_end = np.where(performed, perf_notes.end[jc], silent_end).astype(np.int64)
    else:
        new_pitch = pitches.astype(np.int32)
        new_vel = np.zeros(n, np.int32)
        new_start = silent_start
        new_end = silent_end

    aligned = MidiScore(ticks_per_beat=perf_midi.ticks_per_beat)
    aligned.tracks.append(
        Track(notes=NoteArray(new_pitch, new_vel, new_start, new_end))
    )
    aligned.tempos = perf_work.tempos.copy()
    aligned.time_sigs = score_midi.time_sigs.copy()
    aligned.recompute_max_tick()

    # after building, the encode path sorts by (time, track, pitch); provide an
    # explicit alignment mapping perf rows back to score order
    sort_order = np.lexsort((new_pitch, np.zeros(n), new_start))
    alignment = np.argsort(sort_order)  # perf-sorted -> score order
    return aligned, alignment


def _prepare_piece(
    tokenizer,
    score_name: str,
    score_path: str,
    perf_paths: List[str],
    output_root: str,
    directions_path: Optional[str],
):
    """Tokenize one piece (score + all its performances) and write its token
    JSONs. Pieces are independent — this is the unit of parallelism."""
    from .datasets import get_num_bars

    score_midi = read_midi(score_path)
    score_seq = tokenizer.score_midi_to_tokens(score_midi)
    _dump_token_json(score_seq.ids, os.path.join(output_root, score_name + ".json"))

    perf_names: List[str] = []
    bars: Dict[str, int] = {}
    initial_tempos: Dict[str, float] = {}
    for pi, perf_path in enumerate(perf_paths):
        perf_name = f"{score_name}_perf_{pi}"
        perf_midi = read_midi(perf_path)
        aligned, alignment = build_aligned_performance(
            tokenizer, score_midi, perf_midi, score_seq
        )
        perf_seq = tokenizer.performance_midi_to_tokens(
            aligned, score_seq, alignment=alignment, preprocess=False
        )
        _dump_token_json(
            perf_seq.ids,
            os.path.join(output_root, perf_name + ".json"),
            meta={"initial_tempo": perf_seq.meta.get("initial_tempo")},
        )
        perf_names.append(perf_name)
        bars[perf_name] = get_num_bars(perf_seq.ids, tokenizer)
        if perf_seq.meta.get("initial_tempo") is not None:
            initial_tempos[perf_name] = float(perf_seq.meta["initial_tempo"])

    piece_directions = None
    if directions_path:
        from .musicxml_directions import parse_directions

        parsed = parse_directions(directions_path)
        piece_directions = [d for part in parsed for d in part]
    return score_name, perf_names, bars, initial_tempos, piece_directions


# per-worker tokenizer cache (spawned workers rebuild it once from the saved
# config.json rather than pickling the tokenizer object per task)
_WORKER_TOKENIZER: Optional[tuple] = None


def _dump_token_json(ids: np.ndarray, path: str, meta: Optional[dict] = None) -> None:
    """Write a token file `{"ids": [[...]], "meta": {...}}`.

    Identical JSON value to `dump_json` but ~8x faster to serialize: the
    (N, K) int matrix is formatted with str joins instead of the generic
    recursive encoder — this is the dominant cost of dataset preparation
    for large corpora (json.dump of ids.tolist() profiled at ~55% of
    prepare time)."""
    import json

    rows = [",".join(map(str, r)) for r in np.asarray(ids).tolist()]
    ids_str = "[[" + "],[".join(rows) + "]]" if rows else "[]"
    body = '{"ids": ' + ids_str
    if meta is not None:
        body += ', "meta": ' + json.dumps(meta)
    body += "}"
    with open(path, "w") as f:
        f.write(body)


def _piece_worker(task):
    global _WORKER_TOKENIZER
    (score_name, score_path, perf_paths, output_root, config_path, directions_path) = task
    if _WORKER_TOKENIZER is None or _WORKER_TOKENIZER[0] != config_path:
        from . import prepare  # noqa: F401 (keep module import side effects)
        from ..tokenizers import load_tokenizer

        _WORKER_TOKENIZER = (config_path, load_tokenizer(config_path))
    tokenizer = _WORKER_TOKENIZER[1]
    return _prepare_piece(
        tokenizer, score_name, score_path, perf_paths, output_root, directions_path
    )


def prepare_dataset(
    pairs: Sequence[Tuple[str, str, List[str]]],  # (score_name, score.mid, [perf.mid...])
    output_root: str,
    tokenization: str = "SPMupleWindow",
    tokenizer_config: Optional[TokenizerConfig] = None,
    directions: Optional[Dict[str, str]] = None,  # score_name -> musicxml path
    splits: Optional[Dict[str, float]] = None,
    seed: int = 23,
    workers: int = 0,
) -> str:
    """Tokenize score/performance MIDI pairs into a training dataset.

    `workers > 1` fans pieces out over a spawn-based process pool (pieces are
    independent; all writes go to distinct files and the manifests are
    assembled in input order, so outputs are byte-identical to the serial run
    — tests/test_prepare.py::test_parallel_workers_identical_outputs). Each
    worker pays a one-time ~3 s package-import startup, so it only pays off
    for corpora with many/large pieces on multi-core hosts; the CI host here
    is single-core (no speedup is measurable on it), so the default stays
    serial. Set workers ~= physical cores for real corpus preparation.
    """
    os.makedirs(output_root, exist_ok=True)
    tokenizer = TOKENIZERS[tokenization](
        tokenizer_config or TokenizerConfig(additional_params={"max_bar_embedding": 256})
    )
    config_path = os.path.join(output_root, "config.json")
    tokenizer.save(config_path)

    metadata: Dict[str, List[str]] = {}
    bars: Dict[str, int] = {}
    initial_tempos: Dict[str, float] = {}
    directions_dict: Dict[str, list] = {}

    tasks = [
        (
            score_name,
            score_path,
            perf_paths,
            output_root,
            config_path,
            directions.get(score_name) if directions else None,
        )
        for score_name, score_path, perf_paths in pairs
    ]
    if workers and int(workers) > 1 and len(tasks) > 1:
        # spawn (not fork): a forked child would inherit the parent's live
        # CUDA context, which it cannot use; tokenization is pure host work
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=int(workers), mp_context=mp.get_context("spawn")
        ) as pool:
            results = list(pool.map(_piece_worker, tasks))
    else:
        results = [
            _prepare_piece(tokenizer, name, spath, perfs, output_root, dpath)
            for name, spath, perfs, _, _, dpath in tasks
        ]

    for score_name, perf_names, piece_bars, piece_tempos, piece_directions in results:
        metadata[score_name] = perf_names
        bars.update(piece_bars)
        initial_tempos.update(piece_tempos)
        if piece_directions is not None:
            directions_dict[score_name] = piece_directions

    if splits:
        names = sorted(metadata)
        rng = np.random.RandomState(seed)
        rng.shuffle(names)
        out = {}
        start = 0
        items = list(splits.items())
        for i, (split, ratio) in enumerate(items):
            end = len(names) if i == len(items) - 1 else start + max(1, round(ratio * len(names)))
            out[split] = {n: metadata[n] for n in names[start:end]}
            start = end
        dump_json(out, os.path.join(output_root, "metadata.json"))
    else:
        dump_json(metadata, os.path.join(output_root, "metadata.json"))

    dump_json(bars, os.path.join(output_root, "bars.json"))
    dump_json(initial_tempos, os.path.join(output_root, "initial_tempos.json"))
    if directions_dict:
        dump_json(directions_dict, os.path.join(output_root, "score_directions.json"))

    return output_root

# Verbatim copy of scoreperformer_tpu/data/directions.py; the port imports nothing of the JAX package.
"""Musical-direction label maps.

Counterpart of scoreperformer/data/datasets/directions.py:16-98: converts
per-score direction dicts ({type, start, end} tick ranges or {type, offset}
note articulations) into per-note / per-bar binary maps.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils import find_closest


def _map_for(maps: dict, key: str, width: int) -> np.ndarray:
    # lazy zeros: setdefault would allocate a fresh O(width) array on every
    # marking even when the key already exists
    m = maps.get(key)
    if m is None:
        m = maps[key] = np.zeros(width)
    return m


def build_score_direction_maps(
    sp_dataset,
    score_directions_dict: Dict[str, List[dict]],
    direction_keys: Optional[List[str]] = None,
    bar_stretch: Optional[int] = None,
    time_division: int = 480,
):
    per_score_bar, per_score_note = [], []
    per_key_bar, per_key_note = {}, {}

    for score_idx, score in enumerate(sp_dataset.score_names):
        score_seq = sp_dataset.scores[score_idx]
        ticks_data = sp_dataset.tokenizer.compute_ticks(score_seq, time_division=time_division)
        note_ticks, bar_ticks = ticks_data["note_on"], ticks_data["bar"]
        n_bars, n_notes = bar_ticks.shape[0] - 1, score_seq.shape[0]

        marks = score_directions_dict.get(score, [])
        if len(marks) and isinstance(marks[0], list):
            marks = [m for part in marks for m in part]

        bar_maps, note_maps = {}, {}
        for mark in marks:
            key = mark["type"]
            if direction_keys is not None and key not in direction_keys:
                continue

            if mark.get("end") is not None:  # ranged markings
                lo = int(find_closest(bar_ticks, mark["start"]))
                hi = max(int(find_closest(bar_ticks, mark["end"])), lo + 1)
                if bar_stretch is not None:
                    hi = min(hi, lo + 1 + bar_stretch)
                _map_for(bar_maps, key, n_bars)[lo:hi] = 1

                covered = (mark["start"] <= note_ticks) & (note_ticks <= mark["end"])
                _map_for(note_maps, key, n_notes)[covered] = 1

            elif mark.get("offset") is not None:  # note articulation
                _map_for(note_maps, key, n_notes)[mark["offset"]] = 1

        per_score_bar.append(dict(sorted(bar_maps.items())))
        per_score_note.append(dict(sorted(note_maps.items())))

        for store, maps in ((per_key_bar, bar_maps), (per_key_note, note_maps)):
            for key, active in maps.items():
                rows = store.setdefault(key, [])
                if active.any():
                    rows.append((score_idx, active))

    return {
        "score": {"bar": per_score_bar, "note": per_score_note},
        "direction": {
            "bar": dict(sorted(per_key_bar.items())),
            "note": dict(sorted(per_key_note.items())),
        },
    }


def _units_in_score(sp_dataset, score_idx: int, level: str) -> int:
    """Embedding rows one performance of this score contributes: bars (from
    the last Bar token) or notes."""
    score_seq = sp_dataset.scores[score_idx]
    if level == "bar":
        return int(score_seq[-1, 0]) - sp_dataset.tokenizer.zero_token + 1
    return int(score_seq.shape[0])


def get_performance_idx_map(sp_dataset, level: str = "bar") -> np.ndarray:
    """(directions.py:146-155)"""
    rows = []
    for score_idx, score in enumerate(sp_dataset.score_names):
        width = _units_in_score(sp_dataset, score_idx, level)
        for perf in sp_dataset.metadata[score]:
            rows.append(np.full(width, sp_dataset.performances._name_to_idx[perf]))
    return np.concatenate(rows, axis=0)


def get_direction_performances_map(
    sp_dataset, score_direction_maps, key: str, level: str = "bar"
) -> np.ndarray:
    """(directions.py:124-143)"""
    rows = []
    for score_idx, score in enumerate(sp_dataset.score_names):
        per_key = score_direction_maps[score_idx]
        active = per_key.get(key)
        if active is None:
            active = np.zeros(_units_in_score(sp_dataset, score_idx, level))
        rows.extend([active] * len(sp_dataset.metadata[score]))
    return np.concatenate(rows, axis=0).astype(bool)


class DirectionBarEmbeddingDataset:
    """(embedding, direction-label) pairs from precomputed bar embeddings with
    negative sampling (directions.py:158-286)."""

    def __init__(
        self,
        sp_dataset,
        direction_keys: List[str],
        embeddings: np.ndarray,
        score_directions_dict=None,
        direction_bar_stretch: Optional[int] = None,
        remove_multi_label: bool = False,
        negative_samples: float = 1.0,
        num_prev_embeddings: int = 0,
        seed: int = 23,
    ):
        from ..utils import load_json
        from pathlib import Path

        self.sp_dataset = sp_dataset
        self.direction_keys = direction_keys
        self.embeddings = np.asarray(embeddings)
        self._rng = np.random.RandomState(seed)

        if isinstance(score_directions_dict, (str, Path)):
            score_directions_dict = load_json(score_directions_dict)

        self.score_direction_maps = build_score_direction_maps(
            sp_dataset, score_directions_dict, bar_stretch=direction_bar_stretch
        )["score"]["bar"]

        self.perf_ids = get_performance_idx_map(sp_dataset)

        direction_maps = [
            (key, get_direction_performances_map(sp_dataset, self.score_direction_maps, key))
            for key in direction_keys
        ]

        uncovered = np.ones(self.embeddings.shape[0], dtype=bool)
        for _, active in direction_maps:
            uncovered &= ~active
        direction_maps.insert(0, (None, uncovered))

        if remove_multi_label:
            hits = np.zeros(self.embeddings.shape[0], dtype=np.int64)
            for _, active in direction_maps:
                hits += active.astype(np.int64)
            direction_maps = [(key, active & (hits == 1)) for key, active in direction_maps]

        self.direction_maps = dict(direction_maps)
        self.labels = {key: i for i, key in enumerate(self.direction_maps)}
        self.inv_labels = {i: key for i, key in enumerate(self.direction_maps)}

        direction_numbers = {
            key: int(dir_map.sum()) for key, dir_map in self.direction_maps.items()
        }
        num_dir_embs = sum(n for key, n in direction_numbers.items() if key is not None)
        direction_numbers[None] = min(
            int(self.direction_maps[None].sum()), int(negative_samples * num_dir_embs)
        )
        self.direction_numbers = direction_numbers
        self._length = sum(direction_numbers.values())

        keys_flat: list = []
        ids_parts = []
        for key, active in self.direction_maps.items():
            if key is None:
                continue
            keys_flat += [key] * direction_numbers[key]
            ids_parts.append(np.flatnonzero(active))
        keys_flat += [None] * direction_numbers[None]
        ids_parts.append(np.full(direction_numbers[None], -1))

        self._sample_keys = keys_flat
        self._sample_ids = np.concatenate(ids_parts) if ids_parts else np.empty(0, int)
        self._nodir_ids = np.flatnonzero(self.direction_maps[None])
        self.num_prev_embeddings = num_prev_embeddings

    def get_emb_by_idx(self, emb_idx: int):
        if self.num_prev_embeddings <= 0:
            return self.embeddings[emb_idx]
        # walk back up to num_prev_embeddings rows, staying inside the same
        # performance's embedding block
        lo = emb_idx
        owner = self.perf_ids[emb_idx]
        while emb_idx - lo < self.num_prev_embeddings and lo > 0 and self.perf_ids[lo - 1] == owner:
            lo -= 1
        return self.embeddings[lo : emb_idx + 1]

    def __getitem__(self, idx):
        label = self._sample_keys[idx]
        if label is None:
            emb_idx = int(self._nodir_ids[self._rng.randint(0, max(1, self.direction_numbers[None]))])
        else:
            emb_idx = int(self._sample_ids[idx])
        return emb_idx, self.get_emb_by_idx(emb_idx), self.labels[label]

    def __len__(self):
        return self._length


class DirectionEmbeddingCollator:
    """(collators/directions.py:6-33)"""

    def __call__(self, batch):
        ids = np.array([b[0] for b in batch])
        embeddings = np.stack([np.asarray(b[1]) for b in batch])
        labels = np.array([b[2] for b in batch])
        return {"ids": ids, "embeddings": embeddings, "labels": labels}

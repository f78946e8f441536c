# Verbatim copy of scoreperformer_tpu/tokenizers/classes.py; the port imports nothing of the JAX package.
"""Token sequence container and constants.

Counterpart of reference data/tokenizers/classes.py + constants.py, with token
ids held in a numpy (N, S) matrix instead of nested lists — the natural form
for a vectorized/JAX pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

SPECIAL_TOKENS = ["PAD", "MASK", "SOS", "EOS"]
PAD, MASK, SOS, EOS = 0, 1, 2, 3
NUM_SPECIAL = len(SPECIAL_TOKENS)

TIME_DIVISION = 480

SCORE_KEYS = [
    "Bar",
    "Position",
    "Pitch",
    "Velocity",
    "Duration",
    "Tempo",
    "TimeSig",
    "Program",
    "PositionShift",
    "NotesInOnset",
    "PositionInOnset",
]
PERFORMANCE_KEYS = SCORE_KEYS + [
    "OnsetDev",
    "PerfDuration",
    "RelOnsetDev",
    "RelPerfDuration",
]


@dataclass
class TokSequence:
    """A tokenized piece: ``ids[n, s]`` = token id of note ``n`` in stream ``s``."""

    ids: np.ndarray
    meta: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        self.ids = np.asarray(self.ids, dtype=np.int64)
        if self.ids.ndim == 1:
            self.ids = self.ids[None, :]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx) -> "TokSequence":
        return TokSequence(np.atleast_2d(self.ids[idx]), dict(self.meta))

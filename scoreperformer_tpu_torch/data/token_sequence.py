# Verbatim copy of scoreperformer_tpu/data/token_sequence.py; the port imports nothing of the JAX package.
"""Lazy/cached per-file token-sequence storage
(counterpart of scoreperformer/data/datasets/token_sequence.py)."""
from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from ..utils import load_json


def load_tokens_np(path) -> np.ndarray:
    """Load a token matrix from .json ({'ids': [[...]]}) or .npy."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path)
    data = load_json(path)
    if isinstance(data, list):
        return np.array(data[0])
    return np.array(data["ids"])


def load_token_sequence(path, load_fn=load_tokens_np, processing_funcs=None) -> np.ndarray:
    seq = load_fn(path)
    if processing_funcs:
        for func in processing_funcs:
            seq = func(seq)
    return seq


class TokenSequenceDataset:
    def __init__(self, sequences: List[np.ndarray], names: Optional[List[str]] = None):
        self.seqs = sequences
        self.names = names
        if names is not None:
            self._name_to_idx = {name: idx for idx, name in enumerate(names)}

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.seqs[idx]

    def __len__(self) -> int:
        return len(self.seqs)


class LocalTokenSequenceDataset(TokenSequenceDataset):
    def __init__(
        self,
        root,
        files: Optional[List[str]] = None,
        suffix: str = ".json",
        load_fn: Callable = load_token_sequence,
        preload: bool = False,
        cache: bool = True,
    ):
        self.root = root
        self.load_fn = load_fn
        self._cache = cache

        if files is None:
            files = sorted(Path(root).glob("**/*" + suffix))
            files = [p.relative_to(root) for p in files]
        else:
            files = [Path(f).with_suffix(suffix) for f in files]

        self.paths = [os.path.join(str(root), str(f)) for f in files]
        names = [str(f)[: -len(suffix)] for f in files]

        seqs = (
            [self.load_fn(p) for p in self.paths] if preload else [None] * len(self.paths)
        )
        super().__init__(sequences=seqs, names=names)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self.seqs[idx] is None:
            seq = self.load_fn(self.paths[idx])
            if self._cache:
                self.seqs[idx] = seq
            return seq
        return self.seqs[idx]

# Verbatim copy of scoreperformer_tpu/utils/functions.py; the port imports nothing of the JAX package.
"""Generic helpers used throughout the framework.

Behavioral counterparts of the reference's utility layer
(scoreperformer/utils/functions.py:12-88), re-implemented for a
numpy/JAX-first codebase.
"""
from __future__ import annotations

import inspect
import sys
from enum import Enum
from random import random as _uniform

import numpy as np


def exists(val) -> bool:
    return val is not None


def default(val, fallback):
    if val is not None:
        return val
    # a callable fallback is invoked lazily so expensive defaults only
    # materialize when actually needed
    if inspect.isfunction(fallback):
        return fallback()
    return fallback


def or_reduce(masks):
    acc = masks[0]
    for m in masks[1:]:
        acc = acc | m
    return acc


def prob2bool(prob: float) -> bool:
    return _uniform() < prob


def find_closest(array: np.ndarray, values) -> np.ndarray:
    """Indices of the nearest bins in a sorted ``array`` for each of ``values``.

    Ties resolve to the *right* bin (the larger value), matching the reference
    semantics (scoreperformer/utils/functions.py:41-57). Works on scalars and
    arrays.

    Implemented as a two-candidate comparison: for each value take the first
    bin >= value (clamped in range) and its left neighbour, then keep
    whichever is strictly nearer — the right candidate on ties.
    """
    bins = np.asarray(array)
    vals = np.asarray(values, dtype=np.float64)
    last = bins.shape[0] - 1

    right = np.clip(np.searchsorted(bins, vals, side="left"), 0, last)
    left = np.clip(right - 1, 0, last)
    nearer_left = np.abs(vals - bins[left]) < np.abs(vals - bins[right])
    out = np.where(nearer_left, left, right)

    if out.ndim == 0 and np.ndim(values) == 0:
        return out[()]
    return out


def apply(seqs, func, desc=None, progress: bool = False):
    """Apply ``func`` over ``seqs`` (optionally with a progress meter)."""
    if progress:
        try:
            from tqdm import tqdm

            seqs = tqdm(seqs, desc=desc, file=sys.stdout, leave=False)
        except ImportError:
            pass
    return [func(item) for item in seqs]


class ExplicitEnum(str, Enum):
    """String enum that names its valid members when lookup fails."""

    @classmethod
    def _missing_(cls, value):
        valid = ", ".join(repr(m.value) for m in cls)
        raise ValueError(
            f"unknown {cls.__name__} value {value!r}; expected one of: {valid}"
        )

    @classmethod
    def has_value(cls, value) -> bool:
        return any(m.value == value for m in cls)

    @classmethod
    def list(cls):
        return [m.value for m in cls]

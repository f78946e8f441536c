# Verbatim copy of scoreperformer_tpu/tokenizers/native.py; the port imports nothing of the JAX package.
"""ctypes loader for the native SPMuple2 tempo-scan core (_native/spm2_scan.cpp).

Same compile-on-first-use scheme as midi/native.py (hash-keyed cache, soft
failure back to the Python scan). The native scan engages only for
quantized-tempo configs, where its sequential float64 ops reproduce the
Python scan bit-for-bit (tests/test_native_scan.py); set SP_NATIVE_SCAN=0 to
force the Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "_native", "spm2_scan.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None


def _build_lib() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = os.environ.get(
        "SP_NATIVE_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "sp_tpu")
    )
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"spm2_scan_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".build.{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.spm2_tempo_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,            # pairs, K
        ctypes.c_void_p, ctypes.c_void_p,           # note_times, group_off
        ctypes.c_double, ctypes.c_double,           # initial_tempo, tempo_scale
        ctypes.c_int32, ctypes.c_double,            # limit_devs, dev_limit
        ctypes.c_int32,                             # onset_tempos
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,  # window, min_dist, min_onsets
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,  # quantize, bins, n, min_tempo
        ctypes.c_void_p, ctypes.c_void_p,           # tempos, cum_offsets
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                _LIB = _build_lib()
            except Exception as e:  # noqa: BLE001 — soft-fail to the Python scan
                _LIB_ERR = f"{type(e).__name__}: {e}"
    return _LIB


def native_available() -> bool:
    return get_lib() is not None


def tempo_scan_native(
    pairs: np.ndarray,
    grouped_note_times,
    initial_tempo: float,
    tempo_scale: float,
    *,
    limit_devs: bool,
    dev_limit: float,
    onset_tempos: bool,
    tempo_window: float,
    min_onset_dist: float,
    min_onsets: int,
    quantize: bool,
    bins: np.ndarray,
    min_tempo: float,
):
    """Run the native scan; mutates ``pairs[:, 1]`` in place like the Python
    scan and returns (tempos, cum_offsets)."""
    lib = get_lib()
    assert lib is not None
    K = len(pairs) - 1
    assert pairs.dtype == np.float64 and pairs.flags.c_contiguous

    lengths = np.fromiter((len(g) for g in grouped_note_times), np.int64, K)
    group_off = np.zeros(K + 1, np.int64)
    np.cumsum(lengths, out=group_off[1:])
    flat = (
        np.concatenate(grouped_note_times)
        if K and group_off[-1]
        else np.empty(0, np.float64)
    )
    flat = np.ascontiguousarray(flat, np.float64)
    bins = np.ascontiguousarray(bins, np.float64)

    tempos = np.empty(K + 1, np.float64)
    cum_offsets = np.zeros(K, np.float64)
    lib.spm2_tempo_scan(
        pairs.ctypes.data, K,
        flat.ctypes.data, group_off.ctypes.data,
        float(initial_tempo), float(tempo_scale),
        int(limit_devs), float(dev_limit),
        int(onset_tempos),
        float(tempo_window), float(min_onset_dist), int(min_onsets),
        int(quantize), bins.ctypes.data, len(bins), float(min_tempo),
        tempos.ctypes.data, cum_offsets.ctypes.data,
    )
    return tempos, cum_offsets

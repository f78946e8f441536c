# Verbatim copy of scoreperformer_tpu/midi/native.py; the port imports nothing of the JAX package.
"""ctypes loader for the native SMF parser (_native/smf.cpp).

Compiles the C++ source on first use with the system toolchain into a cache
directory (keyed by a hash of the source, so edits recompile automatically)
and exposes `read_midi_native`, a drop-in counterpart of the Python parser in
smf.py — same grouping, ordering, and meta-event semantics (parity-tested in
tests/test_native_smf.py). If no compiler is available the import-time probe
fails soft and the pure-Python parser keeps serving.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .containers import Marker, MidiScore, NoteArray, TempoMap, TimeSigMap, Track

_SRC = os.path.join(os.path.dirname(__file__), "_native", "smf.cpp")
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
    so_path = os.path.join(cache_dir, f"smf_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".build.{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so_path)  # atomic for concurrent builders
    lib = ctypes.CDLL(so_path)

    lib.smf_parse.restype = ctypes.c_void_p
    lib.smf_parse.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.smf_free.argtypes = [ctypes.c_void_p]
    lib.smf_division.restype = ctypes.c_int32
    lib.smf_division.argtypes = [ctypes.c_void_p]
    lib.smf_group_count.restype = ctypes.c_int32
    lib.smf_group_count.argtypes = [ctypes.c_void_p]
    lib.smf_group_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.smf_group_name.restype = ctypes.c_char_p
    lib.smf_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.smf_group_notes.argtypes = [ctypes.c_void_p, ctypes.c_int32] + [ctypes.c_void_p] * 4
    lib.smf_group_ccs.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.smf_group_pbs.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.smf_tempo_count.restype = ctypes.c_int64
    lib.smf_tempo_count.argtypes = [ctypes.c_void_p]
    lib.smf_tempos.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.smf_timesig_count.restype = ctypes.c_int64
    lib.smf_timesig_count.argtypes = [ctypes.c_void_p]
    lib.smf_timesigs.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.smf_keysig_count.restype = ctypes.c_int64
    lib.smf_keysig_count.argtypes = [ctypes.c_void_p]
    lib.smf_keysig.restype = ctypes.c_char_p
    lib.smf_keysig.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.smf_marker_count.restype = ctypes.c_int64
    lib.smf_marker_count.argtypes = [ctypes.c_void_p]
    lib.smf_marker.restype = ctypes.c_void_p  # raw pointer, may contain NULs
    lib.smf_marker.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, or None when unavailable (no toolchain, etc.)."""
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                _LIB = _build_lib()
            except Exception as e:  # noqa: BLE001 — soft-fail to the Python parser
                _LIB_ERR = f"{type(e).__name__}: {e}"
    return _LIB


def native_available() -> bool:
    return get_lib() is not None


def read_midi_native(path_or_bytes) -> MidiScore:
    """Parse an SMF file with the C++ parser into a :class:`MidiScore`."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native SMF parser unavailable: {_LIB_ERR}")

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    err = ctypes.create_string_buffer(256)
    handle = lib.smf_parse(data, len(data), err, 256)
    if not handle:
        raise ValueError(err.value.decode("latin-1") or "failed to parse MIDI")
    try:
        score = MidiScore(ticks_per_beat=int(lib.smf_division(handle)))

        for i in range(int(lib.smf_group_count(handle))):
            program = ctypes.c_int32()
            is_drum = ctypes.c_int32()
            n_notes = ctypes.c_int64()
            n_ccs = ctypes.c_int64()
            n_pbs = ctypes.c_int64()
            lib.smf_group_info(handle, i, ctypes.byref(program), ctypes.byref(is_drum),
                               ctypes.byref(n_notes), ctypes.byref(n_ccs), ctypes.byref(n_pbs))
            n = n_notes.value
            pitch = np.empty(n, np.int32)
            velocity = np.empty(n, np.int32)
            start = np.empty(n, np.int64)
            end = np.empty(n, np.int64)
            if n:
                lib.smf_group_notes(
                    handle, i,
                    pitch.ctypes.data_as(ctypes.c_void_p),
                    velocity.ctypes.data_as(ctypes.c_void_p),
                    start.ctypes.data_as(ctypes.c_void_p),
                    end.ctypes.data_as(ctypes.c_void_p),
                )
            track = Track(
                notes=NoteArray(pitch, velocity, start, end),
                program=int(program.value),
                is_drum=bool(is_drum.value),
                name=(lib.smf_group_name(handle, i) or b"").decode("latin-1"),
            )
            if n_ccs.value:
                ccs = np.empty((n_ccs.value, 3), np.int64)
                lib.smf_group_ccs(handle, i, ccs.ctypes.data_as(ctypes.c_void_p))
                track.control_changes = ccs
                from .ops import derive_sustain_pedals

                track.pedals = derive_sustain_pedals(ccs)
            if n_pbs.value:
                pbs = np.empty((n_pbs.value, 2), np.int64)
                lib.smf_group_pbs(handle, i, pbs.ctypes.data_as(ctypes.c_void_p))
                track.pitch_bends = pbs
            score.tracks.append(track)

        n_t = int(lib.smf_tempo_count(handle))
        if n_t:
            ticks = np.empty(n_t, np.int64)
            bpm = np.empty(n_t, np.float64)
            lib.smf_tempos(handle, ticks.ctypes.data_as(ctypes.c_void_p),
                           bpm.ctypes.data_as(ctypes.c_void_p))
            score.tempos = TempoMap(ticks.tolist(), bpm.tolist())

        n_ts = int(lib.smf_timesig_count(handle))
        if n_ts:
            ticks = np.empty(n_ts, np.int64)
            num = np.empty(n_ts, np.int32)
            den = np.empty(n_ts, np.int32)
            lib.smf_timesigs(handle, ticks.ctypes.data_as(ctypes.c_void_p),
                             num.ctypes.data_as(ctypes.c_void_p),
                             den.ctypes.data_as(ctypes.c_void_p))
            score.time_sigs = TimeSigMap(ticks.tolist(), num.tolist(), den.tolist())

        key_sigs = []
        for i in range(int(lib.smf_keysig_count(handle))):
            tick = ctypes.c_int64()
            name = lib.smf_keysig(handle, i, ctypes.byref(tick))
            key_sigs.append((int(tick.value), (name or b"").decode("latin-1")))
        score.key_sigs = key_sigs

        markers = []
        for i in range(int(lib.smf_marker_count(handle))):
            tick = ctypes.c_int64()
            textlen = ctypes.c_int64()
            ptr = lib.smf_marker(handle, i, ctypes.byref(tick), ctypes.byref(textlen))
            text = ctypes.string_at(ptr, textlen.value).decode("latin-1") if ptr else ""
            markers.append(Marker(int(tick.value), text))
        score.markers = markers

        score.recompute_max_tick()
        return score
    finally:
        lib.smf_free(handle)

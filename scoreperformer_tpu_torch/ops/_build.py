"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc` into a
shared library of its own, loaded with `ctypes`; no source includes PyTorch's
headers, so a build takes seconds. All sources compile in parallel, one `nvcc`
each, at first use. Outputs go to `build/torch_kernels/` at the repository
root, keyed by a hash of the source and flags, so an edit rebuilds. `nvcc`'s
`-Xptxas=-v` report (registers, shared memory, spills) is kept beside each
library as `<name>_<hash>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_FLASH_BWD_ARGS = [_P] * 10 + [_I] * 7 + [_F, _P]
# C signatures of each library's entry points: {library: {symbol: argtypes}}
ENTRY_POINTS = {
    "kv_cache": {"sp_write_kv": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _P]},
    "flash_attention_fwd": {
        "sp_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    },
    "flash_attention_bwd": {
        "sp_flash_attention_bwd_dkv": _FLASH_BWD_ARGS,
        "sp_flash_attention_bwd_dq": _FLASH_BWD_ARGS,
    },
}

_lock = threading.Lock()
_loaded: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}_{tag}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel source that has no current library, all in
    parallel; raise with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in ENTRY_POINTS:
        so = library_path(name)
        if so.exists():
            continue
        tmp = Path(f"{so}.build.{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending[name] = (so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for name, (so, tmp, proc) in pending.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, so)  # atomic for concurrent builders
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in ENTRY_POINTS}


def kernel(library: str, symbol: str):
    """The C entry point `symbol` of kernel library `library`, built on first use."""
    with _lock:
        fn = _loaded.get((library, symbol))
        if fn is None:
            path = build_all()[library]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = ENTRY_POINTS[library][symbol]
            fn.restype = ctypes.c_int
            _loaded[(library, symbol)] = fn
        return fn

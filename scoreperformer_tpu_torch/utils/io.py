# Copy of scoreperformer_tpu/utils/io.py (the port imports nothing of the JAX package), but
# `dump_json` replaces the file in one step: ranks that build one dataset side by side write its
# auxiliary JSON files while the others read them.
"""JSON / file IO helpers (counterpart of scoreperformer/utils/io.py)."""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Union

import numpy as np

PathLike = Union[str, Path]


class NumpyJSONEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def load_json(path: PathLike) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def dump_json(obj: Any, path: PathLike, indent: int = 2) -> None:
    """Write `obj` as JSON; a reader sees the old file or the whole new one."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent, cls=NumpyJSONEncoder)
    os.replace(tmp, path)

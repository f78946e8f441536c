"""Checkpoints with `torch.save`.

Counterpart of scoreperformer_tpu/training/checkpoint.py. A checkpoint is a
directory (`checkpoint_last`, `checkpoint_best`, `checkpoint_<step>`, the
trainer's names) holding
- `params.pt`: {"model": {"config", "state_dict"}}, the reference's
  single-file layout with reference parameter names, so
  `inference.load_model_from_checkpoint(<dir>/params.pt)` renders from it;
- `opt_state.pt`: the optimizer's state, when the trainer saves it;
- `meta.json`: trainer state and model config.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..utils import dump_json, load_json


def save_checkpoint(
    directory: str,
    model: torch.nn.Module,
    optimizer=None,
    trainer_state: Optional[Dict] = None,
    model_config: Optional[Dict] = None,
) -> str:
    """Write a checkpoint directory, replacing one that exists; returns its path."""
    directory = os.path.abspath(directory)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.makedirs(directory)
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": {"config": model_config, "state_dict": state_dict}},
               os.path.join(directory, "params.pt"))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(directory, "opt_state.pt"))
    meta: Dict[str, Any] = {}
    if trainer_state is not None:
        meta["trainer_state"] = trainer_state
    if model_config is not None:
        meta["model_config"] = model_config
    dump_json(meta, os.path.join(directory, "meta.json"))
    return directory


def load_checkpoint(directory: str) -> Dict[str, Any]:
    """{"params": state dict, "opt_state": optimizer state (if saved), and the
    meta.json entries ("trainer_state", "model_config")}, on the CPU."""
    directory = os.path.abspath(directory)
    out: Dict[str, Any] = {}
    params = os.path.join(directory, "params.pt")
    if os.path.exists(params):
        out["params"] = torch.load(params, map_location="cpu", weights_only=False)["model"]["state_dict"]
    opt = os.path.join(directory, "opt_state.pt")
    if os.path.exists(opt):
        out["opt_state"] = torch.load(opt, map_location="cpu", weights_only=False)
    meta = os.path.join(directory, "meta.json")
    if os.path.exists(meta):
        out.update(load_json(meta))
    return out

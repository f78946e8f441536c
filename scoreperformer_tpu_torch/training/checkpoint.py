"""Checkpoints with `torch.save`.

Counterpart of scoreperformer_tpu/training/checkpoint.py. A checkpoint is a
directory (`checkpoint_last`, `checkpoint_best`, `checkpoint_<step>`, the
trainer's names) holding
- `params.pt`: {"model": {"config", "state_dict"}}, the reference's
  single-file layout with reference parameter names, so
  `inference.load_model_from_checkpoint(<dir>/params.pt)` renders from it;
- `opt_state.pt`: the optimizer's state, when the trainer saves it;
- `meta.json`: trainer state and model config.
A reference `.pt` file loads as a checkpoint of its parameters alone.

`warm_start_params` and `freeze_mask` are copies of the JAX package's
(scoreperformer_tpu/training/checkpoint.py:183-237), on nested dicts of flax
paths; `jax_tree` and `from_jax_tree` carry a port model's parameters to and
from such a tree (`convert.jax_param_paths`), so one regex list or ignore list
picks the same parameters in both packages.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
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
    meta.json entries ("trainer_state", "model_config")}, on the CPU. A file
    is read as a reference `.pt` ({"model": {"state_dict"}}): its params only."""
    directory = os.path.abspath(directory)
    if os.path.isfile(directory):
        return {"params": torch.load(directory, map_location="cpu", weights_only=False)["model"]["state_dict"]}
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


# ---- warm starts and fine-tuning, on flax paths ----


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/" if prefix or True else k))
    else:
        out[prefix[:-1]] = tree
    return out


def warm_start_params(
    params,
    loaded_params,
    ignore_layers: Optional[List[str]] = None,
    ignore_mismatched: bool = True,
    verbose: bool = True,
):
    """Copy matching keys from `loaded_params` into `params`, skipping listed
    or shape-mismatched keys (reference base.py:54-93)."""
    ignore_layers = ignore_layers or []

    flat_new = _flatten(params)
    flat_old = _flatten(loaded_params)

    used = {}
    skipped = []
    for key, value in flat_new.items():
        if key in flat_old and not any(re.search(p, key) for p in ignore_layers):
            old = flat_old[key]
            if tuple(np.shape(old)) == tuple(np.shape(value)):
                used[key] = old
                continue
            if not ignore_mismatched:
                raise ValueError(f"shape mismatch for {key}: {np.shape(old)} vs {np.shape(value)}")
        skipped.append(key)

    if verbose and skipped:
        print(f"warm start: skipped {len(skipped)} keys (e.g. {skipped[:5]})")

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        key = prefix[:-1]
        return used.get(key, tree)

    return rebuild(params)


def freeze_mask(params, finetune_layers: List[str]):
    """True = trainable. When `finetune_layers` is non-empty, only matching
    paths train (reference trainer.py:386-387 + base.py:95-102)."""
    flat = _flatten(params)
    decisions = {
        key: not finetune_layers or any(re.search(p, key) for p in finetune_layers) for key in flat
    }

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        return decisions[prefix[:-1]]

    return rebuild(params)


def jax_tree(model: torch.nn.Module, state_dict: Optional[Dict[str, Any]] = None):
    """A nested dict of flax paths holding `model`'s parameters, or with
    `state_dict` the entries of that state dict (port names) that name one of
    them, each in the port's layout (a transpose keeps a shape mismatch a
    mismatch)."""
    from ..convert import jax_param_paths

    aliases = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        aliases.setdefault(id(p), []).append(name)
    own = dict(model.named_parameters())
    tree: Dict[str, Any] = {}
    for name, (path, _) in jax_param_paths(model).items():
        if state_dict is None:
            value = own[name].detach()
        else:
            hit = next((n for n in aliases[id(own[name])] if n in state_dict), None)
            if hit is None:
                continue
            value = state_dict[hit]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def from_jax_tree(model: torch.nn.Module, tree) -> Dict[str, Any]:
    """{port name: value} of a nested dict of flax paths over `model`'s
    parameters (the inverse of `jax_tree`)."""
    from ..convert import jax_param_paths

    flat = _flatten(tree)
    return {name: flat["/".join(path)] for name, (path, _) in jax_param_paths(model).items()}

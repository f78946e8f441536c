"""Checkpoints with `torch.save`.

Counterpart of scoreperformer_tpu/training/checkpoint.py. A checkpoint is a
directory (`checkpoint_last`, `checkpoint_best`, `checkpoint_<step>`, the
trainer's names) holding
- `params.pt`: {"model": {"config", "state_dict"}}, the reference's
  single-file layout with reference parameter names, so
  `inference.load_model_from_checkpoint(<dir>/params.pt)` renders from it;
- `opt_state.pt`: the optimizer's state, when the trainer saves it;
- `meta.json`: trainer state and model config.
On a mesh (`parallel/mesh.py`), rank 0 gathers the model's and expert
axes' shards and the ZeRO slices into this one-device layout and writes it
alone. A `sharded` checkpoint (orbax's sharded save in the JAX package)
holds instead every rank's own blocks, `shards/rank_<r>.pt` ({"params":
its state dict, "opt_state": its optimizer state, "zero_split": the ZeRO
dim of each sliced parameter}), and `index.json` (the saving mesh and
which axis and dim split each parameter): `load_checkpoint` joins them into
whole tensors, which a run on any mesh then cuts to its own blocks, as
JAX's `restore_sharded` lays shards on the restoring mesh.
With `use_async`, tensors are copied to host memory before the call returns
and the files are written on a background thread (orbax's async commit);
`wait_for_async_saves()` blocks until every queued write is on disk. A save
first waits for the one before it, and every load waits for all.
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
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel.collectives import all_gather_list
from ..parallel.mesh import AXES, mesh_layout
from ..parallel.shard import Shard, gather_state_dict
from ..utils import dump_json, load_json

_writer: Optional[ThreadPoolExecutor] = None
_pending: List[Future] = []
# optimizer state keys that hold one buffer a parameter (Optimizer._STATE)
_OPT_BUFFERS = ("mu", "nu", "trace", "acc", "v_row", "v_col", "v")


def wait_for_async_saves() -> None:
    """Block until every asynchronous checkpoint write is on disk; a failed
    write raises here."""
    while _pending:
        _pending.pop(0).result()


def _write(jobs: List[Callable[[], None]], use_async: bool) -> None:
    global _writer
    if not use_async:
        for job in jobs:
            job()
        return
    if _writer is None:
        _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
    _pending.extend(_writer.submit(job) for job in jobs)


def _host(tree):
    """A host copy of every tensor of a state (nested dicts)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def save_checkpoint(
    directory: str,
    model: torch.nn.Module,
    optimizer=None,
    trainer_state: Optional[Dict] = None,
    model_config: Optional[Dict] = None,
    extra_meta: Optional[Dict] = None,
    use_async: bool = False,
    sharded: bool = False,
    mesh=None,
    specs: Optional[Dict] = None,
) -> str:
    """Write a checkpoint directory, replacing one that exists; returns its
    path. `extra_meta`'s keys join the meta file's. On a mesh of several
    ranks every rank calls it: the gathers are collective, and rank 0 writes
    the directory (every rank its own shard file when `sharded`)."""
    directory = os.path.abspath(directory)
    wait_for_async_saves()
    multi = mesh is not None and mesh.world > 1
    if multi:
        mesh.barrier()  # every rank's earlier writes are on disk before rank 0 removes the directory
    main = mesh is None or mesh.is_main
    specs = specs or {}
    meta: Dict[str, Any] = {}
    if trainer_state is not None:
        meta["trainer_state"] = trainer_state
    if model_config is not None:
        meta["model_config"] = model_config
    if extra_meta:
        meta.update(extra_meta)
    jobs: List[Callable[[], None]] = []
    if sharded:
        rank = mesh.rank if mesh is not None else 0
        shard = _host({"params": model.state_dict(),
                       "opt_state": optimizer.state_dict() if optimizer is not None else None,
                       "zero_split": {} if optimizer is None else
                       {n: d for n, d in zip(optimizer.names, optimizer.split) if d is not None}})
        index = {"mesh": {a: mesh.size(a) if mesh is not None else 1 for a in AXES},
                 "specs": {k: [v.axis, v.dim, v.halves] for k, v in specs.items()}}
        jobs.append(lambda: torch.save(shard, os.path.join(directory, "shards", f"rank_{rank:05d}.pt")))
        if main:
            jobs += [lambda: dump_json(index, os.path.join(directory, "index.json"))]
    else:
        state_dict = gather_state_dict(model.state_dict(), specs) if multi else model.state_dict()
        opt_state = None
        if optimizer is not None:
            opt_state = whole_opt_state(optimizer, model, specs) if multi else optimizer.state_dict()
        if main:
            params = _host({"model": {"config": model_config, "state_dict": state_dict}})
            jobs.append(lambda: torch.save(params, os.path.join(directory, "params.pt")))
            if opt_state is not None:
                opt_host = _host(opt_state)
                jobs.append(lambda: torch.save(opt_host, os.path.join(directory, "opt_state.pt")))
    if main:
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.makedirs(os.path.join(directory, "shards") if sharded else directory)
        dump_json(meta, os.path.join(directory, "meta.json"))
    if multi and sharded:
        mesh.barrier()  # the directory exists before any rank writes into it
    _write(jobs, use_async)
    return directory


def whole_opt_state(optimizer, model: torch.nn.Module, specs: Dict) -> Dict:
    """The optimizer's state with every buffer whole: its ZeRO slices and
    the model- and expert-axis shards of the per-parameter buffers (those of
    the parameter's shape) joined (collective: every rank calls it)."""
    state = optimizer.full_state_dict()
    shapes = {n: p.shape for n, p in model.named_parameters()}
    out = dict(state)
    for key in _OPT_BUFFERS:
        if state.get(key) is None:
            continue
        out[key] = {n: specs[n].join(all_gather_list(t.to(next(model.parameters()).device), specs[n].axis)).cpu()
                    if n in specs and t.shape == shapes[n] else t for n, t in state[key].items()}
    return out


def shard_opt_state(state: Dict, model: torch.nn.Module, specs: Dict, mesh) -> Dict:
    """This rank's model- and expert-axis blocks of a whole optimizer state
    (the optimizer cuts its ZeRO slices itself)."""
    own = {n: p.shape for n, p in model.named_parameters()}

    def whole_shape(name):
        shape = list(own[name])
        shape[specs[name].dim] *= mesh.size(specs[name].axis)
        return torch.Size(shape)

    out = dict(state)
    for key in _OPT_BUFFERS:
        if state.get(key) is not None:
            out[key] = {n: specs[n].take(t, mesh.size(specs[n].axis), mesh.index(specs[n].axis))
                        if n in specs and t.shape == whole_shape(n) else t for n, t in state[key].items()}
    return out


def load_checkpoint(directory: str) -> Dict[str, Any]:
    """{"params": state dict, "opt_state": optimizer state (if saved), and the
    meta.json entries ("trainer_state", "model_config")}, on the CPU, every
    tensor whole (a sharded checkpoint's blocks joined). A file is read as a
    reference `.pt` ({"model": {"state_dict"}}): its params only. Waits for
    the asynchronous saves first."""
    wait_for_async_saves()
    directory = os.path.abspath(directory)
    if os.path.isfile(directory):
        return {"params": torch.load(directory, map_location="cpu", weights_only=False)["model"]["state_dict"]}
    out: Dict[str, Any] = {}
    if os.path.exists(os.path.join(directory, "index.json")):
        out.update(_join_shards(directory))
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


def _join_shards(directory: str) -> Dict[str, Any]:
    """The whole params and optimizer state of a sharded checkpoint."""
    index = load_json(os.path.join(directory, "index.json"))
    shape = [int(index["mesh"][a]) for a in AXES]
    layout = mesh_layout(*shape)
    shards = [torch.load(os.path.join(directory, "shards", f"rank_{r:05d}.pt"), map_location="cpu",
                         weights_only=False) for r in range(layout.size)]
    specs = {k: Shard(*v) for k, v in index["specs"].items()}

    def along(axis: str, rank: int = 0) -> List[int]:
        """The ranks along `axis` through `rank`'s coordinate."""
        coord = [int(i[0]) for i in np.nonzero(layout == rank)]
        i = AXES.index(axis)
        return [int(layout[tuple(coord[:i] + [j] + coord[i + 1:])]) for j in range(shape[i])]

    def whole(name: str, get: Callable[[int], torch.Tensor]) -> torch.Tensor:
        spec = specs.get(name)
        return get(0) if spec is None else spec.join([get(r) for r in along(spec.axis)])

    out: Dict[str, Any] = {"params": {n: whole(n, lambda r, n=n: shards[r]["params"][n]) for n in shards[0]["params"]}}
    opt = shards[0]["opt_state"]
    if opt is not None:
        opt = dict(opt)
        for key in _OPT_BUFFERS:
            if opt.get(key) is None:
                continue

            def unsliced(r: int, name: str, key=key) -> torch.Tensor:
                t = shards[r]["opt_state"][key][name]
                dim, own = shards[r]["zero_split"].get(name), shards[r]["params"][name].shape
                if dim is None or t.shape == own or t.ndim != len(own):
                    return t
                return torch.cat([shards[q]["opt_state"][key][name] for q in along(AXES[0], r)], dim)

            opt[key] = {n: whole(n, lambda r, n=n: unsliced(r, n))
                        if shards[0]["params"][n].shape == unsliced(0, n).shape else unsliced(0, n)
                        for n in opt[key]}
        out["opt_state"] = opt
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

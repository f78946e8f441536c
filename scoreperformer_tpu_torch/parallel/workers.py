"""Worker functions that `launch` starts on every rank: train steps of a
model through the `Trainer` on a mesh, and steps of a pipelined trunk
(`pipeline_worker`), and report what one process needs to hold them against
a one-process run.

    launch(train_worker, n, (payload_path,))
    launch(pipeline_runs_worker, n, ([payload_path, ...],))

The payload (a `torch.save`d dict) names the model ("model_name",
"model_config", the whole "state_dict" every rank starts from), the
trainer's fields ("trainer": mesh axes, `zero_sharding`, `seed`, the
"optimization" dict, ...), the global "batch" (numpy arrays), "steps", the
"device" ("cuda", the default, or "cpu"), optionally
"checkpoints" (names to save after the steps, each {"name", "sharded",
"async"}), "profile" (time one more step with the collectives timed),
"restore" (a checkpoint directory to load before the steps),
"check_restore" (one to load after everything else, its whole tensors
returned as "restored") and "probe_collectives" (try each collective of the
default group on the device's tensors first, `collective_probe`). Rank 0 returns
the global metrics of each step, the whole gradients of the first step and
the whole parameters (and optimizer state) after the last; every rank
returns its kernel launches, step times and peak memory. `setup(trainer,
payload)`, an importable function, may change the trainer before the steps.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..training.checkpoint import wait_for_async_saves, whole_opt_state
from . import collectives as coll
from .collectives import _all_gather_list, _reduce_scatter_dim, collective_timer, pipe_shift
from .mesh import DATA_AXIS, MODEL_AXIS, current, make_pipeline_mesh, rank_device


def _flash_launches() -> Dict[str, int]:
    from ..ops import flash_attention as fa

    return {name: getattr(fa, name).launches + getattr(fa, name).launches_bf16 + getattr(fa, name).launches_one_pass
            for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")}


def collective_probe(device: torch.device, repeats: int = 5) -> Dict[str, str]:
    """Which collectives the default process group takes on `device`'s
    tensors called as they are (not staged): each "ok" when every one of
    `repeats` calls on 16 MB a rank gave the right values to a checksum
    queued at once on the current stream, "wrong values (k of n)" (the
    result read before it arrived, or a wrong result), or its error."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    width = 1 << 20

    def rows(v):
        return v[:, None].expand(-1, width).contiguous()

    x = rows(torch.arange(4 * world, dtype=torch.float32, device=device) + rank)
    want_sum = rows(torch.arange(4 * world, dtype=torch.float32, device=device) * world + world * (world - 1) / 2)
    others = torch.cat([x - rank + r for r in range(world)])

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return (y - want_sum).abs().sum()

    def all_gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return (torch.cat(out) - others).abs().sum()

    def all_gather_into_tensor():
        out = torch.empty(world * x.shape[0], width, device=device)
        dist.all_gather_into_tensor(out, x)
        return (out - others).abs().sum()

    def reduce_scatter_tensor():
        out = torch.empty(4, width, device=device)
        dist.reduce_scatter_tensor(out, x)
        return (out - want_sum[4 * rank:4 * (rank + 1)]).abs().sum()

    def all_to_all_single():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return (out - torch.cat([(x - rank + r)[4 * rank:4 * (rank + 1)] for r in range(world)])).abs().sum()

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return (y - (x - rank)).abs().sum()

    # the port's own uses: the pipeline's hop (to the next rank, none from
    # the last), and sequence parallelism's gather and reduce-scatter on dim 1
    def pipe_hop():
        got = pipe_shift(x, None, world, rank, 1, rank < world - 1, rank > 0, x)
        return torch.zeros((), device=device) if got is None else (got - (x - 1)).abs().sum()

    seq = x.view(4, world, width)

    def gather_seq():
        got = torch.cat(_all_gather_list(seq, None, world), dim=1)
        return (got - torch.cat([seq - rank + r for r in range(world)], dim=1)).abs().sum()

    def reduce_scatter_seq():
        got = _reduce_scatter_dim(seq, None, world, 1)
        want = want_sum.view(4, world, width)[:, rank:rank + 1]
        return (got - want).abs().sum()

    table = {}
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor), ("all_to_all_single", all_to_all_single),
                     ("broadcast", broadcast), ("pipe_hop", pipe_hop), ("gather_seq", gather_seq),
                     ("reduce_scatter_seq", reduce_scatter_seq)):
        try:
            errors = [fn() for _ in range(repeats)]  # checksums queued before any is read
            wrong = sum(float(e) != 0.0 for e in errors)
            table[name] = "ok" if not wrong else f"wrong values ({wrong} of {repeats})"
        except Exception as err:  # noqa: BLE001 - the table reports it
            table[name] = f"{type(err).__name__}: {str(err)[:120]}"
    return table


def build_trainer(payload: Dict[str, Any], device: torch.device, output_dir: str):
    """The payload's model (whole weights) and a Trainer on the mesh it asks for."""
    from ..convert import load_state_dict
    from ..models.factory import build_model
    from ..training import Trainer, TrainerConfig
    from ..training.optimizers import OptimizerConfig

    model, _ = build_model(payload["model_name"], payload["model_config"], device=device, seed=0)
    load_state_dict(model, payload["state_dict"])
    fields = dict(payload["trainer"])
    opt = OptimizerConfig.from_dict(fields.pop("optimization", {}))
    batch_size = len(next(iter(payload["batch"].values())))
    config = TrainerConfig(output_dir=output_dir, batch_size=batch_size, eval_batch_size=batch_size,
                           tensorboard=False, disable_progress=True, save_optimizer=True, **fields)
    config.optimization = opt
    trainer = Trainer(model, config, model_config={"_name_": payload["model_name"], **payload["model_config"]})
    trainer._prepare()
    return trainer


def whole(trainer, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole CPU copies of this rank's (split) tensors, named as parameters."""
    from .shard import gather_state_dict

    with trainer.mesh.activate():
        return {k: v.detach().to("cpu", copy=True) for k, v in gather_state_dict(tensors, trainer.specs).items()}


def train_worker(rank: int, world: int, payload_path: str,
                 setup: Optional[Callable] = None) -> Optional[Dict[str, Any]]:
    payload = torch.load(payload_path, weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device(resolve_device(payload.get("device", "cuda")))
    probe = collective_probe(device) if payload.get("probe_collectives") else None
    out_dir = payload["output_dir"]
    trainer = build_trainer(payload, device, out_dir)
    if payload.get("restore"):
        trainer.config.resume_from_checkpoint = payload["restore"]
        trainer._maybe_load_checkpoint()
    if setup is not None:
        setup(trainer, payload)
    model = trainer.model
    batch = trainer._put_batch({k: np.asarray(v) for k, v in payload["batch"].items()})
    result: Dict[str, Any] = {"rank": rank, "coords": dict(trainer.mesh.coords), "metrics": [], "step_ms": [],
                              "collectives": probe}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _flash_launches()
    grads = None
    for step in range(int(payload.get("steps", 1))):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, step)
        trainer.state.global_step += 1
        result["metrics"].append({k: float(v) for k, v in metrics.items()})
        result["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            grads = whole(trainer, {n: p.grad for n, p in model.named_parameters(remove_duplicate=False)
                                    if p.grad is not None})
    result["launches"] = {k: v - before[k] for k, v in _flash_launches().items()}
    params = whole(trainer, dict(model.state_dict()))
    with trainer.mesh.activate():
        opt_state = whole_opt_state(trainer.optimizer, model, trainer.specs)
    for ckpt in payload.get("checkpoints", []):
        trainer.config.sharded_checkpoint = bool(ckpt.get("sharded"))
        trainer.config.async_checkpoint = bool(ckpt.get("async"))
        result.setdefault("checkpoints", {})[ckpt["name"]] = trainer.save_checkpoint(ckpt["name"])
    if payload.get("profile"):  # one more step, after what is reported and saved
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with collective_timer() as timer:
            t0 = time.perf_counter()
            trainer.train_step(batch, trainer.state.global_step)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        result["profiled_step"] = {"ms": wall * 1e3, "collective_ms": timer["seconds"] * 1e3,
                                   "collective_calls": timer["calls"],
                                   "collective_share": timer["seconds"] / wall}
    if device.type == "cuda":
        result["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    wait_for_async_saves()
    if payload.get("check_restore"):  # a checkpoint restored on this mesh, last
        trainer.config.resume_from_checkpoint = payload["check_restore"]
        trainer._maybe_load_checkpoint()
        restored = whole(trainer, dict(model.state_dict()))
        with trainer.mesh.activate():
            restored_opt = whole_opt_state(trainer.optimizer, model, trainer.specs)
        if rank == 0:
            result["restored"] = {"params": restored, "opt_state": restored_opt}
    if rank == 0:
        result.update(grads=grads, params=params, opt_state=opt_state,
                      mesh=dict(trainer.mesh.shape), backend=trainer.mesh.backend())
    return result


def run_one_process(payload: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The payload's steps in this process, on a one-rank mesh: the
    reference a multi-rank run is held to."""
    payload = {**payload, "trainer": {k: v for k, v in payload["trainer"].items()
                                      if k not in ("mesh_data", "mesh_model", "mesh_expert")}}
    import tempfile

    with tempfile.TemporaryDirectory(prefix="one_process_") as tmp:
        path = os.path.join(tmp, "payload.pt")
        torch.save({**payload, "device": str(device), "output_dir": payload.get("output_dir", tmp),
                    "checkpoints": []}, path)
        if current() is not None:
            raise RuntimeError("run_one_process inside an active mesh")
        return train_worker(0, 1, path)


# ---- a pipelined trunk (parallel/pipeline.py) ----
#
# The payload (a `torch.save`d dict): the trunk's "config" (a
# TransformerConfig) and the whole stack's "state_dict" (its final norm
# included), the global "x" (b, t, dim), optional "mask" and "style", the
# "mesh" ({"data", "pipe", "model"}), "sequence_parallel", "microbatches",
# "steps" (optimizer steps after the first forward and backward; 0: none),
# "optimization" (an OptimizerConfig dict), "zero_sharding", "inputs_grad"
# (x and style take gradients), "device", "profile" (one more step with the
# collectives timed). The loss is JAX's dry run's: the stack's final norm
# over the trunk's output, then (h**2).sum() over the global batch.


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy that later steps do not touch."""
    return t.detach().to("cpu", copy=True)


def _pipeline_optimizer(named, payload, zero):
    from ..training.optimizers import Optimizer, OptimizerConfig

    return Optimizer(named, OptimizerConfig.from_dict(payload.get("optimization") or {"optimizer": "adam"}),
                     zero=zero)


def _timed_steps(payload, device, step, result):
    """`step()` (returns the loss) once and then `steps` more times; each
    step's global loss, wall ms and flash launches into `result`."""
    for _ in range(1 + int(payload.get("steps", 0))):
        before = _flash_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        result["step_ms"].append((time.perf_counter() - t0) * 1e3)
        result["losses"].append(float(loss))
        result["launches"].append({k: v - before[k] for k, v in _flash_launches().items()})


def pipeline_worker(rank: int, world: int, payload_path: str) -> Optional[Dict[str, Any]]:
    """The payload's trunk on a (data, pipe[, model]) mesh through
    `pipeline_apply`, with adam(w) steps (ZeRO over `data` with
    `zero_sharding`). Rank 0 returns the global loss of each step, the
    first forward's output, the first step's whole gradients (stack names,
    the final norm's, and x's and style's when they take them) and the
    whole parameters after the steps; every rank its coordinates, step
    walls, flash launches a step and peak memory; a rank past the mesh
    returns None."""
    from ..models.transformer import TransformerStack
    from .pipeline import (make_unit_module, pipeline_apply, stack_unit_params, stage_params,
                           sum_gradients_over_data, unstack_unit_tree, whole_stacked)
    from .shard import shard_model

    payload = torch.load(payload_path, weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device(resolve_device(payload.get("device", "cuda")))
    cfg = payload["config"]
    axes = payload["mesh"]
    mesh = make_pipeline_mesh(axes.get("pipe", 1), data=axes.get("data", 1), model=axes.get("model", 1))
    if not mesh.member:
        return None
    mesh.sequence_parallel = bool(payload.get("sequence_parallel"))
    stack = TransformerStack(cfg).to(device).eval()
    stack.load_state_dict(payload["state_dict"])
    unit = make_unit_module(cfg).to(device)
    specs = shard_model(unit, mesh) if mesh.size(MODEL_AXIS) > 1 else {}
    stacked = stack_unit_params(stack.state_dict(), cfg.depth)
    stage = {k: torch.nn.Parameter(v) for k, v in stage_params(stacked, mesh, specs).items()}
    final = stack.final_norm
    n, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)

    def rows(v):
        if v is None:
            return None
        v = torch.as_tensor(v).detach()
        b = v.shape[0] // n
        return v[d * b:(d + 1) * b].to(device, copy=True)

    grad_inputs = bool(payload.get("inputs_grad"))
    x = rows(payload["x"]).requires_grad_(grad_inputs)
    mask, style = rows(payload.get("mask")), rows(payload.get("style"))
    if style is not None:
        style.requires_grad_(grad_inputs)
    named = [(f"stage.{k}", p) for k, p in stage.items()]
    if final is not None:
        named += [(f"final_norm.{k}", p) for k, p in final.named_parameters()]
    zero = (n, d) if payload.get("zero_sharding") else None
    optimizer = _pipeline_optimizer(named, payload, zero)
    result: Dict[str, Any] = {"rank": rank, "coords": dict(mesh.coords), "losses": [], "step_ms": [],
                              "launches": []}
    first: Dict[str, Any] = {}

    def forward():
        h = pipeline_apply(unit, stage, x, mesh, payload["microbatches"], mask=mask, style_embeddings=style)
        if final is None:
            return h
        return final(h, condition=style) if cfg.use_adanorm else final(h)

    def step():
        optimizer.zero_grad()
        x.grad = None
        if style is not None:
            style.grad = None
        with mesh.activate():
            h = forward()
            loss = (h.float() ** 2).sum()
            loss.backward()
            sum_gradients_over_data([p for _, p in named])
            total = coll.all_reduce(loss.detach(), DATA_AXIS)
            if not first:
                first["out"] = _host(coll.all_gather(h.detach(), DATA_AXIS, dim=0))
                grads = whole_stacked({k: p.grad for k, p in stage.items()}, specs)
                first["grads"] = {k: _host(v) for k, v in unstack_unit_tree(grads, cfg.depth).items()}
                if final is not None:
                    first["grads"].update({f"final_norm.{k}": _host(p.grad) for k, p in final.named_parameters()})
                if grad_inputs:
                    first["x_grad"] = _host(coll.all_gather(x.grad, DATA_AXIS, dim=0))
                    if style is not None:
                        first["style_grad"] = _host(coll.all_gather(style.grad, DATA_AXIS, dim=0))
            if len(result["losses"]) < int(payload.get("steps", 0)):
                optimizer.step()
        return total

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _timed_steps(payload, device, step, result)
    with mesh.activate():
        params = unstack_unit_tree(whole_stacked({k: p.detach() for k, p in stage.items()}, specs), cfg.depth)
    if final is not None:
        params.update({f"final_norm.{k}": p.detach() for k, p in final.named_parameters()})
    if payload.get("profile"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with collective_timer() as timer:
            t0 = time.perf_counter()
            step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        result["profiled_step"] = {"ms": wall * 1e3, "collective_ms": timer["seconds"] * 1e3,
                                   "collective_calls": timer["calls"], "collective_share": timer["seconds"] / wall}
    if device.type == "cuda":
        result["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if rank == 0:
        result.update(first, params={k: _host(v) for k, v in params.items()})
    return result


def pipeline_runs_worker(rank: int, world: int, paths: List[str]) -> List[Optional[Dict[str, Any]]]:
    """`pipeline_worker` on each payload in turn, in one launch (a mesh
    smaller than the process group leaves the other ranks out: None)."""
    return [pipeline_worker(rank, world, path) for path in paths]


def run_trunk_one_process(payload: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The pipeline payload's steps on the whole stack in this process:
    the reference `pipeline_worker` is held to (the same fields)."""
    from ..models.transformer import TransformerStack

    device = resolve_device(device)
    cfg = payload["config"]
    stack = TransformerStack(cfg).to(device).eval()
    stack.load_state_dict(payload["state_dict"])
    grad_inputs = bool(payload.get("inputs_grad"))
    x, mask, style = (None if payload.get(k) is None else torch.as_tensor(payload[k]).detach().to(device, copy=True)
                      for k in ("x", "mask", "style"))
    x.requires_grad_(grad_inputs)
    if style is not None:
        style.requires_grad_(grad_inputs)
    optimizer = _pipeline_optimizer(list(stack.named_parameters()), payload, None)
    result: Dict[str, Any] = {"losses": [], "step_ms": [], "launches": []}
    first: Dict[str, Any] = {}

    def step():
        optimizer.zero_grad()
        x.grad = None
        if style is not None:
            style.grad = None
        h = stack(x, mask=mask, style_embeddings=style)
        loss = (h.float() ** 2).sum()
        loss.backward()
        if not first:
            first.update(out=_host(h), grads={k: _host(p.grad) for k, p in stack.named_parameters()})
            if grad_inputs:
                first["x_grad"] = _host(x.grad)
                if style is not None:
                    first["style_grad"] = _host(style.grad)
        if len(result["losses"]) < int(payload.get("steps", 0)):
            optimizer.step()
        return loss.detach()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _timed_steps(payload, device, step, result)
    if device.type == "cuda":
        result["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    result.update(first, params={k: _host(p) for k, p in stack.named_parameters()})
    return result

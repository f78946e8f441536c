"""Worker functions that `launch` starts on every rank: train steps of a
model through the `Trainer` on a mesh, and report what one process needs to
hold them against a one-process run.

    launch(train_worker, n, (payload_path,))

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
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..training.checkpoint import wait_for_async_saves, whole_opt_state
from .collectives import collective_timer
from .mesh import current, rank_device


def _flash_launches() -> Dict[str, int]:
    from ..ops import flash_attention as fa

    return {name: getattr(fa, name).launches + getattr(fa, name).launches_bf16
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

    table = {}
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor), ("all_to_all_single", all_to_all_single),
                     ("broadcast", broadcast)):
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

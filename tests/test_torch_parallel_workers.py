"""Worker functions of the multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_checkpoint_sharded.py): what `parallel.launch` starts on
every rank besides the package's own `train_worker`, and the `setup` hooks
the tests hand to it. It holds no test. Spawned ranks import this module by
name (the tests' directory is on the path they inherit); it imports no
JAX."""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch


def replay_first_step(trainer, payload) -> None:
    """`train_worker`'s setup: the first step's MMD samples are the
    payload's "draws", (z, u) per `mmd_loss` call, as a test catches them
    from JAX."""
    draws = list(payload["draws"])
    model, apply = trainer.model, trainer._apply

    def sample(d: int, n_latents: int):
        z, u = draws.pop(0)
        if z.shape[1] != d:
            raise ValueError(f"replayed MMD samples of dim {z.shape[1]} for latents of dim {d}")
        return torch.as_tensor(z), None if u is None else torch.as_tensor(u)

    def _apply(batch, generators):
        if trainer.state.global_step == 0:
            return model(**batch, generators=generators, mmd_sampler=sample)
        return apply(batch, generators)

    trainer._apply = _apply


def log_checkpoint_writes(trainer, payload) -> None:
    """`train_worker`'s setup: rank 1's checkpoint writes sleep half a second
    first; each rank appends to the payload's "events" file when a shard
    write ends ("write <rank> <time>") and when it removes a checkpoint
    directory ("rmtree <rank> <time>")."""
    from scoreperformer_tpu_torch.training import checkpoint

    rank, path = trainer.mesh.rank, payload["events"]
    save, rmtree = torch.save, checkpoint.shutil.rmtree

    def log(kind):
        with open(path, "a") as f:
            f.write(f"{kind} {rank} {time.time()!r}\n")

    def slow_save(obj, f, *args, **kwargs):
        if not threading.current_thread().name.startswith("checkpoint"):
            return save(obj, f, *args, **kwargs)
        if rank == 1:
            time.sleep(0.5)
        save(obj, f, *args, **kwargs)
        if "shards" in str(f):
            log("write")

    def logged_rmtree(directory, *args, **kwargs):
        log("rmtree")
        return rmtree(directory, *args, **kwargs)

    torch.save = slow_save
    checkpoint.shutil.rmtree = logged_rmtree


def optimizer_worker(rank: int, world: int, configs: Dict[str, Dict], params: Dict[str, np.ndarray],
                     grads: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """ZeRO over a data axis of `world`: for each optimizer config, the
    updates of `params` by the given gradients (the same on every rank, as
    after the data axis's all-reduce). Returns, by config, the whole
    parameters after the updates, the shape of what this rank updates of
    each parameter (its moments have that shape too) and which adafactor
    factors."""
    from scoreperformer_tpu_torch.parallel.mesh import DATA_AXIS, ProcessMesh
    from scoreperformer_tpu_torch.training.optimizers import Optimizer, OptimizerConfig

    mesh = ProcessMesh(data=world)
    out = {}
    with mesh.activate():
        for name, cfg in configs.items():
            tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
            opt = Optimizer(tparams.items(), OptimizerConfig.from_dict(cfg),
                            zero=(mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)))
            for g in grads:
                for k, p in tparams.items():
                    p.grad = torch.from_numpy(g[k].copy())
                opt.step()
            held = {}
            for i, k in enumerate(opt.names):
                held[k] = tuple(opt.params[i].shape)
                for key in ("mu", "nu", "v"):
                    buffers = getattr(opt, key)
                    if buffers is not None and (key != "v" or opt.factored_dims[i] is None):
                        assert tuple(buffers[i].shape) == held[k], (name, key, k)
            out[name] = {"params": {k: p.detach().numpy().copy() for k, p in tparams.items()},
                         "state_shapes": held,
                         "factored": {k: d is not None for k, d in zip(opt.names, opt.factored_dims)}}
    return out


def cli_worker(rank: int, world: int, argv: List[str]) -> List[Dict[str, Any]]:
    """`python -m scoreperformer_tpu_torch.train <argv>` as rank `rank` of
    `world` under the environment torchrun gives (the launch's `env` plus
    RANK, WORLD_SIZE, LOCAL_RANK); returns the trainer's log history."""
    from scoreperformer_tpu_torch import train

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank)})
    return train.main(argv).trainer.state.log_history


def multihost_worker(rank: int, world: int, config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A recipe dict trained with `multihost` as process `rank` of `world`
    (`coordinator_address` set by the caller): the trainer starts the
    process group. Returns the trainer's log history."""
    from scoreperformer_tpu_torch.training import ExperimentComponents

    config = {**config, "trainer": {**config["trainer"], "multihost": True, "num_processes": world,
                                    "process_id": rank}}
    components = ExperimentComponents(config=config, device="cpu").init_components()
    components.trainer.train()
    return components.trainer.state.log_history


def autograd_pairs_worker(rank: int, world: int) -> Dict[str, List[float]]:
    """The backward of each autograd pair of `collectives` over a data axis
    of `world`, run on a thread of its own (as autograd runs a CUDA
    backward on its device thread, which does not see the active mesh):
    the gradients that reach this rank's input."""
    from scoreperformer_tpu_torch.parallel.collectives import copy_to_group, gather_rows, reduce_from_group
    from scoreperformer_tpu_torch.parallel.mesh import DATA_AXIS, ProcessMesh

    mesh = ProcessMesh(data=world)
    out = {}
    for name, pair in (("copy_to_group", lambda x: copy_to_group(x, DATA_AXIS)),
                       ("reduce_from_group", lambda x: reduce_from_group(x, DATA_AXIS)),
                       ("gather_rows", gather_rows)):
        x = torch.full((2,), float(rank + 1), requires_grad=True)
        with mesh.activate():
            y = pair(x)
        weights = torch.arange(1, y.numel() + 1, dtype=torch.float32) * (rank + 1)
        thread = threading.Thread(target=lambda: (y * weights).sum().backward())
        thread.start()
        thread.join()
        out[name] = x.grad.tolist()
    return out


def split_optimizer_worker(rank: int, world: int, cfg: Dict, params: Dict[str, np.ndarray],
                           grads: List[Dict[str, np.ndarray]], splits: Dict[str, Any],
                           transposed: List[str]) -> Dict[str, Any]:
    """Each parameter of `splits` ({name: Shard}) split over its axis of a
    (model 2 x expert 2) mesh, as `parallel/shard.py` splits a layer; the
    others whole. Returns this rank's blocks after the updates of the
    given gradients (each rank's block of the same whole gradients) and
    which parameters adafactor factors."""
    from scoreperformer_tpu_torch.parallel.mesh import ProcessMesh
    from scoreperformer_tpu_torch.training.optimizers import Optimizer, OptimizerConfig

    mesh = ProcessMesh(model=2, expert=2)

    def block(name, value):
        spec = splits.get(name)
        value = torch.from_numpy(value.copy())
        return value if spec is None else spec.take(value, mesh.size(spec.axis), mesh.index(spec.axis)).clone()

    with mesh.activate():
        tparams = {k: torch.nn.Parameter(block(k, v)) for k, v in params.items()}
        shard_axes = {k: (s.axis, mesh.size(s.axis), s.dim) for k, s in splits.items()}
        opt = Optimizer(tparams.items(), OptimizerConfig.from_dict(cfg), transposed=transposed, shard_axes=shard_axes)
        for g in grads:
            for k, p in tparams.items():
                p.grad = block(k, g[k])
            opt.step()
    return {"coords": dict(mesh.coords), "params": {k: p.detach().numpy().copy() for k, p in tparams.items()},
            "factored": {k: d is not None for k, d in zip(opt.names, opt.factored_dims)}}


def replay_and_log_sequence_parallel(trainer, payload) -> None:
    """`train_worker`'s setup: `replay_first_step`, and every stack call
    appends "<sequence length> <1 if sequence-parallel else 0>" to the
    payload's "sp_log" file."""
    from scoreperformer_tpu_torch.models.transformer import TransformerStack

    replay_first_step(trainer, payload)
    decide, path = TransformerStack._sequence_parallel, payload["sp_log"]

    def logged(self, x, caches):
        engaged = decide(self, x, caches)
        with open(path, "a") as f:
            f.write(f"{x.shape[1]} {int(engaged)}\n")
        return engaged

    TransformerStack._sequence_parallel = logged


def sequence_parallel_stack_worker(rank: int, world: int, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Each case's stack (its "config" built from "seed", in train mode
    under the dropout generator of "seed") split over a model axis of
    `world`, without and with sequence parallelism: the output, whole
    parameter gradients and the gradients of x and style, each time."""
    from scoreperformer_tpu_torch.models.dropout import dropout_generator
    from scoreperformer_tpu_torch.models.transformer import TransformerStack
    from scoreperformer_tpu_torch.parallel.mesh import ProcessMesh
    from scoreperformer_tpu_torch.parallel.shard import gather_state_dict, shard_model

    mesh = ProcessMesh(model=world)
    out = []
    for case in cases:
        runs = {}
        for sp in (False, True):
            torch.manual_seed(case["seed"])
            stack = TransformerStack(case["config"]).train()
            specs = shard_model(stack, mesh)
            mesh.sequence_parallel = sp
            x = case["x"].clone().requires_grad_(True)
            style = None if case.get("style") is None else case["style"].clone().requires_grad_(True)
            with mesh.activate(), dropout_generator(torch.Generator().manual_seed(case["seed"])):
                engaged = stack._sequence_parallel(x, None)
                h = stack(x, mask=case.get("mask"), context=case.get("context"), style_embeddings=style)
                (h * case["weights"]).sum().backward()
                grads = gather_state_dict({k: p.grad for k, p in stack.named_parameters()}, specs)
            runs[sp] = {"engaged": engaged, "out": h.detach(), "grads": grads, "x_grad": x.grad,
                        "style_grad": None if style is None else style.grad}
        out.append(runs)
    return out

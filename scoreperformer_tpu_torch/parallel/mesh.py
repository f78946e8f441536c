"""The process mesh: data x model x expert ranks (or data x pipe x model),
one process per device.

Counterpart of scoreperformer_tpu/parallel/mesh.py. Rank r sits at the
(data, model, expert) coordinate that `make_mesh` gives device r there
(`np.arange(world).reshape(data, model, expert)`), or, on a pipeline mesh,
at the (data, pipe, model) one of `make_pipeline_mesh`
(scoreperformer_tpu/parallel/pipeline.py:49); each axis is a set of
`torch.distributed` sub-groups, one for every line of ranks along it.
- The batch splits over `data` only: ranks on one data coordinate hold the
  same rows, as `P(DATA_AXIS)` replicates them over `model` and `expert`.
- `model` splits the layers that JAX's `DEFAULT_PARTITION_RULES` name, by
  the port's own table (`parallel/shard.py`).
- `expert` splits MoE's stacked expert parameters on their leading axis
  (`EXPERT_PARTITION_RULES`).
- ZeRO-1 splits each optimizer-state buffer over `data` on the dimension
  `zero_split_dim` picks, a copy of JAX's `_zero_spec`.
- `pipe` splits a trunk's depth units into stages (`parallel/pipeline.py`).
- `sequence_parallel` (set by the trainer, as JAX's trainer installs its
  activation sharding) splits each `TransformerStack`'s residual stream over
  `model` on the sequence (`models/transformer.py`).

The trainer activates its mesh around each step (`ProcessMesh.activate`);
the model's loss terms, dropout and sharded layers read it through
`current()` and run their one-device code when none is active.
"""
from __future__ import annotations

import math
import os
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, MODEL_AXIS, EXPERT_AXIS)
PIPELINE_AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS)

_current: ContextVar[Optional["ProcessMesh"]] = ContextVar("process_mesh", default=None)


def current() -> Optional["ProcessMesh"]:
    """The active mesh, or None outside `ProcessMesh.activate()`."""
    return _current.get()


def mesh_layout(data: int, model: int = 1, expert: int = 1) -> np.ndarray:
    """(data, model, expert) array of ranks: the rank at each coordinate."""
    return np.arange(data * model * expert).reshape(data, model, expert)


def pipeline_layout(pipe: int, data: int = 1, model: int = 1) -> np.ndarray:
    """(data, pipe, model) array of ranks: JAX's `make_pipeline_mesh` order."""
    return np.arange(data * pipe * model).reshape(data, pipe, model)


def default_data_axis(world: int, model: int, expert: int, batch_size: int,
                      eval_batch_size: int) -> Tuple[int, Optional[str]]:
    """(data axis, warning or None), as the JAX trainer picks its data axis
    (trainer.py:215-242): the ranks left over by model x expert, limited to
    a divisor of both batch sizes; the warning says how many ranks the mesh
    leaves out."""
    non_data = model * expert
    data = math.gcd(max(1, world // non_data), math.gcd(batch_size, eval_batch_size)) or 1
    if data * non_data < world:
        return data, (
            f"mesh ({data} data x {model} model x {expert} expert) engages only {data * non_data} of "
            f"{world} devices: the data axis is limited by gcd(batch={batch_size}, eval_batch="
            f"{eval_batch_size}). Set mesh_data explicitly or pick batch sizes divisible by the device "
            "count to use all devices."
        )
    return data, None


def zero_split_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension ZeRO splits a buffer of `shape` on over a data axis of
    `n`: the largest one divisible by n (the last of equal ones), None for
    scalars and shapes with no such dimension. A copy of JAX's
    `parallel.mesh._zero_spec`."""
    if n <= 1 or len(shape) == 0:
        return None
    candidates = [(size, dim) for dim, size in enumerate(shape) if size % n == 0 and size >= n]
    if not candidates:
        return None
    return max(candidates)[1]


def maybe_distributed_initialize(config, device="cuda") -> bool:
    """Start the process group (the counterpart of JAX's
    `maybe_distributed_initialize`). With `coordinator_address`,
    `num_processes` and `process_id` set, it joins
    `tcp://<coordinator_address>` as that process of that many; with all
    three None it reads torchrun's environment (`RANK`, `WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`). The backend is `nccl` on CUDA and `gloo`
    on the CPU; one that cannot start raises. Returns True if it started a
    group, False when one exists already or there is one process."""
    if dist.is_initialized():
        return False
    address = getattr(config, "coordinator_address", None)
    num = getattr(config, "num_processes", None)
    pid = getattr(config, "process_id", None)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if address is not None or num not in (None, 0, 1) or pid is not None:
        if address is None or num is None or pid is None:
            raise ValueError("multihost start: set coordinator_address, num_processes and process_id together")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=int(num), rank=int(pid))
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://")
    return True


def local_rank() -> int:
    """This process's device index on its host: torchrun's `LOCAL_RANK`,
    else the global rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(1, n)


def rank_device(device="cuda") -> torch.device:
    """`cuda:LOCAL_RANK` for a CUDA run (the device string's own index when
    it names one), the CPU when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


class ProcessMesh:
    """The (data, model, expert) mesh, or with `pipe` > 1 the (data, pipe,
    model) one, over the first ranks of the default process group; with no
    group, a one-rank mesh. Every rank of the group must build it (making
    sub-groups is collective); a rank past the mesh is not a `member` and
    takes no part."""

    def __init__(self, data: int = 1, model: int = 1, expert: int = 1, pipe: int = 1):
        self.shape: Dict[str, int] = {DATA_AXIS: int(data), MODEL_AXIS: int(model), EXPERT_AXIS: int(expert),
                                      PIPE_AXIS: int(pipe)}
        if pipe > 1 and expert > 1:
            raise ValueError("a pipeline mesh is (data, pipe, model): it has no expert axis")
        self.axes = PIPELINE_AXES if pipe > 1 else AXES
        layout = pipeline_layout(pipe, data, model) if pipe > 1 else mesh_layout(data, model, expert)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        n = layout.size
        if n > world:
            raise ValueError(f"mesh {'x'.join(str(self.shape[a]) for a in self.axes)} needs {n} ranks; "
                             f"the process group has {world}")
        self.member = self.rank < n
        self.coords: Dict[str, int] = {a: 0 for a in self.shape}
        if self.member:
            self.coords.update(zip(self.axes, (int(i[0]) for i in np.nonzero(layout == self.rank))))
        # the residual stream split over `model` on the sequence (the trainer's `sequence_parallel`)
        self.sequence_parallel = False
        # the mesh's ranks, for barriers that the ranks past it take no part in
        self._members = dist.new_group(list(range(n))) if dist.is_initialized() and n < world else None
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {a: None for a in self.shape}
        for i, axis in enumerate(self.axes):
            if self.shape[axis] == 1:
                continue
            lines = np.moveaxis(layout, i, -1).reshape(-1, self.shape[axis])
            for line in lines:  # every rank creates every group, in the same order
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[axis] = group

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    @property
    def is_main(self) -> bool:
        """Rank 0 logs, writes TensorBoard and writes non-sharded checkpoints."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here."""
        if self.world > 1:
            dist.barrier(group=self._members)

    def backend(self) -> Optional[str]:
        return dist.get_backend() if dist.is_initialized() else None

    @contextmanager
    def activate(self) -> Iterator["ProcessMesh"]:
        """The model's collectives use this mesh inside the block."""
        token = _current.set(self)
        try:
            yield self
        finally:
            _current.reset(token)


def make_pipeline_mesh(pipe: int, data: int = 1, model: int = 1) -> ProcessMesh:
    """The (data, pipe[, model]) mesh of JAX's `make_pipeline_mesh`: the
    batch over `data`, a trunk's depth over `pipe`, its layers over `model`."""
    return ProcessMesh(data=data, model=model, pipe=pipe)

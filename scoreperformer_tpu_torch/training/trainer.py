"""Trainer: train and eval steps, the epoch loop, checkpoints, callbacks.

Counterpart of scoreperformer_tpu/training/trainer.py, on one device (the
GPU unless the model lives elsewhere) or on a mesh of processes. Batches are
the JAX trainer's: each is a pure function of (seed, epoch, batch index),
made by the same formulas (`_iter_batches`), so both frameworks see the very
same data. Dropout, latent
dropout and the MMD samples draw from generators seeded per step from
(seed, step), as the JAX trainer folds its key. TensorBoard event files go to
{output_dir}/tb unless `tensorboard` is off, as in the JAX trainer.

Every option of the JAX trainer that means something on one device is taken:
- `bf16_compute`: the forward runs on bf16 copies of the fp32 master
  parameters (buffers stay fp32, as JAX casts only `params`); the gradients
  come back fp32 through the casts, the loss and metrics are cast to fp32;
- `remat`: the whole forward under `torch.utils.checkpoint` (the JAX
  trainer's `jax.checkpoint(forward)`), its generators made inside it from
  (seed, step), so the recompute draws the same masks and samples;
- `finetune_layers`: regexes over the flax path of each parameter
  (`convert.jax_path_for`); the others get no gradient, so they add nothing to
  the norm and move only by weight decay, as the JAX trainer zeroes theirs;
- `warm_start` with `ignore_layers` and `ignore_mismatched_keys`: the
  parameters of a port checkpoint or a reference `.pt` that match by flax path
  and shape, no optimizer or trainer state;
- the `plateau` lr schedule: `PlateauController` stepped with each epoch's
  mean train loss, its scale applied to the updates and the logged lr, its
  state in `trainer_state["plateau"]`;
- `debug_nans`: FloatingPointError at the first non-finite module output in
  the forward (forward hooks, naming the module) or op in the backward
  (anomaly mode); nothing is installed when it is off;
- `profile_dir`: a `torch.profiler` trace of steps [profile_start_step,
  +profile_num_steps), each step a `train/<step>` range, written to
  profile_dir/trace_<first>-<last>.json, stopped early if training ends;
- `zero_sharding` and `sequence_parallel` are what they are on one device in
  JAX: nothing.
On several processes (torchrun, or `multihost` with `coordinator_address`,
`num_processes` and `process_id`), the trainer builds a `parallel.
ProcessMesh` of `mesh_data` x `mesh_model` x `mesh_expert` ranks (the data
axis by default as the JAX trainer picks it):
- every rank makes the global batch and takes rows [d*B/n, (d+1)*B/n) of
  it (a batch's rows depend on the random draws of the rows before them);
- the loss terms are the global batch's: each rank computes its partial
  (`parallel/collectives.py`), back-propagates n times it, and the
  gradients are averaged over `data` in one all-reduce; the logged metrics
  are the partials summed, the evaluator sees the gathered logits; dropout
  and the MMD samples do not depend on the number of ranks;
- `mesh_model` and `mesh_expert` split the layers `parallel/shard.py`
  names; the global norm and the optimizer's per-parameter norms are taken
  over the whole parameters, so every rank takes the same branch;
- `zero_sharding` splits the optimizer's state over `data` (ZeRO-1,
  `training/optimizers.py`);
- `sequence_parallel` with `mesh_model` > 1 splits each stack's residual
  stream over `model` on the sequence (`models/transformer.py`), set on
  the mesh at the start and cleared at the end of `train()`, as the JAX
  trainer installs and clears its activation sharding; the values are
  those without it, only memory changes;
- rank 0 logs, writes TensorBoard and writes non-sharded checkpoints
  (gathered into the one-device layout); with `sharded_checkpoint` every
  rank writes its blocks; `async_checkpoint` writes on a background thread;
- a rank past the mesh (when the data axis leaves ranks out) trains nothing.
A model with MoE layers adds their summed aux loss to the train step's loss
and logs it as `loss/moe_aux`, with their mean drop rate as `stats/moe_drop`
(not in the loss); eval logs both beside a loss without the aux, as the JAX
trainer's steps do.
"""
from __future__ import annotations

import os
import signal
import time
import warnings
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs import ModuleConfig
from ..data.collators import scoreperformer_model_inputs
from .callbacks import (
    CallbackHandler,
    DefaultFlowCallback,
    FileLogCallback,
    JSONLMetricsCallback,
    ProgressCallback,
    TensorBoardCallback,
    TrainerCallback,
    TrainerControl,
    TrainerState,
)
from ..parallel.collectives import all_gather, all_reduce
from ..parallel.shard import gather_state_dict, shard_model, shard_state_dict
from ..parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    ProcessMesh,
    default_data_axis,
    maybe_distributed_initialize,
)
from .checkpoint import (
    freeze_mask,
    from_jax_tree,
    jax_tree,
    load_checkpoint,
    save_checkpoint,
    shard_opt_state,
    wait_for_async_saves,
    warm_start_params,
)
from .optimizers import Optimizer, OptimizerConfig, PlateauController


@dataclass
class TrainerConfig(ModuleConfig):
    output_dir: str = "results"
    do_eval: bool = True
    seed: int = 23

    log_strategy: str = "steps"  # no | epoch | steps
    log_steps: int = 5
    log_first_step: bool = True
    progress_steps: int = 5
    progress_metrics: List[str] = field(default_factory=lambda: ["loss"])
    disable_progress: bool = False

    shuffle: bool = True
    drop_last: bool = True
    num_workers: int = 4

    epochs: int = 100
    max_steps: int = -1
    batch_size: int = 32
    eval_batch_size: int = 64
    eval_batches: Optional[int] = None

    eval_strategy: str = "epoch"  # no | epoch | steps
    eval_steps: int = 1

    optimization: OptimizerConfig = field(default_factory=OptimizerConfig)

    save_strategy: str = "epoch"  # no | epoch | steps
    save_steps: int = 1
    save_optimizer: bool = False
    save_best_only: bool = True
    save_rewrite_checkpoint: bool = False
    metric_for_best_model: str = "loss"
    metric_maximize: bool = False

    resume_from_checkpoint: Optional[str] = None
    warm_start: bool = False
    ignore_layers: List[str] = field(default_factory=list)
    ignore_mismatched_keys: bool = True
    finetune_layers: List[str] = field(default_factory=list)

    # the JAX trainer's device options: the process mesh (mesh_data None =
    # every rank the model and expert axes leave, limited by the batch
    # sizes), the multihost start (tcp://coordinator_address, else
    # torchrun's environment), ZeRO-1 over the data axis, sequence
    # parallelism on the model axis (a no-op on one model rank)
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    mesh_expert: int = 1
    multihost: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    zero_sharding: bool = False
    sequence_parallel: bool = False
    bf16_compute: bool = False
    remat: bool = False
    # TensorBoard event files in {output_dir}/tb (training/tensorboard.py)
    tensorboard: bool = True
    # checkpoints written on a background thread (wait_for_async_saves) /
    # as every rank's blocks with an index (training/checkpoint.py)
    async_checkpoint: bool = False
    sharded_checkpoint: bool = False
    debug_nans: bool = False
    # torch.profiler trace of [profile_start_step, +profile_num_steps) steps
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5


class Accumulator:
    """Running means. Values may be device tensors: they are kept as they are
    and read once, at `means()`, so a step never waits for the device."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._pending: List[Dict[str, Any]] = []

    def update(self, values: Dict[str, Any]):
        self._pending.append(dict(values))

    def means(self) -> Dict[str, float]:
        for values in self._pending:
            for key, value in values.items():
                self.sums[key] = self.sums.get(key, 0.0) + float(value)
                self.counts[key] = self.counts.get(key, 0) + 1
        self._pending = []
        return {k: self.sums[k] / max(1, self.counts[k]) for k in self.sums}

    def reset(self):
        self.sums, self.counts, self._pending = {}, {}, []


def step_generators(seed: int, step: int, device) -> Dict[str, torch.Generator]:
    """The generators of one step, seeded from (seed, step, stream): "dropout",
    "latent_dropout" and "mmd", the JAX trainer's three folded streams."""
    out = {}
    for stream, name in enumerate(("dropout", "latent_dropout", "mmd")):
        entropy = np.random.SeedSequence([int(seed), int(step), stream]).generate_state(1, np.uint64)[0]
        out[name] = torch.Generator(device=device).manual_seed(int(entropy) & (2**63 - 1))
    return out


class Trainer:
    """(reference trainer.py:35-526), on one device."""

    def __init__(
        self,
        model: torch.nn.Module,
        config: TrainerConfig,
        train_dataset=None,
        eval_dataset=None,
        collator=None,
        evaluator=None,
        callbacks: Optional[List[TrainerCallback]] = None,
        model_config: Optional[Dict] = None,
        input_fn: Callable = scoreperformer_model_inputs,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.mesh = self._make_mesh(config)
        self.mesh.sequence_parallel = config.sequence_parallel and config.mesh_model > 1
        self.specs = {}
        if self.mesh.size(MODEL_AXIS) > 1 or self.mesh.size(EXPERT_AXIS) > 1:
            self.specs = shard_model(model, self.mesh)
        self.config = config
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.collator = collator
        self.evaluator = evaluator
        self.model_config = model_config
        self.input_fn = input_fn
        os.makedirs(config.output_dir, exist_ok=True)

        self.state = TrainerState()
        self.control = TrainerControl()
        cb = [DefaultFlowCallback()]
        if self.mesh.is_main:  # rank 0 alone logs
            cb += [JSONLMetricsCallback(), FileLogCallback()]
            if config.tensorboard:
                cb.append(TensorBoardCallback())
            if not config.disable_progress:
                cb.append(ProgressCallback(config.progress_metrics, config.progress_steps))
        self.callback_handler = CallbackHandler(cb + list(callbacks or []))

        self.optimizer: Optional[Optimizer] = None
        self._plateau: Optional[PlateauController] = None
        self._frozen: List[torch.nn.Parameter] = []
        self._loaded = False
        self._hooks = []
        if config.debug_nans:
            self._hooks = [m.register_forward_hook(_finite_output_check(name or "model"))
                           for name, m in model.named_modules()]
        self.steps_per_epoch = None
        if train_dataset is not None:
            self.steps_per_epoch = max(1, len(train_dataset) // config.batch_size)
        self.callback_handler.on_init_end(self.config, self.state, self.control)

    # ---- setup ----

    def _make_mesh(self, config: TrainerConfig) -> ProcessMesh:
        """The (data, model, expert) mesh over the process group (started
        here with `multihost`), as the JAX trainer sizes its mesh."""
        import torch.distributed as dist

        if config.multihost:
            maybe_distributed_initialize(config, self.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        model, expert = config.mesh_model, config.mesh_expert
        data = config.mesh_data
        if data is None:
            data, warning = default_data_axis(world, model, expert, config.batch_size, config.eval_batch_size)
            if warning:
                warnings.warn(warning, stacklevel=3)
        for size in (config.batch_size, config.eval_batch_size):
            if size % data:
                raise ValueError(f"batch size {size} does not split over a data axis of {data}")
        return ProcessMesh(data, model, expert)

    def setup_optimizer(self):
        from ..convert import jax_param_paths

        try:  # adafactor factors in the JAX layout, masks name flax paths; a model with no JAX tree keeps the port's
            flax = jax_param_paths(self.model)
        except KeyError:
            flax = {}
        transposed = [n for n, (_, t) in flax.items() if t]
        zero = None
        if self.config.zero_sharding:
            zero = (self.mesh.size(DATA_AXIS), self.mesh.index(DATA_AXIS))
        shard_axes = {n: (s.axis, self.mesh.size(s.axis), s.dim) for n, s in self.specs.items()}
        self.optimizer = Optimizer(self.model.named_parameters(), self.config.optimization,
                                   self.steps_per_epoch or 1, transposed, zero=zero, shard_axes=shard_axes,
                                   paths={n: path for n, (path, _) in flax.items()})
        self._plateau = PlateauController.from_config(self.config.optimization)
        if self.config.finetune_layers:  # the JAX trainer's freeze_mask over flax paths
            trainable = from_jax_tree(self.model, freeze_mask(jax_tree(self.model), self.config.finetune_layers))
            params = dict(self.model.named_parameters())
            self._frozen = [params[n] for n, keep in trainable.items() if not keep]

    def _prepare(self):
        if self.optimizer is None:
            self.setup_optimizer()
        if not self._loaded:
            self._maybe_load_checkpoint()
            self._loaded = True

    def _maybe_load_checkpoint(self):
        path = self.config.resume_from_checkpoint
        if not path:
            return
        from ..convert import load_state_dict

        loaded = load_checkpoint(path)  # whole tensors; this rank keeps its blocks
        if self.config.warm_start:  # matching parameters only, by flax path
            with self.mesh.activate():
                own = gather_state_dict(self.model.state_dict(), self.specs)
            params = warm_start_params(jax_tree(self.model, own), jax_tree(self.model, loaded["params"]),
                                       ignore_layers=self.config.ignore_layers,
                                       ignore_mismatched=self.config.ignore_mismatched_keys)
            load_state_dict(self.model, shard_state_dict(from_jax_tree(self.model, params), self.specs, self.mesh))
            return
        load_state_dict(self.model, shard_state_dict(loaded["params"], self.specs, self.mesh))
        if "opt_state" in loaded:
            self.optimizer.load_state_dict(shard_opt_state(loaded["opt_state"], self.model, self.specs, self.mesh))
        ts = loaded.get("trainer_state")
        if ts is not None:
            self.state.epoch = ts.get("epoch", 0.0)
            self.state.global_step = ts.get("global_step", 0)
            self.state.best_metric = ts.get("best_metric")
            if self._plateau is not None and ts.get("plateau") is not None:
                self._plateau.load_state_dict(ts["plateau"])

    # ---- steps ----

    def _apply(self, batch: Dict[str, torch.Tensor], generators: Dict[str, torch.Generator]):
        """The model's forward, on bf16 copies of its floating parameters
        with `bf16_compute` (their backward returns fp32 gradients)."""
        with _bf16_parameters(self.model) if self.config.bf16_compute else nullcontext():
            return self.model(**batch, generators=generators)

    def loss_fn(self, batch: Dict[str, torch.Tensor], step: int):
        """(fp32 loss, {name: fp32 loss term}) of the training forward of
        step `step`, under `torch.utils.checkpoint` with `remat`. The step's
        generators are made inside, so a recompute draws what the forward
        drew."""

        def forward():  # a recompute runs on autograd's thread: the mesh is activated again
            with self.mesh.activate():
                out = self._apply(batch, step_generators(self.config.seed, step, self.device))
            loss, losses = out.loss.float(), {k: v.float() for k, v in out.losses.items()}
            if getattr(out, "moe_aux", None) is not None:
                loss = loss + out.moe_aux
                losses.update(_moe_metrics(out))
            return loss, losses

        if self.config.remat:
            return torch.utils.checkpoint.checkpoint(forward, use_reentrant=False)
        return forward()

    def train_step(self, batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """Forward, backward, clip and update on this rank's rows; the
        metrics (the global batch's) stay on the device."""
        self.model.train()
        self.optimizer.zero_grad()
        n = self.mesh.size(DATA_AXIS)
        with self.mesh.activate():
            with _anomaly_mode() if self.config.debug_nans else nullcontext():
                loss, losses = self.loss_fn(batch, step)
                (loss * n if n > 1 else loss).backward()
            for p in self._frozen:  # the JAX trainer zeroes their gradients
                p.grad = None
            self._average_gradients()
            with torch.no_grad():  # a parameter without a gradient adds 0 to the norm
                if any(self.optimizer.shard_axes):  # one entry a parameter: its shards' sums are added up
                    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.optimizer.full]
                else:
                    grads = [p.grad for p in self.optimizer.full if p.grad is not None]
                grad_norm = self.optimizer.global_norm(grads) if grads else torch.zeros((), device=self.device)
            self.optimizer.step(grad_norm)
            metrics = self._global_metrics({"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}})
        metrics["stats/grad_norm"] = grad_norm
        return metrics

    def _average_gradients(self) -> None:
        """The mean over the data axis of every gradient, in one all-reduce."""
        n = self.mesh.size(DATA_AXIS)
        params = [p for p in self.optimizer.full if p.grad is not None]
        if n == 1 or not params:
            return
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), DATA_AXIS) / n
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def _global_metrics(self, partials: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch's metrics: the ranks' partials summed over the
        data axis, in one all-reduce."""
        if self.mesh.size(DATA_AXIS) == 1 or not partials:
            return partials
        total = all_reduce(torch.stack([v.float().reshape(()) for v in partials.values()]), DATA_AXIS)
        return dict(zip(partials, total))

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], index: int) -> Dict[str, torch.Tensor]:
        """The eval forward on this rank's rows; the metrics are the global
        batch's (the evaluator sees the logits gathered over the data axis)."""
        self.model.eval()
        with self.mesh.activate():
            # deterministic but decorrelated across eval batches (the MMD samples)
            gens = {"mmd": step_generators(0, index, self.device)["mmd"]}
            out = self._apply(batch, gens)
            metrics = {"loss": out.loss.float()}
            if getattr(out, "moe_aux", None) is not None:
                metrics.update(_moe_metrics(out))
            metrics.update({k: v.float() for k, v in out.losses.items()})
            metrics = self._global_metrics(metrics)
            if self.evaluator is not None and "labels" in batch:
                logits = {k: all_gather(v.float(), DATA_AXIS) for k, v in out.logits.items()}
                metrics.update(self.evaluator(all_gather(batch["labels"], DATA_AXIS), logits))
        return metrics

    # ---- data ----

    def _iter_batches(self, dataset, batch_size: int, shuffle: bool, epoch: int, skip: int = 0):
        """Host batching with `num_workers` parallel producers. Every batch is
        a pure function of (seed, epoch, b): the shuffle order comes from the
        epoch seed and both the dataset sampling rng and the collator masking
        rng are derived per batch index with the JAX trainer's formulas, so
        producer order cannot change the data and `skip` resumes an epoch at
        the batch it stopped at."""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        n = len(dataset)
        order = np.arange(n)
        if shuffle:
            np.random.RandomState(self.config.seed * (epoch + 1)).shuffle(order)
        num_batches = n // batch_size if self.config.drop_last else -(-n // batch_size)
        num_batches = max(1, num_batches) if n > 0 else 0

        collator_lock = threading.Lock()
        has_collator_rng = hasattr(self.collator, "_rng")

        def make(b):
            idx = order[b * batch_size : (b + 1) * batch_size]
            if len(idx) < batch_size:  # wrap around to keep static shapes
                idx = np.concatenate([idx, np.resize(order, batch_size - len(idx))])
            rng = np.random.RandomState((self.config.seed * 1_000_003 + epoch * 10_007 + b) % (2**31 - 1))
            if hasattr(dataset, "get"):
                samples = [dataset.get(int(i), rng=rng) for i in idx]
            else:
                samples = [dataset[int(i)] for i in idx]
            if has_collator_rng:
                with collator_lock:
                    self.collator._rng = np.random.RandomState(
                        (self.config.seed * 9_999_991 + epoch * 104_729 + b * 7919 + 1) % (2**31 - 1)
                    )
                    return self.input_fn(self.collator(samples))
            return self.input_fn(self.collator(samples))

        skip = min(max(0, int(skip)), num_batches)
        workers = max(1, int(self.config.num_workers))
        if workers == 1:
            for b in range(skip, num_batches):
                yield make(b)
            return
        with ThreadPoolExecutor(max_workers=workers) as pool:
            inflight = {}
            depth = workers + 1
            for b in range(skip, min(skip + depth, num_batches)):
                inflight[b] = pool.submit(make, b)
            for b in range(skip, num_batches):
                batch = inflight.pop(b).result()
                if b + depth < num_batches:
                    inflight[b + depth] = pool.submit(make, b + depth)
                yield batch

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a host batch, on its device: rows
        [d*B/n, (d+1)*B/n) on data coordinate d of n."""
        n, d = self.mesh.size(DATA_AXIS), self.mesh.index(DATA_AXIS)
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            rows = v.shape[0] // n
            out[k] = torch.as_tensor(v[d * rows:(d + 1) * rows]).to(self.device, non_blocking=True)
        return out

    # ---- loops ----

    def train(self):
        if not self.mesh.member:  # left out of the mesh
            return self.state
        self._prepare()
        config = self.config
        self.state.num_train_epochs = config.epochs
        self.state.max_steps = config.max_steps if config.max_steps > 0 else config.epochs * self.steps_per_epoch
        self.callback_handler.on_train_begin(config, self.state, self.control)

        # a SIGTERM/SIGINT asks for a graceful stop; `finally` then saves
        def _request_stop(signum, frame):
            self.control.should_training_stop = True

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not in the main thread
                pass

        accumulator = Accumulator()
        start_epoch = int(self.state.epoch)
        # exact mid-epoch resume: skip the batches the restored step consumed
        resume_skip = 0
        if self.steps_per_epoch:
            done_in_epoch = self.state.global_step - start_epoch * self.steps_per_epoch
            if 0 < done_in_epoch < self.steps_per_epoch:
                resume_skip = done_in_epoch
        self._last_log_time = time.perf_counter()
        self._last_log_step = self.state.global_step
        profiler = None
        try:
            for epoch in range(start_epoch, config.epochs):
                self.control._new_epoch()
                self.callback_handler.on_epoch_begin(config, self.state, self.control)
                epoch_loss = Accumulator() if self._plateau is not None else None
                for batch in self._iter_batches(self.train_dataset, config.batch_size, config.shuffle, epoch,
                                                skip=resume_skip if epoch == start_epoch else 0):
                    self.control._new_step()
                    self.callback_handler.on_step_begin(config, self.state, self.control)
                    step = self.state.global_step
                    if config.profile_dir is not None and step == config.profile_start_step:
                        profiler = _start_profiler()
                    t0 = time.perf_counter()
                    with torch.profiler.record_function(f"train/{step}") if profiler else nullcontext():
                        metrics = self.train_step(self._put_batch(batch), step)
                    metrics["stats/time"] = time.perf_counter() - t0
                    accumulator.update(metrics)
                    if epoch_loss is not None:
                        epoch_loss.update({"loss": metrics["loss"]})
                    self.state.global_step += 1
                    if profiler and self.state.global_step >= config.profile_start_step + config.profile_num_steps:
                        self._stop_profiler(profiler)
                        profiler = None
                    self.state.epoch = epoch + (
                        (self.state.global_step % self.steps_per_epoch) / self.steps_per_epoch or 1.0
                    )
                    self.callback_handler.on_step_end(config, self.state, self.control)
                    self._maybe_log_save_evaluate(accumulator)
                    if self.control.should_training_stop or self.control.should_epoch_stop:
                        break
                # a stop mid-epoch keeps the fractional epoch, for an exact resume
                stopped_mid_epoch = bool(self.steps_per_epoch) and (
                    self.control.should_training_stop and self.state.global_step % self.steps_per_epoch != 0
                )
                if not stopped_mid_epoch:
                    self.state.epoch = float(epoch + 1)
                self.callback_handler.on_epoch_end(config, self.state, self.control)
                if epoch_loss is not None and not stopped_mid_epoch:
                    loss = epoch_loss.means().get("loss")
                    if loss is not None:
                        self.optimizer.plateau_scale = self._plateau.step(loss)
                self._maybe_log_save_evaluate(accumulator, prefix="train")
                if self.control.should_training_stop:
                    break
        finally:
            if profiler:
                self._stop_profiler(profiler)
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            self.save_checkpoint(name="checkpoint_last")
            if config.async_checkpoint:  # every queued write on disk before train() returns
                wait_for_async_saves()
            self.callback_handler.on_train_end(config, self.state, self.control)
            self.mesh.sequence_parallel = False  # as the JAX trainer clears its activation sharding
        return self.state

    def _maybe_log_save_evaluate(self, accumulator: Accumulator, prefix: str = "train_step"):
        if self.control.should_log:
            logs = {f"{prefix}/{k}": v for k, v in accumulator.means().items()}
            lr = float(self.optimizer.schedule(self.state.global_step))
            if self._plateau is not None:
                lr *= self._plateau.scale
            logs[f"{prefix}/lr"] = lr
            now = time.perf_counter()
            dsteps = self.state.global_step - self._last_log_step
            if dsteps > 0:
                logs[f"{prefix}/steps_per_sec"] = dsteps / max(1e-9, now - self._last_log_time)
            self._last_log_time, self._last_log_step = now, self.state.global_step
            self.state.log_history.append({"step": self.state.global_step, **logs})
            self.callback_handler.on_log(self.config, self.state, self.control, logs=logs)
            accumulator.reset()
            self.control.should_log = False

        if self.control.should_evaluate and self.config.do_eval and self.eval_dataset is not None:
            metrics = self.evaluate()
            self._track_best(metrics)
            self.callback_handler.on_evaluate(self.config, self.state, self.control, metrics=metrics)
            self.control.should_evaluate = False

        if self.control.should_save:
            if not self.config.save_best_only:
                name = "checkpoint_last" if self.config.save_rewrite_checkpoint else f"checkpoint_{self.state.global_step}"
                self.save_checkpoint(name=name)
            self.callback_handler.on_save(self.config, self.state, self.control)
            self.control.should_save = False

    def _stop_profiler(self, profiler) -> None:
        """Stop `profiler` and write its trace under `profile_dir`, named by
        the steps it holds."""
        profiler.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        first = self.config.profile_start_step
        path = os.path.join(self.config.profile_dir, f"trace_{first}-{self.state.global_step - 1}.json")
        profiler.export_chrome_trace(path)

    def _track_best(self, metrics: Dict[str, float]):
        key = f"eval/{self.config.metric_for_best_model}"
        value = metrics.get(key, metrics.get(self.config.metric_for_best_model))
        if value is None:
            return
        better = (
            self.state.best_metric is None
            or (self.config.metric_maximize and value > self.state.best_metric)
            or (not self.config.metric_maximize and value < self.state.best_metric)
        )
        if better:
            self.state.best_metric = float(value)
            self.state.best_model_checkpoint = self.save_checkpoint(name="checkpoint_best")

    def evaluate(self) -> Dict[str, float]:
        if not self.mesh.member:
            return {}
        self._prepare()
        accumulator = Accumulator()
        for i, batch in enumerate(self._iter_batches(self.eval_dataset, self.config.eval_batch_size, False, 0)):
            if self.config.eval_batches is not None and i >= self.config.eval_batches:
                break
            accumulator.update(self.eval_step(self._put_batch(batch), i))
        metrics = {f"eval/{k}": v for k, v in accumulator.means().items()}
        self.state.log_history.append({"step": self.state.global_step, **metrics})
        self.callback_handler.on_log(self.config, self.state, self.control, logs=metrics)
        return metrics

    def save_checkpoint(self, name: str = "checkpoint_last") -> str:
        with self.mesh.activate():
            path = save_checkpoint(
                os.path.join(self.config.output_dir, name),
                self.model,
                optimizer=self.optimizer if self.config.save_optimizer else None,
                trainer_state={
                    "epoch": self.state.epoch,
                    "global_step": self.state.global_step,
                    "best_metric": self.state.best_metric,
                    **({"plateau": self._plateau.state_dict()} if self._plateau is not None else {}),
                },
                model_config=self.model_config,
                use_async=self.config.async_checkpoint,
                sharded=self.config.sharded_checkpoint,
                mesh=self.mesh,
                specs=self.specs,
            )
        if not self.mesh.is_main:
            return path
        self.state.save_to_json(os.path.join(path, "trainer_state.json"))
        # ship the tokenizer config so checkpoints are renderable standalone
        tokenizer = getattr(self.train_dataset or self.eval_dataset, "tokenizer", None)
        if tokenizer is not None:
            tokenizer.save(os.path.join(path, "tokenizer.json"))
        return path


def _moe_metrics(out) -> Dict[str, torch.Tensor]:
    """The JAX trainer's names for an MoE model's aux loss and drop rate."""
    return {"loss/moe_aux": out.moe_aux, "stats/moe_drop": out.moe_drop}


@contextmanager
def _bf16_parameters(model: torch.nn.Module):
    """`model`'s floating parameters swapped for bf16 copies (one a
    parameter, however many modules share it), restored on exit; the copies'
    backward gives the fp32 parameters their gradients. (torch.func.
    functional_call does not restore parameters of a module registered under
    two parents, as the tied stream embeddings are.)"""
    casts, swapped = {}, []
    for module in model.modules():
        for name, p in module._parameters.items():
            if p is not None and p.is_floating_point():
                if id(p) not in casts:
                    casts[id(p)] = p.to(torch.bfloat16)
                swapped.append((module, name, p))
    try:
        for module, name, p in swapped:
            module._parameters[name] = casts[id(p)]
        yield
    finally:
        for module, name, p in swapped:
            module._parameters[name] = p


def _start_profiler():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _tensors(getattr(x, name))


def _finite_output_check(name: str):
    """A forward hook that raises FloatingPointError when a floating tensor
    of the module's output holds a non-finite value (`debug_nans`)."""

    def hook(module, args, output):
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"non-finite value in the output of {name} "
                                         f"({type(module).__name__}, {tuple(t.shape)} {t.dtype})")

    return hook


@contextmanager
def _anomaly_mode():
    """torch.autograd's anomaly mode around the forward and backward
    (`debug_nans`): a backward op that returns NaN raises FloatingPointError,
    naming the op, as jax_debug_nans names the primitive."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as err:
        if "nan values" not in str(err):
            raise
        raise FloatingPointError(str(err)) from err

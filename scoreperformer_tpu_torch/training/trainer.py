"""Trainer: train and eval steps, the epoch loop, checkpoints, callbacks.

Counterpart of scoreperformer_tpu/training/trainer.py on one device (the GPU
unless the model lives elsewhere). Batches are the JAX trainer's: each is a
pure function of (seed, epoch, batch index), made by the same formulas
(`_iter_batches`), so both frameworks see the very same data. Dropout, latent
dropout and the MMD samples draw from generators seeded per step from
(seed, step), as the JAX trainer folds its key. TensorBoard event files go to
{output_dir}/tb unless `tensorboard` is off, as in the JAX trainer. Meshes and
sharding, ZeRO, multihost, remat, bf16 compute, fine-tuning a subset, warm
starts and profiling are not ported yet and raise when set.
"""
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

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
from .checkpoint import load_checkpoint, save_checkpoint
from .optimizers import Optimizer, OptimizerConfig, global_norm


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

    # TensorBoard event files in {output_dir}/tb (training/tensorboard.py)
    tensorboard: bool = True

    # options of the JAX trainer that are not ported yet: each raises when set
    warm_start: bool = False
    finetune_layers: List[str] = field(default_factory=list)
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    mesh_expert: int = 1
    multihost: bool = False
    zero_sharding: bool = False
    sequence_parallel: bool = False
    bf16_compute: bool = False
    remat: bool = False
    async_checkpoint: bool = False
    sharded_checkpoint: bool = False
    debug_nans: bool = False
    profile_dir: Optional[str] = None


_NOT_PORTED = {
    "mesh_data": lambda c: c.mesh_data not in (None, 1),
    "mesh_model": lambda c: c.mesh_model != 1,
    "mesh_expert": lambda c: c.mesh_expert != 1,
    "multihost": lambda c: c.multihost,
    "zero_sharding": lambda c: c.zero_sharding,
    "sequence_parallel": lambda c: c.sequence_parallel,
    "bf16_compute": lambda c: c.bf16_compute,
    "remat": lambda c: c.remat,
    "async_checkpoint": lambda c: c.async_checkpoint,
    "sharded_checkpoint": lambda c: c.sharded_checkpoint,
    "debug_nans": lambda c: c.debug_nans,
    "profile_dir": lambda c: c.profile_dir is not None,
    "warm_start": lambda c: c.warm_start,
    "finetune_layers": lambda c: bool(c.finetune_layers),
}


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
        for name, is_set in _NOT_PORTED.items():
            if is_set(config):
                raise NotImplementedError(f"trainer option {name} is not ported yet")
        self.model = model
        self.device = next(model.parameters()).device
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
        cb = [DefaultFlowCallback(), JSONLMetricsCallback(), FileLogCallback()]
        if config.tensorboard:
            cb.append(TensorBoardCallback())
        if not config.disable_progress:
            cb.append(ProgressCallback(config.progress_metrics, config.progress_steps))
        self.callback_handler = CallbackHandler(cb + list(callbacks or []))

        self.optimizer: Optional[Optimizer] = None
        self._loaded = False
        self.steps_per_epoch = None
        if train_dataset is not None:
            self.steps_per_epoch = max(1, len(train_dataset) // config.batch_size)
        self.callback_handler.on_init_end(self.config, self.state, self.control)

    # ---- setup ----

    def setup_optimizer(self):
        self.optimizer = Optimizer(self.model.named_parameters(), self.config.optimization,
                                   self.steps_per_epoch or 1)

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

        loaded = load_checkpoint(path)
        load_state_dict(self.model, loaded["params"])
        if "opt_state" in loaded:
            self.optimizer.load_state_dict(loaded["opt_state"])
        ts = loaded.get("trainer_state")
        if ts is not None:
            self.state.epoch = ts.get("epoch", 0.0)
            self.state.global_step = ts.get("global_step", 0)
            self.state.best_metric = ts.get("best_metric")

    # ---- steps ----

    def train_step(self, batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """Forward, backward, clip and update; the metrics stay on the device."""
        self.model.train()
        out = self.model(**batch, generators=step_generators(self.config.seed, step, self.device))
        loss = out.loss.float()
        self.optimizer.zero_grad()
        loss.backward()
        with torch.no_grad():  # a parameter without a gradient adds 0 to the norm
            grads = [p.grad for p in self.optimizer.params if p.grad is not None]
            grad_norm = global_norm(grads) if grads else torch.zeros((), device=self.device)
        self.optimizer.step(grad_norm)
        metrics = {"loss": loss.detach(), "stats/grad_norm": grad_norm}
        metrics.update({k: v.detach().float() for k, v in out.losses.items()})
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], index: int) -> Dict[str, torch.Tensor]:
        self.model.eval()
        # deterministic but decorrelated across eval batches (the MMD samples)
        gens = {"mmd": step_generators(0, index, self.device)["mmd"]}
        out = self.model(**batch, generators=gens)
        metrics = {"loss": out.loss.float()}
        metrics.update({k: v.float() for k, v in out.losses.items()})
        if self.evaluator is not None and "labels" in batch:
            metrics.update(self.evaluator(batch["labels"], out.logits))
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
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True) for k, v in batch.items()}

    # ---- loops ----

    def train(self):
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
        try:
            for epoch in range(start_epoch, config.epochs):
                self.control._new_epoch()
                self.callback_handler.on_epoch_begin(config, self.state, self.control)
                for batch in self._iter_batches(self.train_dataset, config.batch_size, config.shuffle, epoch,
                                                skip=resume_skip if epoch == start_epoch else 0):
                    self.control._new_step()
                    self.callback_handler.on_step_begin(config, self.state, self.control)
                    t0 = time.perf_counter()
                    metrics = self.train_step(self._put_batch(batch), self.state.global_step)
                    metrics["stats/time"] = time.perf_counter() - t0
                    accumulator.update(metrics)
                    self.state.global_step += 1
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
                self._maybe_log_save_evaluate(accumulator, prefix="train")
                if self.control.should_training_stop:
                    break
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            self.save_checkpoint(name="checkpoint_last")
            self.callback_handler.on_train_end(config, self.state, self.control)
        return self.state

    def _maybe_log_save_evaluate(self, accumulator: Accumulator, prefix: str = "train_step"):
        if self.control.should_log:
            logs = {f"{prefix}/{k}": v for k, v in accumulator.means().items()}
            logs[f"{prefix}/lr"] = float(self.optimizer.schedule(self.state.global_step))
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
        path = save_checkpoint(
            os.path.join(self.config.output_dir, name),
            self.model,
            optimizer=self.optimizer if self.config.save_optimizer else None,
            trainer_state={
                "epoch": self.state.epoch,
                "global_step": self.state.global_step,
                "best_metric": self.state.best_metric,
            },
            model_config=self.model_config,
        )
        self.state.save_to_json(os.path.join(path, "trainer_state.json"))
        # ship the tokenizer config so checkpoints are renderable standalone
        tokenizer = getattr(self.train_dataset or self.eval_dataset, "tokenizer", None)
        if tokenizer is not None:
            tokenizer.save(os.path.join(path, "tokenizer.json"))
        return path

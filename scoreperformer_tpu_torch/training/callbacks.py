# Verbatim copy of scoreperformer_tpu/training/callbacks.py; the port imports nothing of the JAX package.
"""Trainer state, control flags, and the callback event API.

Counterpart of scoreperformer/experiments/callbacks.py:23-517.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TrainerState:
    """(callbacks.py:23-92)"""

    epoch: float = 0.0
    global_step: int = 0
    max_steps: int = 0
    num_train_epochs: int = 0
    total_flos: float = 0.0
    log_history: List[Dict] = field(default_factory=list)
    best_metric: Optional[float] = None
    best_model_checkpoint: Optional[str] = None

    def save_to_json(self, json_path: str):
        with open(json_path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, sort_keys=True)

    @classmethod
    def load_from_json(cls, json_path: str) -> "TrainerState":
        with open(json_path, "r") as f:
            data = json.load(f)
        return cls(**{k: v for k, v in data.items() if k in {f.name for f in dataclasses.fields(cls)}})


@dataclass
class TrainerControl:
    """(callbacks.py:95-147)"""

    should_training_stop: bool = False
    should_epoch_stop: bool = False
    should_log: bool = False
    should_evaluate: bool = False
    should_save: bool = False

    def _new_training(self):
        self.should_training_stop = False

    def _new_epoch(self):
        self.should_epoch_stop = False

    def _new_step(self):
        self.should_log = False
        self.should_evaluate = False
        self.should_save = False


class TrainerCallback:
    """11-event API (callbacks.py:150-259)."""

    def on_init_end(self, config, state, control, **kwargs):
        pass

    def on_train_begin(self, config, state, control, **kwargs):
        pass

    def on_train_end(self, config, state, control, **kwargs):
        pass

    def on_epoch_begin(self, config, state, control, **kwargs):
        pass

    def on_epoch_end(self, config, state, control, **kwargs):
        pass

    def on_step_begin(self, config, state, control, **kwargs):
        pass

    def on_step_end(self, config, state, control, **kwargs):
        pass

    def on_evaluate(self, config, state, control, metrics=None, **kwargs):
        pass

    def on_save(self, config, state, control, **kwargs):
        pass

    def on_log(self, config, state, control, logs=None, **kwargs):
        pass

    def on_prediction_step(self, config, state, control, **kwargs):
        pass


class CallbackHandler:
    """(callbacks.py:261-376). Deliberately does NOT inherit TrainerCallback:
    event dispatch happens via __getattr__, which inherited no-op methods
    would shadow."""

    def __init__(self, callbacks: List[TrainerCallback]):
        self.callbacks = list(callbacks)

    def add_callback(self, callback: TrainerCallback):
        self.callbacks.append(callback)

    def call_event(self, event: str, config, state, control, **kwargs):
        for callback in self.callbacks:
            result = getattr(callback, event)(config, state, control, **kwargs)
            if result is not None:
                control = result
        return control

    def __getattr__(self, name):
        if name.startswith("on_"):
            def event(config, state, control, **kwargs):
                return self.call_event(name, config, state, control, **kwargs)

            return event
        raise AttributeError(name)


class DefaultFlowCallback(TrainerCallback):
    """log/eval/save interval logic (callbacks.py:379-430)."""

    def on_step_end(self, config, state, control, **kwargs):
        if state.global_step == 1 and getattr(config, "log_first_step", False):
            control.should_log = True
        if (
            getattr(config, "log_strategy", "steps") == "steps"
            and getattr(config, "log_steps", 0) > 0
            and state.global_step % config.log_steps == 0
        ):
            control.should_log = True
        if (
            getattr(config, "eval_strategy", "no") == "steps"
            and getattr(config, "eval_steps", 0) > 0
            and state.global_step % config.eval_steps == 0
        ):
            control.should_evaluate = True
        if (
            getattr(config, "save_strategy", "no") == "steps"
            and getattr(config, "save_steps", 0) > 0
            and state.global_step % config.save_steps == 0
        ):
            control.should_save = True
        if 0 < state.max_steps <= state.global_step:
            control.should_training_stop = True
        return control

    def on_epoch_end(self, config, state, control, **kwargs):
        if getattr(config, "log_strategy", "steps") == "epoch":
            control.should_log = True
        if getattr(config, "eval_strategy", "no") == "epoch":
            if int(state.epoch) % max(1, getattr(config, "eval_steps", 1)) == 0:
                control.should_evaluate = True
        if getattr(config, "save_strategy", "no") == "epoch":
            if int(state.epoch) % max(1, getattr(config, "save_steps", 1)) == 0:
                control.should_save = True
        return control


class PrinterCallback(TrainerCallback):
    """(callbacks.py:495-502)"""

    def on_log(self, config, state, control, logs=None, **kwargs):
        if logs:
            print(json.dumps({"step": state.global_step, **logs}), file=sys.stdout, flush=True)


class FileLogCallback(TrainerCallback):
    """Tee human-readable training events to {output_dir}/log.txt — the
    counterpart of the reference's loguru console+file logger
    (experiments/logging/console_logger.py:7-30)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None

    def _write(self, config, msg: str):
        if self._fh is None:
            import os
            import time as _time

            path = self.path or os.path.join(config.output_dir, "log.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._fh = open(path, "a")
            self._fh.write(f"--- session {_time.strftime('%Y-%m-%d %H:%M:%S')} ---\n")
        import time as _time

        self._fh.write(f"[{_time.strftime('%H:%M:%S')}] {msg}\n")
        self._fh.flush()

    def on_train_begin(self, config, state, control, **kwargs):
        self._write(config, f"train begin: epochs={config.epochs} "
                            f"batch={config.batch_size} max_steps={state.max_steps}")

    def on_log(self, config, state, control, logs=None, **kwargs):
        if logs:
            parts = " ".join(
                f"{k}={v:.5g}" for k, v in logs.items() if isinstance(v, float)
            )
            self._write(config, f"step {state.global_step} epoch {state.epoch:.2f} {parts}")

    def on_save(self, config, state, control, **kwargs):
        self._write(config, f"checkpoint saved at step {state.global_step}")

    def on_train_end(self, config, state, control, **kwargs):
        self._write(config, f"train end: step {state.global_step} "
                            f"best={state.best_metric}")
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ProgressCallback(TrainerCallback):
    """Lightweight progress meter (callbacks.py:433-492 without tqdm)."""

    def __init__(self, metrics: Optional[List[str]] = None, print_every: int = 10):
        self.metrics = metrics or ["loss"]
        self.print_every = print_every

    def on_log(self, config, state, control, logs=None, **kwargs):
        if logs is None:
            return
        shown = {k: v for k, v in logs.items() if any(k.startswith(m) for m in self.metrics)}
        if shown:
            parts = " ".join(f"{k}={v:.4f}" for k, v in shown.items() if isinstance(v, float))
            print(f"[step {state.global_step} epoch {state.epoch:.2f}] {parts}", flush=True)


class JSONLMetricsCallback(TrainerCallback):
    """Dashboard-logger substitute: appends every log event to a JSONL file
    (the reference writes TensorBoard scalars, integrations.py:29-50; this
    environment ships no tensorboard)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None

    def on_train_begin(self, config, state, control, **kwargs):
        import os

        path = self.path or os.path.join(config.output_dir, "metrics.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._fh = open(path, "a")

    def on_log(self, config, state, control, logs=None, **kwargs):
        if logs and self._fh:
            self._fh.write(
                json.dumps({"step": state.global_step, "epoch": state.epoch, **logs}) + "\n"
            )
            self._fh.flush()

    def on_train_end(self, config, state, control, **kwargs):
        if self._fh:
            self._fh.close()
            self._fh = None


class EpochReproducibilityCallback(TrainerCallback):
    """Reseed dataset/collator at each epoch with (epoch+1)*seed
    (callbacks.py:505-517)."""

    def __init__(self, dataset=None, collator=None):
        self.dataset = dataset
        self.collator = collator

    def on_epoch_begin(self, config, state, control, **kwargs):
        seed = (int(state.epoch) + 1) * getattr(config, "seed", 23)
        if self.dataset is not None and hasattr(self.dataset, "reseed"):
            self.dataset.reseed(seed)
        if self.collator is not None and hasattr(self.collator, "reseed"):
            self.collator.reseed(seed)


class TensorBoardCallback(TrainerCallback):
    """TensorBoard scalar + config-text logging (reference
    integrations.py:14-55), via this repo's own event-file writer
    (`training/tensorboard.py`) since the tensorboard package is absent.
    Event files land in {output_dir}/tb and open in stock TensorBoard."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._writer = None

    def _ensure(self, config):
        if self._writer is None:
            import os

            from .tensorboard import TensorBoardWriter

            self._writer = TensorBoardWriter(
                self.log_dir or os.path.join(config.output_dir, "tb")
            )
        return self._writer

    def on_train_begin(self, config, state, control, **kwargs):
        import dataclasses
        import json as _json

        writer = self._ensure(config)
        try:
            cfg = dataclasses.asdict(config)
        except TypeError:
            cfg = {k: str(v) for k, v in vars(config).items()}
        writer.add_text(
            "config/trainer", _json.dumps(cfg, default=str, indent=2), step=0
        )

    def on_log(self, config, state, control, logs=None, **kwargs):
        if not logs:
            return
        writer = self._ensure(config)
        for key, value in logs.items():
            try:
                writer.add_scalar(key, float(value), state.global_step)
            except (TypeError, ValueError):
                continue
        writer.flush()

    def on_train_end(self, config, state, control, **kwargs):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

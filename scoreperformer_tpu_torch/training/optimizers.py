"""Optimizers held to optax's numbers.

Counterpart of scoreperformer_tpu/training/optimizers.py, which builds
    MultiSteps(apply_if_finite(chain(clip_by_global_norm, <optimizer>)))
on optax. `Optimizer` applies the same chain to a model's parameters in place:
- adam / adamw / sgd with optax's defaults (adamw's weight decay is 1e-4,
  not torch.optim.AdamW's 1e-2; adam's eps is added outside the square root);
- global-norm clipping as optax does it: g * max / norm when norm >= max
  (torch's clip_grad_norm_ divides by norm + 1e-6);
- a step whose (accumulated) gradients hold a non-finite entry is skipped and
  leaves every count where it was, so the schedule does not advance; finite
  entries whose squares overflow the global norm do not skip it;
- accumulation over k steps keeps optax's running mean and updates on the k-th.
The learning-rate schedules (constant, per-epoch exponential staircase,
cosine) are optax's. lamb, lion, adafactor, the plateau controller and
`flat_updates` are not ported yet and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ModuleConfig


@dataclass
class OptimizerConfig(ModuleConfig):
    lr: float = 1e-3
    optimizer: str = "adam"
    optimizer_params: Dict = field(default_factory=dict)
    lr_scheduler: Optional[str] = None
    lr_scheduler_params: Dict = field(default_factory=dict)
    grad_clip: Optional[float] = None
    grad_accum_steps: int = 1
    mixed_precision: bool = False
    flat_updates: bool = False


OPTIMIZERS = ("adam", "adamw", "sgd")
NOT_PORTED = ("lamb", "lion", "adafactor")
# optax's defaults per optimizer
_DEFAULTS = {
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4),
    "sgd": dict(momentum=None, nesterov=False),
}


def build_lr_schedule(config: OptimizerConfig, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """count -> lr, as optax's schedules. `exponential` anneals by gamma once
    per epoch (a staircase over steps)."""
    name, lr, p = config.lr_scheduler, config.lr, config.lr_scheduler_params or {}
    if name == "plateau":
        raise NotImplementedError("the plateau lr controller is not ported yet")
    if name in (None, "", "none", "constant"):
        return lambda count: lr
    if name == "exponential":
        gamma, every = float(p.get("gamma", 1.0)), max(1, steps_per_epoch)
        return lambda count: lr * gamma ** (count // every)
    if name == "cosine":
        decay_steps, alpha = int(p.get("decay_steps", 100_000)), float(p.get("alpha", 0.0))
        exponent = float(p.get("exponent", 1.0))

        def cosine(count):
            cos = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
            return lr * ((1 - alpha) * cos**exponent + alpha)

        return cosine
    raise ValueError(f"unknown lr scheduler {name}")


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, the power by repeated squaring, as XLA
    computes optax's bias correction: in fp32, 1 - 0.999**t loses about
    three digits, so the exact float64 value would not give optax's numbers."""
    x, acc, n = np.float32(decay), np.float32(1.0), count
    while n:
        if n & 1:
            acc = np.float32(acc * x)
        x, n = np.float32(x * x), n >> 1
    return float(np.float32(1.0) - acc)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm), on the device."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


class Optimizer:
    """The optax chain of `build_optimizer` over `named_params` (name,
    parameter) pairs; the state is keyed by parameter name."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], config: OptimizerConfig,
                 steps_per_epoch: int = 1):
        name = config.optimizer.lower()
        if name in NOT_PORTED:
            raise NotImplementedError(f"optimizer {name} is not ported yet; available: {OPTIMIZERS}")
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name}; available: {OPTIMIZERS}")
        if config.flat_updates:
            raise NotImplementedError("flat_updates is not ported yet")
        params = dict(config.optimizer_params or {})
        if "betas" in params:  # torch -> optax parameter names
            params["b1"], params["b2"] = params.pop("betas")
        unknown = set(params) - set(_DEFAULTS[name])
        if unknown:
            raise TypeError(f"{name} takes no parameters {sorted(unknown)}")
        self.name, self.hp = name, {**_DEFAULTS[name], **params}
        self.config = config
        self.schedule = build_lr_schedule(config, steps_per_epoch)
        self.names, self.params = [], []
        for n, p in named_params:
            if p.requires_grad:
                self.names.append(n)
                self.params.append(p)
        self.accum_steps = max(1, int(config.grad_accum_steps or 1))
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.count = 0  # applied updates: the adam and schedule count inside apply_if_finite
        self.mu = zeros() if name != "sgd" else None
        self.nu = zeros() if name != "sgd" else None
        self.trace = zeros() if name == "sgd" and self.hp["momentum"] is not None else None
        self.acc = zeros() if self.accum_steps > 1 else None
        self.mini_step = 0
        self.skipped = 0  # updates skipped for non-finite gradients

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One optax update from the parameters' `.grad` (None counts as 0).
        `grad_norm` may pass the global norm of these gradients when it is
        already computed."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.acc is not None:  # optax.MultiSteps: running mean, update on the k-th step
            n = self.mini_step
            torch._foreach_add_(self.acc, torch._foreach_div(torch._foreach_sub(grads, self.acc), n + 1.0))
            self.mini_step = (n + 1) % self.accum_steps
            if n < self.accum_steps - 1:
                return
            # optax resets the sums by multiplying with 0, which keeps a NaN
            # forever; here they restart at 0 after the update
            grads, self.acc = self.acc, [torch.zeros_like(p) for p in self.params]
            grad_norm = None
        norm = global_norm(grads) if grad_norm is None else grad_norm
        # optax.apply_if_finite checks every entry. A finite norm means every
        # entry is finite, so only a non-finite one (rare) pays a second check:
        # its squares may have overflowed from finite entries
        if not bool(torch.isfinite(norm)) and not bool(torch.stack([torch.isfinite(g).all() for g in grads]).all()):
            self.skipped += 1
            return
        clip = self.config.grad_clip
        if clip is not None and not bool(norm < clip):
            grads = torch._foreach_mul(torch._foreach_div(grads, norm), float(clip))
        lr = self.schedule(self.count)
        if self.name == "sgd":
            updates = grads
            if self.trace is not None:
                m = self.hp["momentum"]
                torch._foreach_mul_(self.trace, m)
                torch._foreach_add_(self.trace, grads)
                updates = torch._foreach_add(grads, self.trace, alpha=m) if self.hp["nesterov"] else self.trace
        else:
            b1, b2, eps, eps_root = self.hp["b1"], self.hp["b2"], self.hp["eps"], self.hp["eps_root"]
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
            t = self.count + 1
            mu_hat = torch._foreach_div(self.mu, _bias_correction(b1, t))
            nu_hat = torch._foreach_div(self.nu, _bias_correction(b2, t))
            if eps_root:
                torch._foreach_add_(nu_hat, eps_root)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(mu_hat, denom)
            if self.name == "adamw" and self.hp["weight_decay"]:
                torch._foreach_add_(updates, self.params, alpha=self.hp["weight_decay"])
        torch._foreach_add_(self.params, updates, alpha=-lr)
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    # ---- state ----

    def state_dict(self) -> Dict:
        def named(xs):
            return None if xs is None else {n: x.detach().cpu() for n, x in zip(self.names, xs)}

        return {"count": self.count, "mini_step": self.mini_step, "skipped": self.skipped,
                "mu": named(self.mu), "nu": named(self.nu), "trace": named(self.trace), "acc": named(self.acc)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        self.skipped = int(state.get("skipped", 0))
        for key in ("mu", "nu", "trace", "acc"):
            own, given = getattr(self, key), state.get(key)
            if own is None or given is None:
                continue
            with torch.no_grad():
                for name, x in zip(self.names, own):
                    x.copy_(torch.as_tensor(given[name]).to(x.dtype))

"""Optimizers held to optax's numbers.

Counterpart of scoreperformer_tpu/training/optimizers.py, which builds
    [flatten](MultiSteps(apply_if_finite(chain(clip_by_global_norm,
                                               <optimizer>, [plateau_scale]))))
on optax 0.2.6. `Optimizer` applies the same chain to a model's parameters in
place:
- adam / adamw / sgd / lamb / lion / adafactor with optax's defaults and
  formulas (adamw's weight decay is 1e-4, not torch.optim.AdamW's 1e-2; adam's
  eps is added outside the square root; lamb is adam, weight decay and one
  trust ratio a parameter; lion's weight decay is 1e-3; adafactor factors the
  second moment of a parameter whose two largest dims are both at least
  `min_dim_size_to_factor`, 128, taken in the JAX layout, decays it by
  1 - (t+1)^-0.8, clips each parameter's update to RMS 1 and multiplies it by
  the parameter's RMS, at least 1e-3);
- global-norm clipping as optax does it: g * max / norm when norm >= max
  (torch's clip_grad_norm_ divides by norm + 1e-6);
- a step whose (accumulated) gradients hold a non-finite entry is skipped and
  leaves every count where it was, so the schedule does not advance; finite
  entries whose squares overflow the global norm do not skip it;
- accumulation over k steps keeps optax's running mean and updates on the k-th;
- `flat_updates`, optax.flatten around the whole chain: every parameter is one
  vector, so lamb's trust ratio and adafactor's clipping and parameter scale
  are taken over all of them at once, and adafactor factors nothing;
- the `plateau` schedule: a constant lr whose updates are multiplied by
  `plateau_scale`, which the trainer sets from `PlateauController` once an
  epoch (the JAX package's PlateauScaleState leaf);
- optax's dtype and mask options: `mu_dtype` (adam, adamw, lion),
  `accumulator_dtype` (sgd) and `dtype_momentum` (adafactor) keep that
  moment in the dtype a recipe names ("bfloat16", ...), as optax casts it
  after each update (the update itself uses the uncast moment, and the
  decay times the stored moment is taken in fp32 with the decay rounded to
  the moment's dtype, as XLA computes it); `mask` (adamw, lamb, lion) and
  `weight_decay_mask` (adafactor) limit weight decay to the parameters
  whose flax path (`convert.jax_param_paths`, the `paths` argument) a tree
  of booleans, or a prefix of one, marks True, or that a callable of the
  {path: parameter} tree marks; `nesterov` (adam, adamw).
The learning-rate schedules (constant, per-epoch exponential staircase,
cosine) are optax's.

ZeRO-1 (`zero=(n, index)`, the trainer's `zero_sharding` on a data axis of
n ranks): each state buffer holds rank `index`'s slice of its parameter, on
the dimension JAX's `_zero_spec` picks (`parallel.mesh.zero_split_dim`);
a parameter with no such dimension keeps whole buffers. A step updates the
rank's slices from the (already averaged) gradients, sums lamb's and
adafactor's per-parameter squares over the slices, and all-gathers the
updated parameters. adafactor's factored row and column moments (and that
parameter's update) stay whole on every rank: the values are the same, only
memory differs.

A parameter that a model or expert axis splits (`shard_axes`: its axis, the
axis's size and the dimension it splits) is updated as optax updates the
whole one: the norms, the trust ratio and adafactor's RMS terms sum their
squares over the axis, and adafactor factors it by the whole parameter's
dims, its row and column means (and the rows' mean) summed over the axis
where the split dimension is the one they reduce.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ModuleConfig
from ..parallel.collectives import all_gather_list, all_reduce
from ..parallel.mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, zero_split_dim


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


# optax's defaults per optimizer
_DEFAULTS = {
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, nesterov=False),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, weight_decay=1e-4, mask=None,
                  nesterov=False),
    "sgd": dict(momentum=None, nesterov=False, accumulator_dtype=None),
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0, mask=None),
    "lion": dict(b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3, mask=None),
    "adafactor": dict(min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0, multiply_by_parameter_scale=True,
                      clipping_threshold=1.0, momentum=None, dtype_momentum="float32", weight_decay_rate=None,
                      eps=1e-30, factored=True, weight_decay_mask=None),
}
OPTIMIZERS = tuple(_DEFAULTS)


def _dtype(name: Any) -> Optional[torch.dtype]:
    """A moment's dtype from a recipe's name ("bfloat16", "float32", ...)
    or a torch dtype; None keeps the parameter's."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"{name!r} is not a floating dtype name")
    return dtype


def _mask_value(mask: Any, path: Tuple[str, ...]) -> bool:
    """The value a tree of booleans (or a prefix of one) gives the parameter
    at flax `path`, as optax's `masked` reads a mask tree."""
    node = mask
    for depth, key in enumerate(path):
        if not isinstance(node, Mapping):
            break
        if key not in node:
            raise KeyError(f"the mask has no entry {key!r} at {'/'.join(path[:depth]) or 'its root'}")
        node = node[key]
    if isinstance(node, Mapping):
        raise ValueError(f"the mask goes deeper than the parameter {'/'.join(path)}")
    return bool(node)


def _decayed(decay: float, moments: List[torch.Tensor]) -> List[torch.Tensor]:
    """decay x each stored moment of a dtype other than fp32, as XLA takes
    optax's `decay * moment`: the decay rounded to the moment's dtype, the
    product in fp32."""
    d = float(torch.tensor(decay, dtype=moments[0].dtype)) if moments else decay
    return [m.float() * d for m in moments]


class PlateauController:
    """Host-side ReduceLROnPlateau decision logic, as the JAX package's
    (scoreperformer_tpu/training/optimizers.py:105-193; the reference routes
    'plateau' to torch.optim.lr_scheduler.ReduceLROnPlateau and the trainer
    steps it with the epoch's mean train loss).

    Semantics match torch (mode='min', threshold_mode='rel'): an epoch is
    "bad" unless metric < best * (1 - threshold); after `patience` bad epochs
    the scale is multiplied by `factor` (floored at min_lr/lr) and a cooldown
    starts. `step(metric)` returns the current scale.
    """

    def __init__(self, factor: float = 0.1, patience: int = 10, threshold: float = 1e-4, cooldown: int = 0,
                 min_scale: float = 0.0, base_lr: float = 1.0, eps: float = 1e-8):
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.cooldown = int(cooldown)
        self.min_scale = float(min_scale)
        # torch skips a reduction when the absolute lr change is <= eps
        self.base_lr = float(base_lr)
        self.eps = float(eps)
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    @classmethod
    def from_config(cls, config: "OptimizerConfig") -> Optional["PlateauController"]:
        if config.lr_scheduler != "plateau":
            return None
        p = dict(config.lr_scheduler_params or {})
        min_lr = float(p.get("min_lr", 0.0))
        return cls(
            factor=float(p.get("factor", 0.1)),
            patience=int(p.get("patience", 10)),
            threshold=float(p.get("threshold", 1e-4)),
            cooldown=int(p.get("cooldown", 0)),
            min_scale=min_lr / config.lr if config.lr > 0 else 0.0,
            base_lr=config.lr,
            eps=float(p.get("eps", 1e-8)),
        )

    def step(self, metric: float) -> float:
        metric = float(metric)
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_scale = max(self.scale * self.factor, self.min_scale)
            if (self.scale - new_scale) * self.base_lr > self.eps:
                self.scale = new_scale
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> Dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter, "scale": self.scale}

    def load_state_dict(self, state: Dict) -> None:
        self.best = state.get("best")
        self.num_bad_epochs = int(state.get("num_bad_epochs", 0))
        self.cooldown_counter = int(state.get("cooldown_counter", 0))
        self.scale = float(state.get("scale", 1.0))


def build_lr_schedule(config: OptimizerConfig, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """count -> lr, as optax's schedules. `exponential` anneals by gamma once
    per epoch (a staircase over steps); `plateau` keeps the base lr, its decay
    is `Optimizer.plateau_scale`."""
    name, lr, p = config.lr_scheduler, config.lr, config.lr_scheduler_params or {}
    if name in (None, "", "none", "constant", "plateau"):
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


def _f32(x) -> float:
    return float(np.float32(x))


class Optimizer:
    """The optax chain of `build_optimizer` over `named_params` (name,
    parameter) pairs; the state is keyed by parameter name. `transposed`
    names the parameters whose JAX array is the transpose of the port's (Dense
    kernels, `convert.jax_param_paths`): adafactor picks the dims it factors
    in the JAX layout, where a square kernel's tie between its dims goes the
    JAX way."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], config: OptimizerConfig,
                 steps_per_epoch: int = 1, transposed: Iterable[str] = (), zero: Optional[Tuple[int, int]] = None,
                 shard_axes: Optional[Dict[str, Tuple[str, int, int]]] = None,
                 paths: Optional[Dict[str, Tuple[str, ...]]] = None):
        name = config.optimizer.lower()
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name}; available: {OPTIMIZERS}")
        params = dict(config.optimizer_params or {})
        if "betas" in params:  # torch -> optax parameter names
            params["b1"], params["b2"] = params.pop("betas")
        unknown = set(params) - set(_DEFAULTS[name])
        if unknown:
            raise TypeError(f"{name} takes no parameters {sorted(unknown)}")
        self.name, self.hp = name, {**_DEFAULTS[name], **params}
        self.config = config
        self.flat = bool(config.flat_updates)
        self.schedule = build_lr_schedule(config, steps_per_epoch)
        self.plateau_scale = 1.0 if config.lr_scheduler == "plateau" else None
        self.names, self.params = [], []
        for n, p in named_params:
            if p.requires_grad:
                self.names.append(n)
                self.params.append(p)
        transposed = set(transposed)
        self.transposed = [n in transposed for n in self.names]
        self.paths = [tuple((paths or {}).get(n) or n.split(".")) for n in self.names]
        mask = self.hp.get("mask", self.hp.get("weight_decay_mask"))
        if self.flat and mask is not None and not isinstance(mask, bool):
            raise ValueError(f"{name}: flat_updates flattens the parameters into one vector, which a mask tree "
                             "cannot address")
        self.decays = self._decay_mask(mask)
        self.moment_dtype = _dtype(self.hp.get("mu_dtype", self.hp.get("accumulator_dtype",
                                                                       self.hp.get("dtype_momentum"))))
        self.accum_steps = max(1, int(config.grad_accum_steps or 1))
        self._full = list(self.params)
        self.zero = zero if zero is not None and zero[0] > 1 else None
        self.numel = [p.numel() for p in self._full]
        # the mesh axis (model or expert), its size and the split dim of each parameter the model splits
        shards = [(shard_axes or {}).get(n) for n in self.names]
        self.shard_axes = [None if a is None else a[0] for a in shards]
        self.shard_dims = [None if a is None else a[2] for a in shards]
        self.numel = [k * (1 if a is None else a[1]) for k, a in zip(self.numel, shards)]
        whole = [tuple(s * (a[1] if a is not None and i == a[2] else 1) for i, s in enumerate(p.shape))
                 for p, a in zip(self._full, shards)]
        self.factored_dims = [None] * len(self._full)
        if name == "adafactor" and not self.flat:
            self.factored_dims = [self._factored_dims(shape, t) for shape, t in zip(whole, self.transposed)]
        self.split: List[Optional[int]] = [None] * len(self._full)  # ZeRO's dim of each parameter
        if self.zero is not None:
            n, index = self.zero
            for i, p in enumerate(self.full):
                if self.factored_dims[i] is None:
                    self.split[i] = zero_split_dim(tuple(p.shape), n)
            self.params = [p if dim is None else p.detach().narrow(dim, index * (p.shape[dim] // n), p.shape[dim] // n)
                           for p, dim in zip(self.full, self.split)]
        zeros = lambda dtype=None: [torch.zeros_like(p, dtype=dtype) for p in self.params]  # noqa: E731
        self.count = 0  # applied updates: the moments' and schedule's count inside apply_if_finite
        self.mu = zeros(self.moment_dtype) if name in ("adam", "adamw", "lamb", "lion") else None
        self.nu = zeros() if name in ("adam", "adamw", "lamb") else None
        self.trace = None
        if name in ("sgd", "adafactor") and self.hp["momentum"] is not None:
            self.trace = zeros(self.moment_dtype)
        self.v_row = self.v_col = self.v = None
        if name == "adafactor":
            self.v_row, self.v_col, self.v = [], [], []
            for p, dims in zip(self.params, self.factored_dims):
                none = p.new_zeros(1)
                if dims is None:
                    self.v_row.append(none), self.v_col.append(none), self.v.append(torch.zeros_like(p))
                else:  # row stats reduce the largest dim d0, column stats the second d1
                    d1, d0 = dims
                    self.v_row.append(p.new_zeros([s for i, s in enumerate(p.shape) if i != d0]))
                    self.v_col.append(p.new_zeros([s for i, s in enumerate(p.shape) if i != d1]))
                    self.v.append(none)
        self.acc = [torch.zeros_like(p) for p in self.full] if self.accum_steps > 1 else None
        self.mini_step = 0
        self.skipped = 0  # updates skipped for non-finite gradients

    def _factored_dims(self, shape: Tuple[int, ...], transposed: bool) -> Optional[Tuple[int, int]]:
        """optax's `_factored_dims` on the JAX layout of a (whole) parameter
        of the port's `shape`: (d1, d0), the second largest and the largest
        dim (stable argsort), as dims of the port's tensor; None when the
        second largest is below `min_dim_size_to_factor` or `factored` is off."""
        shape = tuple(shape)[::-1] if transposed else tuple(shape)
        if not self.hp["factored"] or len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.hp["min_dim_size_to_factor"]:
            return None
        d1, d0 = int(order[-2]), int(order[-1])
        if transposed:
            d1, d0 = len(shape) - 1 - d1, len(shape) - 1 - d0
        return d1, d0

    def _decay_mask(self, mask) -> List[bool]:
        """Which parameters take weight decay: all without a mask."""
        if mask is None:
            return [True] * len(self.names)
        if callable(mask):
            tree: Dict = {}
            for path, p in zip(self.paths, self.params):
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = p
            mask = mask(tree)
        return [_mask_value(mask, path) for path in self.paths]

    def _add_decayed_weights(self, updates: List[torch.Tensor], weight_decay: float) -> None:
        """optax.add_decayed_weights(weight_decay, mask), in place."""
        idx = [i for i, keep in enumerate(self.decays) if keep]
        if weight_decay and idx:
            torch._foreach_add_([updates[i] for i in idx], [self.params[i] for i in idx], alpha=weight_decay)

    def _update_moment(self, name: str, grads: List[torch.Tensor], decay: float) -> List[torch.Tensor]:
        """optax's first-moment update (1 - decay) g + decay m of the state
        buffers `name`; returns the new moment (fp32), stored in the
        moment's dtype."""
        moments = getattr(self, name)
        if self.moment_dtype in (None, torch.float32):
            torch._foreach_mul_(moments, decay)
            torch._foreach_add_(moments, grads, alpha=1 - decay)
            return moments
        new = torch._foreach_add(_decayed(decay, moments), grads, alpha=1 - decay)
        setattr(self, name, [m.to(self.moment_dtype) for m in new])
        return new

    def _mean(self, i: int, x: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
        """The mean of x over `dim` of parameter i, whose whole size there
        is `whole`: summed over the model or expert axis when that axis
        splits this dim."""
        if self.shard_dims[i] != dim:
            return x.mean(dim=dim)
        return all_reduce(x.sum(dim=dim), self.shard_axes[i]) / whole

    # ---- reductions over a block: one parameter, or all of them with `flat_updates` ----

    def _whole_sums(self, sums: List[torch.Tensor], sliced: bool) -> List[torch.Tensor]:
        """Per-parameter sums of a function of its entries, summed over the
        blocks of a split parameter: its ZeRO slices (when `sliced`, the
        entries are this rank's slices) and its model or expert shards."""
        sums = list(sums)
        for axis in (DATA_AXIS, MODEL_AXIS, EXPERT_AXIS):
            idx = [i for i in range(len(sums))
                   if (axis == DATA_AXIS and sliced and self.split[i] is not None) or self.shard_axes[i] == axis]
            if idx:
                total = all_reduce(torch.stack([sums[i] for i in idx]), axis)
                for j, i in enumerate(idx):
                    sums[i] = total[j]
        return sums

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the whole gradients, from this rank's
        (model- or expert-split) gradients of `full`."""
        if not any(self.shard_axes):
            return global_norm(grads)
        return torch.sqrt(sum(self._whole_sums([(g.float() * g.float()).sum() for g in grads], sliced=False)))

    def _block_sums(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum of squares of each block, one entry a parameter (summed over
        its ZeRO slices and model or expert shards)."""
        sums = self._whole_sums([(x * x).sum() for x in xs], sliced=True)
        if self.flat:
            total = torch.stack(sums).sum()
            return [total] * len(xs)
        return sums

    def _block_sizes(self, xs: List[torch.Tensor]) -> List[int]:
        return [sum(self.numel)] * len(xs) if self.flat else list(self.numel)

    def _block_rms(self, xs):
        return [torch.sqrt(s / n) for s, n in zip(self._block_sums(xs), self._block_sizes(xs))]

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One optax update from the parameters' `.grad` (None counts as 0).
        `grad_norm` may pass the global norm of these gradients when it is
        already computed."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.full]
        if self.acc is not None:  # optax.MultiSteps: running mean, update on the k-th step
            n = self.mini_step
            torch._foreach_add_(self.acc, torch._foreach_div(torch._foreach_sub(grads, self.acc), n + 1.0))
            self.mini_step = (n + 1) % self.accum_steps
            if n < self.accum_steps - 1:
                return
            # optax resets the sums by multiplying with 0, which keeps a NaN
            # forever; here they restart at 0 after the update
            grads, self.acc = self.acc, [torch.zeros_like(p) for p in self.full]
            grad_norm = None
        norm = self.global_norm(grads) if grad_norm is None else grad_norm
        # optax.apply_if_finite checks every entry. A finite norm means every
        # entry is finite, so only a non-finite one (rare) pays a second check:
        # its squares may have overflowed from finite entries
        if not bool(torch.isfinite(norm)) and bool(sum(self._whole_sums(
                [(~torch.isfinite(g)).sum().float() for g in grads], sliced=False)) > 0):
            self.skipped += 1
            return
        grads = [g if dim is None else g.narrow(dim, self._start(i), p.shape[dim])
                 for i, (g, p, dim) in enumerate(zip(grads, self.params, self.split))]
        clip = self.config.grad_clip
        if clip is not None and not bool(norm < clip):
            grads = torch._foreach_mul(torch._foreach_div(grads, norm), float(clip))
        lr = self.schedule(self.count)
        updates = getattr(self, f"_{self.name}")(grads, lr)  # the update to add, its sign included
        if self.plateau_scale is not None:
            torch._foreach_mul_(updates, _f32(self.plateau_scale))
        torch._foreach_add_(self.params, updates)
        self._gather_params()
        self.count += 1

    @property
    def full(self) -> List[torch.Tensor]:
        """The parameters (`params` holds what this rank updates: with ZeRO,
        views of its slices)."""
        return self._full if self.zero is not None else self.params

    def _start(self, i: int) -> int:
        """The first index of this rank's ZeRO slice of parameter i."""
        n, index = self.zero
        return index * (self.full[i].shape[self.split[i]] // n)

    def _gather_params(self) -> None:
        """All-gather the updated ZeRO slices into the whole parameters, in
        one collective."""
        sliced = [i for i, dim in enumerate(self.split) if dim is not None]
        if not sliced:
            return
        flat = torch.cat([self.params[i].reshape(-1) for i in sliced])
        blocks = [b.split([self.params[i].numel() for i in sliced]) for b in all_gather_list(flat, DATA_AXIS)]
        for j, i in enumerate(sliced):
            shape = self.params[i].shape
            self.full[i].data.copy_(torch.cat([b[j].view(shape) for b in blocks], self.split[i]))

    # ---- the optimizers: gradients (clipped) -> the update to add ----

    def _sgd(self, grads, lr):
        updates = grads
        if self.trace is not None:
            m = self.hp["momentum"]
            if self.moment_dtype in (None, torch.float32):
                torch._foreach_mul_(self.trace, m)
                torch._foreach_add_(self.trace, grads)
                trace = self.trace
            else:  # optax.trace: g + decay * t, stored in accumulator_dtype
                trace = [g + t for g, t in zip(grads, _decayed(m, self.trace))]
                self.trace = [t.to(self.moment_dtype) for t in trace]
            updates = torch._foreach_add(grads, trace, alpha=m) if self.hp["nesterov"] else trace
        return torch._foreach_mul(updates, -lr)

    def _scale_by_adam(self, grads):
        b1, b2, eps, eps_root = self.hp["b1"], self.hp["b2"], self.hp["eps"], self.hp["eps_root"]
        mu = self._update_moment("mu", grads, b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
        t = self.count + 1
        if self.hp.get("nesterov"):  # b1 * bias_correction(mu, t + 1) + (1 - b1) * bias_correction(g, t)
            c1, c0 = _bias_correction(b1, t + 1), _bias_correction(b1, t)
            mu_hat = [b1 * (m / c1) + (1 - b1) * (g / c0) for m, g in zip(mu, grads)]
        else:
            mu_hat = torch._foreach_div(mu, _bias_correction(b1, t))
        nu_hat = torch._foreach_div(self.nu, _bias_correction(b2, t))
        if eps_root:
            torch._foreach_add_(nu_hat, eps_root)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        return torch._foreach_div(mu_hat, denom)

    def _adam(self, grads, lr):
        return torch._foreach_mul(self._scale_by_adam(grads), -lr)

    def _adamw(self, grads, lr):
        updates = self._scale_by_adam(grads)
        self._add_decayed_weights(updates, self.hp["weight_decay"])
        return torch._foreach_mul(updates, -lr)

    def _lamb(self, grads, lr):
        """scale_by_adam, add_decayed_weights, scale_by_trust_ratio: each
        block's update times |param| / |update|, 1 where either is 0."""
        updates = self._scale_by_adam(grads)
        self._add_decayed_weights(updates, self.hp["weight_decay"])
        p_norms = [torch.sqrt(s) for s in self._block_sums(self.params)]
        u_norms = [torch.sqrt(s) for s in self._block_sums(updates)]
        ratios = [torch.where((pn == 0) | (un == 0), 1.0, pn / un) for pn, un in zip(p_norms, u_norms)]
        torch._foreach_mul_(updates, ratios)
        return torch._foreach_mul(updates, -lr)

    def _lion(self, grads, lr):
        """sign((1-b1) g + b1 mu), then mu = (1-b2) g + b2 mu; weight decay."""
        b1, b2 = self.hp["b1"], self.hp["b2"]
        if self.moment_dtype in (None, torch.float32):
            updates = [torch.sign((1.0 - b1) * g + b1 * m) for g, m in zip(grads, self.mu)]
            self.mu = [(1.0 - b2) * g + b2 * m for g, m in zip(grads, self.mu)]
        else:  # mu_dtype: the decays times the stored moment as XLA takes them
            updates = [torch.sign((1.0 - b1) * g + m) for g, m in zip(grads, _decayed(b1, self.mu))]
            self._update_moment("mu", grads, b2)
        self._add_decayed_weights(updates, self.hp["weight_decay"])
        return torch._foreach_mul(updates, -lr)

    def _adafactor(self, grads, lr):
        """scale_by_factored_rms, clip_by_block_rms, the lr, scale_by_param_
        block_rms, [ema], [add_decayed_weights], scale(-1)."""
        hp = self.hp
        t = np.float32(self.count - hp["decay_offset"] + 1)
        decay = _f32(np.float32(1.0) - t ** np.float32(-hp["decay_rate"]))
        keep = _f32(np.float32(1.0) - np.float32(decay))
        updates = []
        for i, (g, dims) in enumerate(zip(grads, self.factored_dims)):
            g2 = g * g + hp["eps"]
            if dims is None:
                self.v[i] = decay * self.v[i] + keep * g2
                updates.append(g * self.v[i] ** -0.5)
                continue
            d1, d0 = dims
            n0, n1 = (g.shape[d] * (self.numel[i] // g.numel()) if self.shard_dims[i] == d else g.shape[d]
                      for d in (d0, d1))
            self.v_row[i] = decay * self.v_row[i] + keep * self._mean(i, g2, d0, n0)
            self.v_col[i] = decay * self.v_col[i] + keep * self._mean(i, g2, d1, n1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            if self.shard_dims[i] == d1:  # the rows' mean over the whole d1
                row_mean = all_reduce(self.v_row[i].sum(dim=reduced_d1), self.shard_axes[i]) / n1
            else:
                row_mean = self.v_row[i].mean(dim=reduced_d1)
            row_factor = (self.v_row[i] / row_mean.unsqueeze(reduced_d1)) ** -0.5
            col_factor = self.v_col[i] ** -0.5
            updates.append(g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
        if hp["clipping_threshold"] is not None:
            clip = float(hp["clipping_threshold"])
            denoms = [torch.clamp(rms / clip, min=1.0) for rms in self._block_rms(updates)]
            updates = torch._foreach_div(updates, denoms)
        updates = torch._foreach_mul(updates, lr)
        if hp["multiply_by_parameter_scale"]:
            scales = [torch.clamp(rms, min=1e-3) for rms in self._block_rms(self.params)]
            updates = torch._foreach_mul(updates, scales)
        if self.trace is not None:  # optax.ema, not debiased, stored in dtype_momentum
            updates = [u.clone() for u in self._update_moment("trace", updates, hp["momentum"])]
        if hp["weight_decay_rate"] is not None:
            self._add_decayed_weights(updates, hp["weight_decay_rate"])
        return torch._foreach_neg(updates)

    def zero_grad(self) -> None:
        for p in self.full:
            p.grad = None

    # ---- state ----

    _STATE = ("mu", "nu", "trace", "acc", "v_row", "v_col", "v")

    def state_dict(self) -> Dict:
        """The state, each buffer this rank's (ZeRO slices as they are)."""
        def named(xs):
            return None if xs is None else {n: x.detach().cpu() for n, x in zip(self.names, xs)}

        return {"count": self.count, "mini_step": self.mini_step, "skipped": self.skipped,
                "plateau_scale": self.plateau_scale, **{key: named(getattr(self, key)) for key in self._STATE}}

    def full_state_dict(self) -> Dict:
        """The state with every ZeRO slice joined into the whole buffer
        (collective over the data axis: every rank calls it)."""
        state = self.state_dict()
        for key in self._STATE:
            if state[key] is None:
                continue
            for i, (name, dim) in enumerate(zip(self.names, self.split)):
                if dim is not None and state[key][name].shape != self.full[i].shape:
                    own = getattr(self, key)[i].contiguous()
                    state[key][name] = torch.cat(all_gather_list(own, DATA_AXIS), dim).cpu()
        return state

    def load_state_dict(self, state: Dict) -> None:
        """Load a state; a whole buffer of a ZeRO-sliced parameter loads
        this rank's slice of it."""
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        self.skipped = int(state.get("skipped", 0))
        if self.plateau_scale is not None and state.get("plateau_scale") is not None:
            self.plateau_scale = float(state["plateau_scale"])
        for key in self._STATE:
            own, given = getattr(self, key), state.get(key)
            if own is None or given is None:
                continue
            with torch.no_grad():
                for i, (name, x) in enumerate(zip(self.names, own)):
                    value = torch.as_tensor(given[name])
                    dim = self.split[i]
                    if dim is not None and value.shape != x.shape:
                        value = value.narrow(dim, self._start(i), x.shape[dim])
                    x.copy_(value.to(x.dtype))

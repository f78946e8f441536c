"""GPipe over a `pipe` axis: the counterpart of
scoreperformer_tpu/parallel/pipeline.py.

A trunk's depth units (one attention and one feed-forward block of a
`TransformerStack` with the ('a', 'f') pattern, with their norms) share one
set of parameter names, so their parameters stack on a leading depth axis
(`stack_unit_params`). Stage s of S holds units [s*D/S, (s+1)*D/S) of it
(`stage_params`, which also splits each unit over `model` as the model
axis splits a stack, `parallel/shard.py`), and `pipeline_apply` runs JAX's
GPipe schedule on the process mesh of `make_pipeline_mesh`:
- M + S - 1 ticks; at tick t stage 0 takes microbatch t and stage s works
  on microbatch t - s; each rank's rows (its data block) split into the M
  microbatches, so every microbatch is split over `data`; the mask and the
  AdaNorm style rows go with their microbatch;
- a rank skips the compute of its bubble ticks (the dead dataflow XLA
  eliminates) and still joins every tick's hop (`collectives.pipe_shift`);
- the last stage's outputs are replicated over `pipe`
  (`collectives.replicate_last_stage`, the masked psum), so every pipe rank
  returns the trunk's output for its data rows and computes the loss from
  it; that replicated loss counts once;
- deterministic (the unit runs in eval mode), as JAX applies it.

One autograd Function holds the schedule. Its forward keeps each
microbatch's stage graph; its backward runs the ticks in reverse, calls
`torch.autograd.grad` on each microbatch's stage output with the gradient
that hopped back from the next stage, and issues the same collectives in
the same order on every rank. The input's gradient (stage 0's) and the
style rows' gradient (summed over the stages that read them) reach every
pipe rank, where the replicated computation upstream of the trunk needs
them. The stage's parameter gradients are this data rank's: sum them over
`data` (`sum_gradients_over_data`), as the data axis sums them.

As in JAX, only tests and the dry run (`parallel/dryrun.py`) reach it: the
trainer has no `pipe` option.
"""
from __future__ import annotations

import dataclasses
import re
from contextlib import nullcontext
from typing import Dict, Iterable, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..models.transformer import TransformerConfig, TransformerStack
from .collectives import _all_reduce, all_gather, all_gather_list, all_reduce, pipe_shift, replicate_last_stage
from .mesh import DATA_AXIS, PIPE_AXIS, ProcessMesh, make_pipeline_mesh  # noqa: F401 - make_pipeline_mesh re-exported
from .shard import Shard

_LAYER = re.compile(r"layers\.(\d+)\.(.+)")


def make_unit_module(config: TransformerConfig) -> TransformerStack:
    """A depth-1 `TransformerStack` with no final norm: one depth unit."""
    if config.cross_attend:
        raise ValueError("pipeline_apply takes the ('a', 'f') layer pattern; a cross-attend stack keeps "
                         "the data and model axes")
    if config.feed_forward.num_experts > 1:
        raise NotImplementedError("pipeline parallelism does not compose with MoE feed-forward "
                                  "(num_experts > 1): depth units no longer share one set of parameters")
    return TransformerStack(dataclasses.replace(config, depth=1, final_norm=False))


def stack_unit_params(stack_params: Dict[str, torch.Tensor], depth: int) -> Dict[str, torch.Tensor]:
    """A depth-D stack's parameters (its `state_dict()` names) restacked
    under the unit's names with a leading depth axis: unit u holds layers
    2u (attention) and 2u+1 (feed-forward) and their norms. The final norm
    is left out."""
    units: List[Dict[str, torch.Tensor]] = [{} for _ in range(depth)]
    for name, value in stack_params.items():
        match = _LAYER.fullmatch(name)
        if match is not None:
            i = int(match.group(1))
            units[i // 2][f"layers.{i % 2}.{match.group(2)}"] = value
    return {name: torch.stack([unit[name] for unit in units]) for name in units[0]}


def unstack_unit_tree(stacked: Dict[str, torch.Tensor], depth: int) -> Dict[str, torch.Tensor]:
    """The inverse of `stack_unit_params` (e.g. stacked gradients back onto
    the stack's names)."""
    out = {}
    for name, value in stacked.items():
        j, rest = _LAYER.fullmatch(name).groups()
        for u in range(depth):
            out[f"layers.{2 * u + int(j)}.{rest}"] = value[u]
    return out


def _stacked_shard(spec: Shard) -> Shard:
    return Shard(spec.axis, spec.dim + 1, spec.halves)  # one dim right of the depth axis


def stage_params(stacked: Dict[str, torch.Tensor], mesh: ProcessMesh,
                 specs: Optional[Dict[str, Shard]] = None) -> Dict[str, torch.Tensor]:
    """This rank's block of a stacked tree (JAX's `stacked_params_shardings`):
    its stage's contiguous depth / pipe units, each split over `model` as
    `specs` (`shard_model` of the unit module on this mesh) says."""
    stages, s = mesh.size(PIPE_AXIS), mesh.index(PIPE_AXIS)
    depth = next(iter(stacked.values())).shape[0]
    if depth % stages:
        raise ValueError(f"depth {depth} does not split over {stages} pipeline stages")
    k = depth // stages
    out = {}
    for name, value in stacked.items():
        value = value[s * k:(s + 1) * k]
        spec = (specs or {}).get(name)
        if spec is not None:
            value = _stacked_shard(spec).take(value, mesh.size(spec.axis), mesh.index(spec.axis))
        out[name] = value.contiguous()
    return out


def whole_stacked(tree: Dict[str, torch.Tensor], specs: Optional[Dict[str, Shard]] = None) -> Dict[str, torch.Tensor]:
    """The whole stacked tree from every rank's `stage_params` block (of
    parameters or their gradients): joined over `model`, then over `pipe`.
    Collective over the active mesh: every rank calls it."""
    out = {}
    for name, value in tree.items():
        spec = (specs or {}).get(name)
        if spec is not None:
            value = _stacked_shard(spec).join(all_gather_list(value.contiguous(), spec.axis))
        out[name] = all_gather(value.contiguous(), PIPE_AXIS, dim=0)
    return out


def sum_gradients_over_data(params: Iterable[torch.Tensor]) -> None:
    """Each gradient summed over the active mesh's data axis, in one all-reduce."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), DATA_AXIS)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def _rows(t: Optional[torch.Tensor], m: int) -> List[Optional[torch.Tensor]]:
    return [None] * m if t is None else list(t.chunk(m))


class _Schedule:
    """The GPipe ticks of this rank: stage `stage` of `stages`, `m`
    microbatches, the unit applied `units` times with the stage's stacked
    parameters."""

    def __init__(self, unit: nn.Module, names: List[str], mesh: ProcessMesh, m: int):
        self.unit, self.names, self.m = unit, names, m
        self.stages, self.stage = mesh.size(PIPE_AXIS), mesh.index(PIPE_AXIS)
        self.group = mesh.group(PIPE_AXIS)

    def apply_stage(self, h, mask, style, params):
        for u in range(params[0].shape[0]):
            h = functional_call(self.unit, {n: p[u] for n, p in zip(self.names, params)}, (h,),
                                {"mask": mask, "style_embeddings": style})
        return h

    def hop(self, y, t, step, like):
        """The tick's hop: forward (step 1) a stage's output to the next
        stage, backward (step -1) its input's gradient to the one before."""
        s, n, m = self.stage, self.stages, self.m
        if n == 1:
            return None
        sends = 0 <= t - s < m and 0 <= s + step < n
        receives = 0 <= t - (s - step) < m and 0 <= s - step < n
        return pipe_shift(y, self.group, n, s, step, sends, receives, like)

    def forward(self, x, mask, style, params, keep: bool):
        """The forward ticks. Returns the last stage's outputs (zeros on the
        other stages) and, with `keep`, each microbatch's (input, style
        rows, output) of this stage's graph."""
        s, n, m = self.stage, self.stages, self.m
        xs, masks, styles = _rows(x, m), _rows(mask, m), _rows(style, m)
        outs = torch.zeros_like(x)
        rows = x.shape[0] // m
        saved, recv = [], None
        for t in range(m + n - 1):
            i, y = t - s, None
            if 0 <= i < m:
                inp, sty = (xs[i] if s == 0 else recv), styles[i]
                if keep:
                    inp = inp.detach().requires_grad_(s > 0 or x.requires_grad)
                    sty = None if sty is None else sty.detach().requires_grad_(style.requires_grad)
                with torch.enable_grad() if keep else nullcontext():
                    y = self.apply_stage(inp, masks[i], sty, params)
                if keep:
                    saved.append((inp, sty, y))
                if s == n - 1:
                    outs[i * rows:(i + 1) * rows] = y.detach()
            if t < m + n - 2:  # the last tick moves nothing
                recv = self.hop(y, t, 1, xs[0])
        return outs, saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule: _Schedule, x, mask, style, *params):
        aliases = [p.detach().requires_grad_(p.requires_grad) for p in params]
        outs, saved = schedule.forward(x, mask, style, aliases, keep=True)
        ctx.schedule, ctx.graphs, ctx.aliases = schedule, saved, aliases
        ctx.x_grad, ctx.style = x.requires_grad, style
        ctx.like = x.chunk(schedule.m)[0].detach()
        return outs

    @staticmethod
    def backward(ctx, grad):
        sch, graphs, aliases = ctx.schedule, ctx.graphs, ctx.aliases
        s, n, m = sch.stage, sch.stages, sch.m
        rows = grad.shape[0] // m
        style = ctx.style
        style_grad = style is not None and style.requires_grad
        grad_x = torch.zeros_like(grad) if ctx.x_grad else None
        grad_style = torch.zeros_like(style) if style_grad else None
        grad_params: List[Optional[torch.Tensor]] = [None] * len(aliases)
        trained = [j for j, a in enumerate(aliases) if a.requires_grad]
        recv = None
        for t in reversed(range(m + n - 1)):
            i, g_in = t - s, None
            if 0 <= i < m:
                inp, sty, y = graphs[i]
                graphs[i] = None
                g_out = grad[i * rows:(i + 1) * rows] if s == n - 1 else recv
                inputs = ([inp] if inp.requires_grad else []) + ([sty] if style_grad else []) + \
                    [aliases[j] for j in trained]
                got = list(torch.autograd.grad(y, inputs, g_out, allow_unused=True))
                if inp.requires_grad:
                    g_in = got.pop(0)
                    if s == 0:
                        grad_x[i * rows:(i + 1) * rows] = g_in
                if style_grad:
                    g_sty = got.pop(0)
                    if g_sty is not None:
                        grad_style[i * rows:(i + 1) * rows] += g_sty
                for j, g in zip(trained, got):
                    if g is not None:
                        grad_params[j] = g if grad_params[j] is None else grad_params[j] + g
            if t > 0:  # the first reverse tick's gradient has nowhere to go
                recv = sch.hop(g_in, t, -1, ctx.like)
        # the input reaches stage 0 only, the style rows every stage; the
        # computation upstream is replicated over `pipe`, so every pipe rank
        # takes their whole gradients
        if n > 1:
            if grad_x is not None:
                grad_x = _all_reduce(grad_x, sch.group)
            if grad_style is not None:
                grad_style = _all_reduce(grad_style, sch.group)
        return (None, grad_x, None, grad_style, *grad_params)


def pipeline_apply(unit: TransformerStack, stage_tree: Dict[str, torch.Tensor], x: torch.Tensor,
                   mesh: ProcessMesh, num_microbatches: int, mask: Optional[torch.Tensor] = None,
                   style_embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The trunk's output (before any final norm) for this data rank's rows
    `x` (b, t, dim), on every pipe rank, by the GPipe schedule over `mesh`.

    Args:
      unit: `make_unit_module(config)`, split over the mesh's model axis by
        `shard_model` when it has one (its own parameters are not used).
      stage_tree: this rank's `stage_params` block, leading axis = its units.
      x: this data rank's rows; b must divide by `num_microbatches`.
      mask: optional (b, t) padding mask; style_embeddings: optional
        (b, t, e) / (b, e) AdaNorm condition.
    """
    m = int(num_microbatches)
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} does not split into {m} microbatches")
    unit.eval()
    names = list(stage_tree)
    params = [stage_tree[k] for k in names]
    with mesh.activate():
        schedule = _Schedule(unit, names, mesh, m)
        tensors = [x, style_embeddings, *params]
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
            out = _Pipeline.apply(schedule, x, mask, style_embeddings, *params)
        else:
            with torch.no_grad():
                out = schedule.forward(x, mask, style_embeddings, params, keep=False)[0]
        return replicate_last_stage(out, PIPE_AXIS)

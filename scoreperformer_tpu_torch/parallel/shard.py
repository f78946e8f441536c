"""Which parameters a model axis and an expert axis split, and how.

The port's counterpart of JAX's `DEFAULT_PARTITION_RULES` and
`EXPERT_PARTITION_RULES` (scoreperformer_tpu/parallel/mesh.py:44-58), on the
port's parameter names (`models/attention.py`, `models/layers.py`,
`models/moe.py`). Megatron-style:
- `to_q` and the feed-forward's input projection split by columns (the
  rows of the torch weight), `to_out` and `proj_out` (`ff.3`) by rows (the
  torch weight's columns); one all-reduce closes each block;
- a GLU projection (`ff.0.proj`, one Linear chunked into value and gate)
  gives each rank its slice of both halves;
- `to_k`/`to_v` split by KV head, or stay whole on every rank when the KV
  heads are fewer than the model axis (the flagship's one KV head);
- MoE's `wi`, `wo`, `bi`, `bo` split over `expert` on their leading axis;
  the router stays whole.
A layer whose split does not divide stays whole, as JAX replicates a
parameter whose shape does not divide its mesh axis. So does a
feed-forward with `post_act_ln` (its norm would need the whole row). Where
this differs from JAX's layout (K/V kept whole, where JAX splits `to_k` by
columns; GLU halves split, where GSPMD splits the fused kernel), the values
are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from ..models.attention import Attention
from ..models.layers import FeedForward
from ..models.moe import MoEFeedForward
from .mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, ProcessMesh


@dataclass(frozen=True)
class Shard:
    """A parameter split over mesh `axis` on torch dim `dim`; `halves=2`
    splits each of the two halves along `dim` alike (a GLU projection)."""

    axis: str
    dim: int
    halves: int = 1

    def take(self, full: torch.Tensor, n: int, index: int) -> torch.Tensor:
        """Rank `index`'s block of the whole tensor."""
        parts = full.chunk(self.halves, self.dim)
        return torch.cat([p.chunk(n, self.dim)[index] for p in parts], self.dim)

    def join(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from the ranks' blocks, in rank order."""
        halves = [b.chunk(self.halves, self.dim) for b in blocks]
        return torch.cat([h[i] for i in range(self.halves) for h in halves], self.dim)


# (module type, parameter name in the module) -> its split
TENSOR_PARALLEL_RULES = {
    (Attention, "to_q.weight"): Shard(MODEL_AXIS, 0),  # by query head
    (Attention, "to_k.weight"): Shard(MODEL_AXIS, 0),  # by KV head, if there are enough
    (Attention, "to_v.weight"): Shard(MODEL_AXIS, 0),
    (Attention, "to_out.weight"): Shard(MODEL_AXIS, 1),
    (FeedForward, "ff.0.proj.weight"): Shard(MODEL_AXIS, 0, halves=2),  # GLU proj_in
    (FeedForward, "ff.0.proj.bias"): Shard(MODEL_AXIS, 0, halves=2),
    (FeedForward, "ff.0.0.weight"): Shard(MODEL_AXIS, 0),  # plain proj_in
    (FeedForward, "ff.0.0.bias"): Shard(MODEL_AXIS, 0),
    (FeedForward, "ff.3.weight"): Shard(MODEL_AXIS, 1),  # proj_out; its bias is added after the reduce
}
EXPERT_PARALLEL_RULES = {(MoEFeedForward, name): Shard(EXPERT_AXIS, 0) for name in ("wi", "wo", "bi", "bo")}


def _splits(module: nn.Module, mesh: ProcessMesh) -> Optional[str]:
    """The axis `module` is split over on `mesh`, or None."""
    m, e = mesh.size(MODEL_AXIS), mesh.size(EXPERT_AXIS)
    if isinstance(module, Attention) and m > 1 and module.heads % m == 0:
        return MODEL_AXIS
    if isinstance(module, FeedForward) and m > 1 and module.inner % m == 0 and not module.post_act_ln:
        return MODEL_AXIS
    if isinstance(module, MoEFeedForward) and e > 1 and module.num_experts % e == 0:
        return EXPERT_AXIS
    return None


def shard_model(model: nn.Module, mesh: ProcessMesh) -> Dict[str, Shard]:
    """Split `model`'s parameters in place for this rank of `mesh` (every
    rank holds the same whole model before, made from one seed). Returns
    {parameter name: Shard} of the split ones, under every name a
    parameter is registered by."""
    specs: Dict[str, Shard] = {}
    aliases: Dict[int, List[str]] = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        aliases.setdefault(id(p), []).append(name)
    for prefix, module in list(model.named_modules()):
        axis = _splits(module, mesh)
        if axis is None:
            continue
        n, index = mesh.size(axis), mesh.index(axis)
        rules = EXPERT_PARALLEL_RULES if axis == EXPERT_AXIS else TENSOR_PARALLEL_RULES
        kv_whole = isinstance(module, Attention) and module.kv_heads < n
        for (kind, pname), shard in rules.items():
            if not isinstance(module, kind) or (kv_whole and pname in ("to_k.weight", "to_v.weight")):
                continue
            owner_name, _, attr = pname.rpartition(".")
            try:
                owner = module.get_submodule(owner_name) if owner_name else module
            except AttributeError:  # the rule of the other kind of projection
                continue
            p = getattr(owner, attr, None)
            if p is None:
                continue
            for alias in aliases[id(p)]:
                specs[alias] = shard
            with torch.no_grad():
                setattr(owner, attr, nn.Parameter(shard.take(p.detach(), n, index).clone(),
                                                  requires_grad=p.requires_grad))
        if isinstance(module, Attention):
            module.shard_heads(n, index)
        elif isinstance(module, FeedForward):
            module.model_sharded = True
            module.ff[2].layout = (DATA_AXIS, None, MODEL_AXIS)
        else:
            e = module.num_experts // n
            module.expert_range = (index * e, (index + 1) * e)
            module.dropout.layout = (EXPERT_AXIS, DATA_AXIS)
    return specs


def shard_state_dict(state_dict: Dict[str, torch.Tensor], specs: Dict[str, Shard],
                     mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a whole (one-device) state dict."""
    return {k: specs[k].take(v, mesh.size(specs[k].axis), mesh.index(specs[k].axis)) if k in specs else v
            for k, v in state_dict.items()}


def gather_state_dict(state_dict: Dict[str, torch.Tensor], specs: Dict[str, Shard]) -> Dict[str, torch.Tensor]:
    """The whole tensors of this rank's state dict, joined over their axes
    (collective: every rank of the mesh calls it)."""
    from .collectives import all_gather_list

    return {k: specs[k].join(all_gather_list(v, specs[k].axis)) if k in specs else v
            for k, v in state_dict.items()}

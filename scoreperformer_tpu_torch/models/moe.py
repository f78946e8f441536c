"""Mixture-of-Experts feed-forward on one device.

Counterpart of scoreperformer_tpu/models/moe.py:36-157 (GShard/Switch dense
dispatch):
- the router (D, E) in fp32, softmax, the top-k of the probabilities with
  the lower expert first among equal ones, as `jax.lax.top_k` orders them,
  gates renormalised with a clamp at 1e-9;
- slot-major priority: every token's first choice is placed before any
  token's second choice, then sequence order; padded tokens are zeroed
  before the capacity cumsum, so they take no slot;
- a static capacity ceil(K * S * capacity_factor / E) for the S of this
  call; dispatch and combine are (B, S, E, C) one-hot tensors, and the
  experts three batched products over a real expert axis, as XLA computes
  them (no Pallas kernel in the JAX package);
- the Switch load-balance loss, the optional router z-loss and the share of
  dropped assignments.

On a mesh (`parallel/mesh.py`): over `expert`, a rank holds the slice
`expert_range` of `wi`, `wo`, `bi` and `bo` (`parallel/shard.py`), routes
its rows as above (the router stays whole), runs its experts' products on
their slice of the dispatch, and one reduce-from-group sums the ranks'
partial outputs; the gates and the products' input pass through
copy-to-group, so their gradients sum over the experts. Over `data`, the
aux loss and the drop rate are this rank's partials of the global batch's
(`parallel/collectives.py`): the token counts and the top-1 load are
summed over the data axis.

Where the JAX layer sows its aux loss and drop rate into flax collections,
this one returns them: `forward(x, mask, with_stats=True)` gives (y, aux,
drop), and the stack that holds it appends them to the caller's list
(`TransformerStack.forward(..., moe_stats=[])`). No module attribute
outlives a forward.

The parameters keep flax's names and layouts (`router` (D, E), `wi`
(E, D, F), `wo` (E, inner, D), `bi`, `bo`), which have no counterpart in the
reference's PyTorch modules.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_group, data_share, data_total, reduce_from_group
from ..parallel.mesh import DATA_AXIS, EXPERT_AXIS
from .dropout import Dropout


def top_k_lower_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, in
    descending order, the lower index first among equal values
    (`jax.lax.top_k`'s order; `torch.topk` promises none): k argmax passes,
    each of which returns the first maximal index."""
    values, indices = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        values.append(x.gather(-1, i))
        indices.append(i)
        x = x.scatter(-1, i, float("-inf"))
    return torch.cat(values, dim=-1), torch.cat(indices, dim=-1)


class MoEFeedForward(nn.Module):
    """Drop-in for `layers.FeedForward` with `num_experts` routed experts,
    each the dense layer's GLU/act MLP."""

    def __init__(self, dim: int, num_experts: int, mult: int = 4, top_k: int = 2,
                 capacity_factor: float = 1.25, glu: bool = False, swish: bool = False,
                 dropout: float = 0.0, no_bias: bool = True, router_aux_weight: float = 1e-2,
                 router_z_weight: float = 0.0):
        super().__init__()
        self.num_experts, self.top_k = num_experts, min(top_k, num_experts)
        self.capacity_factor, self.glu, self.swish = capacity_factor, glu, swish
        self.router_aux_weight, self.router_z_weight = router_aux_weight, router_z_weight
        inner = int(dim * mult)
        features = 2 * inner if glu else inner
        self.router = nn.Parameter(torch.randn(dim, num_experts) * 0.02)
        self.wi = nn.Parameter(torch.randn(num_experts, dim, features) * dim**-0.5)
        self.wo = nn.Parameter(torch.randn(num_experts, inner, dim) * inner**-0.5)
        self.bi = nn.Parameter(torch.zeros(num_experts, features)) if not no_bias else None
        self.bo = nn.Parameter(torch.zeros(num_experts, dim)) if not no_bias else None
        self.dropout = Dropout(dropout)
        self.dropout.layout = (None, DATA_AXIS)  # h is (E, B, C, F)
        self.expert_range: Optional[Tuple[int, int]] = None  # this rank's experts on an expert axis

    def capacity(self, seq_len: int) -> int:
        return max(1, int(math.ceil(self.top_k * seq_len * self.capacity_factor / self.num_experts)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, with_stats: bool = False):
        """y (x's shape and type); with `with_stats`, (y, aux, drop): the
        aux loss (load balance, plus the z-loss when its weight is set) and
        the share of routed (token, choice) assignments that overflowed."""
        B, S, D = x.shape
        E, K = self.num_experts, self.top_k
        C = self.capacity(S)
        valid = torch.ones(B, S, device=x.device) if mask is None else mask.float()

        # routing, in fp32
        logits = x.float() @ self.router.float()  # (B, S, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = top_k_lower_first(probs, K)  # (B, S, K)
        gates = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        x_in = x
        if self.expert_range is not None:  # each rank's experts give part of these gradients
            gates, x_in = copy_to_group(gates, EXPERT_AXIS), copy_to_group(x, EXPERT_AXIS)

        # slot-major: flatten (K, S), so that all first choices come before
        # any second choice; pads are zeroed before the cumsum
        onehot = F.one_hot(gate_idx, E).float() * valid[:, :, None, None]  # (B, S, K, E)
        oh_flat = onehot.transpose(1, 2).reshape(B, K * S, E)
        position = torch.cumsum(oh_flat, dim=1) - oh_flat  # exclusive, per expert
        keep = (position < C).float() * oh_flat  # (B, KS, E)
        # jnp promotes the one-hot in x's type with the fp32 `keep`
        dt = torch.promote_types(x.dtype, torch.float32)
        slot = (position[..., None] == torch.arange(C, device=x.device)).to(dt) * keep[..., None]
        slot = slot.reshape(B, K, S, E, C)
        dispatch = slot.sum(dim=1)  # (B, S, E, C), 0 or 1
        combine = (slot * gates.to(dt).transpose(1, 2)[..., None, None]).sum(dim=1)

        if self.expert_range is not None:  # this rank's experts
            e0, e1 = self.expert_range
            dispatch, combine = dispatch[:, :, e0:e1], combine[:, :, e0:e1]

        # the experts: three batched products over the expert axis
        dt = torch.promote_types(dt, self.wi.dtype)
        expert_in = torch.einsum("bsd,bsec->ebcd", x_in.to(dt), dispatch.to(dt))  # (E, B, C, D)
        h = torch.einsum("ebcd,edf->ebcf", expert_in, self.wi.to(dt))
        if self.bi is not None:
            h = h + self.bi[:, None, None, :]
        act = F.silu if self.swish else (lambda t: F.gelu(t, approximate="tanh"))  # jax.nn.gelu's default
        if self.glu:
            h, gate = h.chunk(2, dim=-1)
            h = h * act(gate)
        else:
            h = act(h)
        h = self.dropout(h)
        y_e = torch.einsum("ebcf,efd->ebcd", h, self.wo.to(h.dtype))
        if self.bo is not None:
            y_e = y_e + self.bo[:, None, None, :]
        y = torch.einsum("ebcd,bsec->bsd", y_e, combine.to(y_e.dtype)).to(x.dtype)
        if self.expert_range is not None:
            y = reduce_from_group(y, EXPERT_AXIS)
        if not with_stats:
            return y

        # the aux loss over real tokens only (onehot is already masked); the
        # counts and the top-1 load are the global batch's
        n_valid = data_total(valid.sum()).clamp_min(1.0)
        importance = (probs * valid[..., None]).sum(dim=(0, 1)) / n_valid
        load = data_total(onehot[:, :, 0, :].sum(dim=(0, 1))) / n_valid  # the top-1 share
        aux = E * torch.sum(importance * load) * self.router_aux_weight
        if self.router_z_weight > 0.0:
            z = torch.logsumexp(logits, dim=-1)
            aux = aux + self.router_z_weight * torch.sum(z**2 * valid) / n_valid
        drop = data_share(1.0 - data_total(keep.sum()) / data_total(oh_flat.sum()).clamp_min(1.0))
        return y, aux, drop


def moe_summary(stats: List[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """{"moe_aux": the layers' aux losses summed, "moe_drop": their drop
    rates' mean} in fp32, as the JAX trainer reduces the sown values; both
    None for a model without MoE layers."""
    if not stats:
        return {"moe_aux": None, "moe_drop": None}
    return {"moe_aux": sum(aux.float() for aux, _ in stats),
            "moe_drop": sum(drop.float() for _, drop in stats) / len(stats)}

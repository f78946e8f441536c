"""Core transformer layers (counterpart of scoreperformer_tpu/models/layers.py).

Parameter names follow the reference PyTorch modules, the names that
scoreperformer_tpu/training/torch_convert.py maps, so a reference state dict
loads without renaming (see convert.py).

Types follow flax's promotion (`bf16_compute` runs the modules on bf16
parameters): `Linear` computes in the promoted type of its input and weight,
as flax's Dense does (a bf16 weight on an fp32 input computes in fp32);
`LayerNorm` takes its statistics and arithmetic in fp32 and writes the
promoted type of its input and parameters, as flax's LayerNorm does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_group, gather_seq_to_group, reduce_from_group, reduce_scatter_seq
from ..parallel.mesh import MODEL_AXIS
from .dropout import Dropout


def promoted(*xs: torch.Tensor):
    """`xs` cast to their promoted type, as jnp promotes the operands of an
    op (a bf16 array with an fp32 one computes in fp32)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.linear in the promoted type of its input and weight (flax's Dense)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w, b = x.to(dt), w.to(dt), None if b is None else b.to(dt)
    return F.linear(x, w, b)


class Linear(nn.Linear):
    """nn.Linear in the promoted type of its input and weight (flax's Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


def _group_params(sequence_parallel: bool, *ps: Optional[torch.Tensor]):
    """The parameters of a norm that runs on a rank's slice of the sequence
    (their gradient summed over the model axis), or as they are."""
    if not sequence_parallel:
        return ps
    return tuple(None if p is None else copy_to_group(p, MODEL_AXIS) for p in ps)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm computed in fp32, written in the promoted type of its
    input and parameters (flax's LayerNorm). With `sequence_parallel` it
    runs on this rank's slice of the sequence and its parameters' gradient
    is summed over the model axis."""

    def forward(self, x: torch.Tensor, sequence_parallel: bool = False) -> torch.Tensor:
        w, b = _group_params(sequence_parallel, self.weight, self.bias)
        dt = torch.promote_types(x.dtype, w.dtype)
        out = F.layer_norm(x.float(), self.normalized_shape, w.float(), b.float(), self.eps)
        return out.to(dt)


class AdaptiveLayerNorm(nn.Module):
    """LayerNorm without affine + Linear(cond -> 2*dim) giving per-position
    gamma/beta. `linear` is the JAX package's `to_gamma_beta`. With
    `sequence_parallel` as `LayerNorm`'s (the condition's rows are the
    slice's)."""

    def __init__(self, dim: int, condition_dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.linear = Linear(condition_dim, 2 * dim)
        with torch.no_grad():  # gamma = 1, beta = 0 at start
            self.linear.bias.copy_(torch.cat([torch.ones(dim), torch.zeros(dim)]))

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None,
                sequence_parallel: bool = False) -> torch.Tensor:
        normed = F.layer_norm(x, (self.dim,), eps=self.eps)
        if condition is None:
            return normed
        if condition.ndim == 2:
            condition = condition[:, None]
        gamma, beta = linear(condition, *_group_params(sequence_parallel, self.linear.weight,
                                                       self.linear.bias)).chunk(2, dim=-1)
        return gamma * normed + beta


class _GLUProjIn(nn.Module):
    """One (dim -> 2*inner) projection split into value and gate halves."""

    def __init__(self, dim: int, inner: int, act: nn.Module):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * self.act(gate)


class FeedForward(nn.Module):
    """GELU/SiLU MLP with an optional GLU gate. `ff` keeps the reference's
    layout: [proj_in, post-activation norm, dropout, proj_out]; the dropout
    applies in `module.train()` mode only.

    On a model axis (`parallel/shard.py` sets `model_sharded`), proj_in holds
    this rank's columns (of both GLU halves) and proj_out the matching rows:
    the input passes through copy-to-group, and one reduce-from-group sums
    the partial outputs before proj_out's bias. With `sequence_parallel`
    the input is this rank's slice of the sequence: an all-gather takes the
    place of copy-to-group and a reduce-scatter that of reduce-from-group."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False, swish: bool = False,
                 post_act_ln: bool = False, dropout: float = 0.0, no_bias: bool = True):
        super().__init__()
        inner = int(dim * mult)
        # jax.nn.gelu defaults to the tanh approximation
        act = nn.SiLU() if swish else nn.GELU(approximate="tanh")
        if glu:
            proj_in = _GLUProjIn(dim, inner, act)
        else:
            proj_in = nn.Sequential(Linear(dim, inner, bias=not no_bias), act)
        self.ff = nn.Sequential(
            proj_in,
            LayerNorm(inner, eps=1e-5) if post_act_ln else nn.Identity(),
            Dropout(dropout),
            Linear(inner, dim, bias=not no_bias),
        )
        self.inner, self.post_act_ln = inner, post_act_ln
        self.model_sharded = False

    def forward(self, x: torch.Tensor, sequence_parallel: bool = False) -> torch.Tensor:
        if not self.model_sharded:
            return self.ff(x)
        proj_in, norm, drop, proj_out = self.ff
        gather, reduce = (gather_seq_to_group, reduce_scatter_seq) if sequence_parallel else \
            (copy_to_group, reduce_from_group)
        h = drop(norm(proj_in(gather(x, MODEL_AXIS))))
        y = reduce(linear(h, proj_out.weight), MODEL_AXIS)
        if proj_out.bias is None:
            return y
        (bias,) = _group_params(sequence_parallel, proj_out.bias)
        return y + bias.to(y.dtype)


class AbsolutePositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.dim = dim
        self.emb = nn.Embedding(max_seq_len, dim)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.emb(pos) * (self.dim**-0.5)


def fixed_positional_embedding(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """Sinusoidal embedding (..., dim) of positions `pos`: [sin | cos] of
    pos / 10000^(2i/dim), in fp32 (embeddings.py:248-265)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, device=pos.device) / dim))
    sinusoid = pos[..., None] * inv_freq
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)


def alibi_slopes(heads: int) -> torch.Tensor:
    """ALiBi head slopes, including head counts that are not a power of 2."""

    def slopes_power_of_2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(heads).is_integer():
        slopes = slopes_power_of_2(heads)
    else:
        closest = 2 ** math.floor(math.log2(heads))
        slopes = slopes_power_of_2(closest) + slopes_power_of_2(2 * closest)[0::2][: heads - closest]
    return torch.tensor(slopes, dtype=torch.float32)


class ALiBiPositionalBias(nn.Module):
    """ALiBi relative position bias, optionally asymmetric and/or learned;
    produces an (total_heads, i, j) additive bias, zero for the heads past
    `heads`. With `head_range` (a model axis, `parallel/shard.py`), the
    bias and padded slopes are those heads' only, and the learned slopes'
    gradient is summed over the model axis into the full vector."""

    def __init__(self, heads: int, total_heads: int, symmetric: bool = True, learned: bool = False):
        super().__init__()
        self.total_heads, self.symmetric, self.learned = total_heads, symmetric, learned
        slopes = alibi_slopes(heads)[:, None, None]
        if not symmetric:
            slopes = torch.stack([slopes, torch.roll(slopes, -1, dims=0)])
        if learned:
            self.learned_logslopes = nn.Parameter(torch.log(slopes))
        else:
            self.register_buffer("slopes", slopes, persistent=False)
        self.head_range: Optional[tuple] = None

    def get_slopes(self) -> torch.Tensor:
        if not self.learned:
            return self.slopes
        slopes = torch.exp(self.learned_logslopes)
        # each model rank's heads give part of the slopes' gradient
        return slopes if self.head_range is None else copy_to_group(slopes, MODEL_AXIS)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.head_range is None else x[self.head_range[0]:self.head_range[1]]

    def padded_slopes(self) -> torch.Tensor:
        """Symmetric slopes as a flat (total_heads,) vector, zero-padded."""
        slopes = self.get_slopes().reshape(-1)
        return self._heads(F.pad(slopes, (0, self.total_heads - slopes.shape[0])))

    def forward(self, pos_i: torch.Tensor, pos_j: torch.Tensor) -> torch.Tensor:
        """Bias of query positions `pos_i` (i,) against key positions `pos_j` (j,)."""
        diff = (pos_j[None, None, :] - pos_i[None, :, None]).float()
        bias = -diff.abs()
        slopes = self.get_slopes()
        if self.symmetric:
            slopes = F.pad(slopes, (0, 0, 0, 0, 0, self.total_heads - slopes.shape[0]))
            return self._heads(slopes * bias)
        slopes = F.pad(slopes, (0, 0, 0, 0, 0, self.total_heads - slopes.shape[1]))
        # position-aware split; the diagonal is 0 either way
        lower = torch.where(diff <= 0, bias, 0.0)
        upper = torch.where(diff > 0, bias, 0.0)
        return self._heads(slopes[0] * lower + slopes[1] * upper)

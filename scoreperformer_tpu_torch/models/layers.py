"""Core transformer layers (counterpart of scoreperformer_tpu/models/layers.py).

Parameter names follow the reference PyTorch modules, the names that
scoreperformer_tpu/training/torch_convert.py maps, so a reference state dict
loads without renaming (see convert.py).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout


class AdaptiveLayerNorm(nn.Module):
    """LayerNorm without affine + Linear(cond -> 2*dim) giving per-position
    gamma/beta. `linear` is the JAX package's `to_gamma_beta`."""

    def __init__(self, dim: int, condition_dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.linear = nn.Linear(condition_dim, 2 * dim)
        with torch.no_grad():  # gamma = 1, beta = 0 at start
            self.linear.bias.copy_(torch.cat([torch.ones(dim), torch.zeros(dim)]))

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        normed = F.layer_norm(x, (self.dim,), eps=self.eps)
        if condition is None:
            return normed
        if condition.ndim == 2:
            condition = condition[:, None]
        gamma, beta = self.linear(condition).chunk(2, dim=-1)
        return gamma * normed + beta


class _GLUProjIn(nn.Module):
    """One (dim -> 2*inner) projection split into value and gate halves."""

    def __init__(self, dim: int, inner: int, act: nn.Module):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * self.act(gate)


class FeedForward(nn.Module):
    """GELU/SiLU MLP with an optional GLU gate. `ff` keeps the reference's
    layout: [proj_in, post-activation norm, dropout, proj_out]; the dropout
    applies in `module.train()` mode only."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False, swish: bool = False,
                 post_act_ln: bool = False, dropout: float = 0.0, no_bias: bool = True):
        super().__init__()
        inner = int(dim * mult)
        # jax.nn.gelu defaults to the tanh approximation
        act = nn.SiLU() if swish else nn.GELU(approximate="tanh")
        if glu:
            proj_in = _GLUProjIn(dim, inner, act)
        else:
            proj_in = nn.Sequential(nn.Linear(dim, inner, bias=not no_bias), act)
        self.ff = nn.Sequential(
            proj_in,
            nn.LayerNorm(inner, eps=1e-5) if post_act_ln else nn.Identity(),
            Dropout(dropout),
            nn.Linear(inner, dim, bias=not no_bias),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


class AbsolutePositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.dim = dim
        self.emb = nn.Embedding(max_seq_len, dim)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.emb(pos) * (self.dim**-0.5)


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
    `heads`."""

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

    def get_slopes(self) -> torch.Tensor:
        return torch.exp(self.learned_logslopes) if self.learned else self.slopes

    def padded_slopes(self) -> torch.Tensor:
        """Symmetric slopes as a flat (total_heads,) vector, zero-padded."""
        slopes = self.get_slopes().reshape(-1)
        return F.pad(slopes, (0, self.total_heads - slopes.shape[0]))

    def forward(self, pos_i: torch.Tensor, pos_j: torch.Tensor) -> torch.Tensor:
        """Bias of query positions `pos_i` (i,) against key positions `pos_j` (j,)."""
        diff = (pos_j[None, None, :] - pos_i[None, :, None]).float()
        bias = -diff.abs()
        slopes = self.get_slopes()
        if self.symmetric:
            slopes = F.pad(slopes, (0, 0, 0, 0, 0, self.total_heads - slopes.shape[0]))
            return slopes * bias
        slopes = F.pad(slopes, (0, 0, 0, 0, 0, self.total_heads - slopes.shape[1]))
        # position-aware split; the diagonal is 0 either way
        lower = torch.where(diff <= 0, bias, 0.0)
        upper = torch.where(diff > 0, bias, 0.0)
        return slopes[0] * lower + slopes[1] * upper

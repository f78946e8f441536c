"""Hierarchical MMD-VAE style encoder.

Counterpart of scoreperformer_tpu/models/mmd.py: a TupleTransformer whose
outputs are aggregated at global/bar/beat/onset levels into small latents
(`vae_head.<mode>`), each level's embedding fed to the next. Segment means are
one-hot products over a STATIC `max_segments` bound; ids past it are clipped
into the last segment, as in the JAX package. In `module.train()` mode the
latents are dropped per segment (inclusively down the hierarchy); with
`compute_loss` each level's latents are held to N(0, I) by an MMD loss whose
prior samples (and subsample uniforms) come from an `MMDSampler`, so a test
can hand in the very samples JAX drew. `embeddings_to_latents` and
`latents_to_embeddings` map note embeddings to per-level latents and back,
for the streaming generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import data_share, gather_rows, partial_ratio
from .dropout import uniform
from .embeddings import StreamEmbedding
from .layers import Linear
from .tuple_transformer import TupleTransformerConfig, TupleTransformerModule


class AggregateModes:
    SAME = "same"
    MEAN = "mean"
    BEAT_MEAN = "beat_mean"
    BAR_MEAN = "bar_mean"
    ONSET_MEAN = "onset_mean"
    ISOLATED_BAR_MEAN = "isolated_bar_mean"


SEGMENT_MODES = (
    AggregateModes.ISOLATED_BAR_MEAN,
    AggregateModes.BAR_MEAN,
    AggregateModes.BEAT_MEAN,
    AggregateModes.ONSET_MEAN,
)


@dataclass
class MMDTupleTransformerOutput:
    hidden_state: torch.Tensor
    latents: Optional[Union[torch.Tensor, List[torch.Tensor]]] = None
    embeddings: Optional[torch.Tensor] = None
    full_embeddings: Optional[torch.Tensor] = None
    dropout_mask: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None
    losses: Optional[Dict[str, torch.Tensor]] = None


@dataclass
class MMDTupleTransformerConfig(TupleTransformerConfig):
    latent_dim: Union[int, List[int]] = 64
    aggregate_mode: Union[str, List[str]] = AggregateModes.MEAN
    hierarchical: bool = False
    hierarchical_with_context: bool = True
    latent_dropout: Union[float, List[float]] = 0.0
    inclusive_latent_dropout: bool = True
    deadpan_zero_latent: bool = False
    loss_weight: float = 1.0
    max_segments: int = 260
    mmd_num_samples: int = 256
    mmd_max_num_latents: int = 4096

    def normalized_modes(self):
        """(single, modes, latent_dims, dropouts) with the single-head case flagged."""
        latent_dim, mode, dropout = self.latent_dim, self.aggregate_mode, self.latent_dropout
        single = isinstance(latent_dim, int) and isinstance(mode, str)
        if isinstance(latent_dim, int) and not isinstance(mode, str):
            latent_dim = [latent_dim] * len(mode)
        if isinstance(mode, str) and not isinstance(latent_dim, int):
            mode = [mode] * len(latent_dim)
        if single:
            return True, [mode], [latent_dim], [dropout if isinstance(dropout, float) else dropout[0]]
        if isinstance(dropout, float):
            dropout = [dropout] * len(latent_dim)
        return False, list(mode), list(latent_dim), list(dropout)

    @property
    def embedding_dim(self) -> int:
        if isinstance(self.latent_dim, int):
            if isinstance(self.aggregate_mode, str):
                return self.latent_dim
            return self.latent_dim * len(self.aggregate_mode)
        return int(sum(self.latent_dim))


def gaussian_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """exp(-mean((x_i - y_j)^2) / d) for every pair (mmd_transformer.py:518-523).
    The squared distance is expanded into |x|^2 + |y|^2 - 2 x.y, so no
    (n, m, d) tensor is formed: the subsample's kernel is (4096, 4096)."""
    d = x.shape[-1]
    d2 = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :] - 2.0 * (x @ y.T)
    return torch.exp(-d2.clamp_min(0.0) / (d * d))


def mmd_loss(
    latents: torch.Tensor,
    mask: Optional[torch.Tensor],
    z: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    max_num_latents: int = 4096,
) -> torch.Tensor:
    """MMD(latents, N(0, I)) with mask weights (mmd_transformer.py:505-534).
    `z` (num_samples, d) are the prior samples. With more candidate latents
    than `max_num_latents`, a fixed-size subsample of the valid ones is drawn
    with replacement by the inverse CDF at the uniforms `u` (max_num_latents,);
    otherwise the kernel means are exact, mask-weighted."""
    d = latents.shape[-1]
    flat = latents.reshape(-1, d)
    z = z.to(flat.dtype)  # the samples in the latents' dtype, as JAX draws them
    w = torch.ones(flat.shape[0], dtype=flat.dtype, device=flat.device) if mask is None \
        else mask.reshape(-1).to(flat.dtype)
    if flat.shape[0] > max_num_latents:
        if u is None or u.shape != (max_num_latents,):
            raise ValueError(f"mmd_loss: {flat.shape[0]} latents need {max_num_latents} subsample uniforms")
        cdf = torch.cumsum((w > 0).to(flat.dtype), 0)
        idx = torch.searchsorted(cdf, u.to(flat.dtype) * cdf[-1], right=True).clamp_max(flat.shape[0] - 1)
        y = flat[idx]
        wy = torch.ones(max_num_latents, dtype=flat.dtype, device=flat.device)
    else:
        y, wy = flat, w
    wy_sum = wy.sum().clamp_min(1.0)
    x_kernel = gaussian_kernel(z, z).mean()
    y_kernel = (wy[:, None] * wy[None, :] * gaussian_kernel(y, y)).sum() / (wy_sum * wy_sum)
    xy_kernel = (gaussian_kernel(z, y) * wy[None, :]).sum() / (z.shape[0] * wy_sum)
    return x_kernel + y_kernel - 2 * xy_kernel


# (latent dim, number of candidate latents) -> (prior samples z, subsample uniforms u or None)
MMDSampler = Callable[[int, int], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def mmd_sampler(generator: Optional[torch.Generator], num_samples: int, max_num_latents: int,
                device) -> MMDSampler:
    """Draws z ~ N(0, I) and, where the subsample needs them, uniforms u from
    `generator`, as the JAX package draws both from its "mmd" key."""

    def sample(d: int, n_latents: int):
        z = torch.randn(num_samples, d, generator=generator, device=device)
        u = torch.rand(max_num_latents, generator=generator, device=device) if n_latents > max_num_latents else None
        return z, u

    return sample


class MMDVAE(nn.Module):
    def __init__(self, input_dim: int, latent_dim: int):
        super().__init__()
        self.linear = Linear(input_dim, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class MMDTupleTransformer(TupleTransformerModule):
    """The reference's MMD transformer subclasses its TupleTransformer, so the
    transformer's parameters sit at the top level beside `vae_head`."""

    pad_token_id = 0
    mask_token_id = 1
    eos_token_id = 3

    def __init__(self, num_tokens, config: MMDTupleTransformerConfig,
                 shared_streams: Optional[dict[str, StreamEmbedding]] = None):
        super().__init__(num_tokens, config, shared_streams=shared_streams)
        self.single, self.modes, self.latent_dims, self.dropouts = config.normalized_modes()
        heads = {}
        input_dim = config.dim
        for mode, latent_dim in zip(self.modes, self.latent_dims):
            heads[mode] = MMDVAE(input_dim, latent_dim)
            if config.hierarchical:
                input_dim = input_dim + latent_dim if config.hierarchical_with_context else latent_dim
        self.vae_head = nn.ModuleDict(heads)

    @property
    def embedding_dim(self) -> int:
        return self.config.embedding_dim

    @staticmethod
    def _segments(mode, bars, beats, onsets):
        if mode in (AggregateModes.BAR_MEAN, AggregateModes.ISOLATED_BAR_MEAN):
            return bars
        if mode == AggregateModes.BEAT_MEAN:
            return beats
        if mode == AggregateModes.ONSET_MEAN:
            return onsets
        return None

    def _aggregate(self, out: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
        """One-hot product segment mean over `max_segments` slots."""
        S = self.config.max_segments
        one_hot = F.one_hot(segments.long().clamp(0, S - 1), S).to(out.dtype)  # b t S
        counts = one_hot.sum(dim=1).clamp_min(1.0)[..., None]  # b S 1
        return torch.einsum("btd,bts->bsd", out, one_hot) / counts

    def _distribute(self, latents: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
        """Broadcast per-segment latents back to the notes."""
        S = self.config.max_segments
        idx = segments.long().clamp(0, S - 1)[..., None].expand(-1, -1, latents.shape[-1])
        return torch.gather(latents, 1, idx)

    def _forward_latents(self, out, mask3, mode, head, latent_dropout, segments=None, generator=None,
                         latents=None):
        """(latents, latents_mask, embeddings, drop_mask) of one level
        (mmd_transformer.py:304-386); the drop mask is (b, t, 1). Given
        `latents`, the level takes them in place of the encoded ones: every
        latent counts at the mean level, a nonzero one at the others."""
        b, t = out.shape[:2]
        if latents is not None:
            if mode == AggregateModes.MEAN:
                latents_mask = torch.ones(b, latents.shape[1], dtype=torch.bool, device=out.device)
            else:
                latents_mask = (latents != 0.0).any(dim=-1)
        else:
            if mode == AggregateModes.MEAN:
                agg = out.sum(dim=1, keepdim=True) / mask3.sum(dim=1, keepdim=True)
                latents_mask = torch.ones(b, 1, dtype=torch.bool, device=out.device)
            elif mode in SEGMENT_MODES:
                agg = self._aggregate(out, segments)
                latents_mask = (agg != 0.0).any(dim=-1)
            else:
                agg = out
                latents_mask = mask3[..., 0]
            latents = head(agg) * latents_mask[..., None]
        if mode != AggregateModes.MEAN and self.training and latent_dropout > 0.0:
            drop = uniform(latents_mask.shape, generator, out.device) < latent_dropout
            drop_mask = (drop & latents_mask)[..., None]
        else:
            drop_mask = torch.zeros_like(latents_mask[..., None])
        if mode == AggregateModes.MEAN:
            embeddings = latents.expand(b, t, latents.shape[-1])
            drop_mask = drop_mask.expand(b, t, 1)
        elif mode in SEGMENT_MODES:
            embeddings = self._distribute(latents, segments)
            drop_mask = self._distribute(drop_mask, segments)
        else:
            embeddings = latents
        return latents, latents_mask, embeddings * mask3, drop_mask

    def forward(self, x, mask=None, x_extra=None, bars=None, beats=None, onsets=None,
                deadpan_mask=None, compute_loss: bool = False,
                latent_generator: Optional[torch.Generator] = None,
                sampler: Optional[MMDSampler] = None, moe_stats: Optional[list] = None,
                latents=None, mask_bars: bool = False) -> MMDTupleTransformerOutput:
        """With `compute_loss`, `sampler` gives each level's MMD samples (by
        default drawn from torch's global generator); latent dropout in
        `module.train()` mode draws from `latent_generator`; MoE layers append
        their (aux loss, drop rate) to `moe_stats`. `latents` (one tensor for
        a single level, else one a level) replace the encoded latents;
        `mask_bars` hides the bar ids from the transformer, as the
        isolated-bar level always does."""
        cfg = self.config
        if cfg.deadpan_zero_latent and compute_loss and deadpan_mask is None:
            raise ValueError("deadpan_zero_latent needs deadpan_mask")
        x_input, attn_mask = x, None
        if self.modes[0] == AggregateModes.ISOLATED_BAR_MEAN or mask_bars:
            bar_col = x[..., 0]
            x_input = x.clone()
            x_input[..., 0] = torch.where(bar_col > self.eos_token_id, self.mask_token_id, bar_col)
        if self.modes[0] == AggregateModes.ISOLATED_BAR_MEAN:
            # bar ids are hidden, and attention is block-diagonal per non-pad bar
            valid = bars > self.pad_token_id
            attn_mask = (bars[:, :, None] == bars[:, None, :]) & valid[:, :, None] & valid[:, None, :]
            attn_mask = attn_mask[:, None]

        hidden_state = super().forward(x_input, mask=mask, x_extra=x_extra, attn_mask=attn_mask,
                                       moe_stats=moe_stats)
        out = hidden_state
        if mask is None:
            mask3 = torch.ones_like(out[..., :1], dtype=torch.bool)
        else:
            mask3 = mask[..., None]
            out = out * mask3

        if compute_loss and sampler is None:
            sampler = mmd_sampler(None, cfg.mmd_num_samples, cfg.mmd_max_num_latents, out.device)

        losses: Dict[str, torch.Tensor] = {}
        all_latents, all_embeddings, drop_masks = [], [], []
        hidden = out
        prior_drop_mask = None
        for i, (mode, head, latent_dropout) in enumerate(zip(self.modes, self.vae_head.values(), self.dropouts)):
            latents_i, latents_mask_i, embeddings_i, drop_mask_i = self._forward_latents(
                hidden, mask3, mode, head, latent_dropout,
                segments=self._segments(mode, bars, beats, onsets), generator=latent_generator,
                latents=None if latents is None else latents if self.single else latents[i],
            )
            if self.training and cfg.inclusive_latent_dropout and not self.single:
                # lower levels drop wherever a parent level dropped
                if prior_drop_mask is not None:
                    drop_mask_i = prior_drop_mask | drop_mask_i
                prior_drop_mask = drop_mask_i
            all_latents.append(latents_i)
            all_embeddings.append(embeddings_i)
            drop_masks.append(drop_mask_i.expand(embeddings_i.shape))
            if cfg.hierarchical and not self.single:
                hidden = torch.cat([hidden, embeddings_i], dim=-1) if cfg.hierarchical_with_context else embeddings_i
            if compute_loss:
                # on a data axis, every rank takes the MMD of the gathered
                # latents (the global batch's pairs) and keeps its share
                d = latents_i.shape[-1]
                all_latents_i = gather_rows(latents_i)
                z, u = sampler(d, all_latents_i.numel() // d)
                losses[f"MMD/{mode}"] = data_share(cfg.loss_weight * mmd_loss(
                    all_latents_i, gather_rows(latents_mask_i.to(latents_i.dtype)), z, u, max_num_latents=cfg.mmd_max_num_latents))
                if cfg.deadpan_zero_latent:
                    dp_w = (deadpan_mask[:, None] & latents_mask_i).to(latents_i.dtype)
                    losses[f"MMD/{mode}/deadpan"] = partial_ratio(
                        ((latents_i**2) * dp_w[..., None]).sum(), dp_w.sum() * d, min_den=1.0)

        embeddings = all_embeddings[0] if self.single else torch.cat(all_embeddings, dim=-1)
        embeddings = embeddings * mask3
        full_embeddings, drop_mask = embeddings, None
        if self.training:
            drop_mask = (drop_masks[0] if self.single else torch.cat(drop_masks, dim=-1)) & mask3
            if deadpan_mask is not None:
                drop_mask = drop_mask & ~deadpan_mask[:, None, None]
            embeddings = embeddings * ~drop_mask
        loss = None
        if compute_loss:
            loss = sum(losses.values())
            losses["MMD"] = loss
        return MMDTupleTransformerOutput(
            hidden_state=hidden_state,
            latents=all_latents[0] if self.single else all_latents,
            embeddings=embeddings,
            full_embeddings=full_embeddings,
            dropout_mask=drop_mask,
            loss=loss,
            losses=losses if compute_loss else None,
        )

    # ---- inference helpers (mmd.py:429-469 of the JAX package) ----

    def embeddings_to_latents(self, embeddings, mask=None, bars=None, beats=None, onsets=None):
        """Per-level latents of (b, t, embedding_dim) note embeddings: the
        mean level pooled over the notes (over `mask`'s when given), the
        segment levels averaged per bar, beat or onset. One tensor for a
        single level, else a list by level."""
        if self.single:
            mode = self.modes[0]
            return self._emb_to_latents(embeddings, mode, mask, self._segments(mode, bars, beats, onsets))
        parts, offset = [], 0
        for mode, dim in zip(self.modes, self.latent_dims):
            segments = self._segments(mode, bars, beats, onsets)
            parts.append(self._emb_to_latents(embeddings[..., offset : offset + dim], mode, mask, segments))
            offset += dim
        return parts

    def _emb_to_latents(self, embeddings, mode, mask=None, segments=None):
        if mode == AggregateModes.MEAN:
            if mask is None:
                latents = embeddings.mean(dim=1)
            else:
                latents = embeddings.sum(dim=1) / mask[..., None].sum(dim=1)
            return latents[:, None]
        if mode in SEGMENT_MODES:
            return self._aggregate(embeddings, segments)
        return embeddings

    def latents_to_embeddings(self, latents, seq_len, bars=None, beats=None, onsets=None):
        """(b, seq_len, embedding_dim) note embeddings of per-level latents,
        the inverse of `embeddings_to_latents` on the segments that hold
        notes."""
        if self.single:
            mode = self.modes[0]
            return self._latents_to_emb(latents, seq_len, mode, self._segments(mode, bars, beats, onsets))
        parts = [
            self._latents_to_emb(latents[i], seq_len, mode, self._segments(mode, bars, beats, onsets))
            for i, mode in enumerate(self.modes)
        ]
        return torch.cat(parts, dim=-1)

    def _latents_to_emb(self, latents, seq_len, mode, segments=None):
        if mode == AggregateModes.MEAN:
            return latents.expand(latents.shape[0], seq_len, latents.shape[-1])
        if mode in SEGMENT_MODES:
            return self._distribute(latents, segments)
        return latents

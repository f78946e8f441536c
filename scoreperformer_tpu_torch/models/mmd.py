"""Hierarchical MMD-VAE style encoder, inference path.

Counterpart of scoreperformer_tpu/models/mmd.py: a TupleTransformer whose
outputs are aggregated at global/bar/beat/onset levels into small latents
(`vae_head.<mode>`), each level's embedding fed to the next. Segment means are
one-hot products over a STATIC `max_segments` bound; ids past it are clipped
into the last segment, as in the JAX package. The MMD loss and latent dropout
belong to training and are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .embeddings import StreamEmbedding
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
        """(single, modes, latent_dims) with the single-head case flagged."""
        latent_dim, mode = self.latent_dim, self.aggregate_mode
        single = isinstance(latent_dim, int) and isinstance(mode, str)
        if isinstance(latent_dim, int) and not isinstance(mode, str):
            latent_dim = [latent_dim] * len(mode)
        if isinstance(mode, str) and not isinstance(latent_dim, int):
            mode = [mode] * len(latent_dim)
        if single:
            return True, [mode], [latent_dim]
        return False, list(mode), list(latent_dim)

    @property
    def embedding_dim(self) -> int:
        if isinstance(self.latent_dim, int):
            if isinstance(self.aggregate_mode, str):
                return self.latent_dim
            return self.latent_dim * len(self.aggregate_mode)
        return int(sum(self.latent_dim))


class MMDVAE(nn.Module):
    def __init__(self, input_dim: int, latent_dim: int):
        super().__init__()
        self.linear = nn.Linear(input_dim, latent_dim)

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
        self.single, self.modes, self.latent_dims = config.normalized_modes()
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

    def _forward_latents(self, out, mask3, mode, head, segments=None):
        b, t = out.shape[:2]
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
        if mode == AggregateModes.MEAN:
            embeddings = latents.expand(b, t, latents.shape[-1])
        elif mode in SEGMENT_MODES:
            embeddings = self._distribute(latents, segments)
        else:
            embeddings = latents
        return latents, embeddings * mask3

    def forward(self, x, mask=None, x_extra=None, bars=None, beats=None, onsets=None) -> MMDTupleTransformerOutput:
        x_input, attn_mask = x, None
        if self.modes[0] == AggregateModes.ISOLATED_BAR_MEAN:
            # bar ids are hidden, and attention is block-diagonal per non-pad bar
            bar_col = x[..., 0]
            x_input = x.clone()
            x_input[..., 0] = torch.where(bar_col > self.eos_token_id, self.mask_token_id, bar_col)
            valid = bars > self.pad_token_id
            attn_mask = (bars[:, :, None] == bars[:, None, :]) & valid[:, :, None] & valid[:, None, :]
            attn_mask = attn_mask[:, None]

        hidden_state = super().forward(x_input, mask=mask, x_extra=x_extra, attn_mask=attn_mask)
        out = hidden_state
        if mask is None:
            mask3 = torch.ones_like(out[..., :1], dtype=torch.bool)
        else:
            mask3 = mask[..., None]
            out = out * mask3

        all_latents, all_embeddings = [], []
        hidden = out
        for mode, head in zip(self.modes, self.vae_head.values()):
            latents_i, embeddings_i = self._forward_latents(
                hidden, mask3, mode, head, segments=self._segments(mode, bars, beats, onsets)
            )
            all_latents.append(latents_i)
            all_embeddings.append(embeddings_i)
            if self.config.hierarchical and not self.single:
                hidden = torch.cat([hidden, embeddings_i], dim=-1) if self.config.hierarchical_with_context else embeddings_i
        embeddings = all_embeddings[0] if self.single else torch.cat(all_embeddings, dim=-1)
        return MMDTupleTransformerOutput(
            hidden_state=hidden_state,
            latents=all_latents[0] if self.single else all_latents,
            embeddings=embeddings * mask3,
        )

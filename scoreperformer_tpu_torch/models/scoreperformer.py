"""ScorePerformer composite model.

Counterpart of scoreperformer_tpu/models/scoreperformer.py: the score encoder
and the MMD style encoder produce context and style embeddings. In training,
`forward` runs the decoder over the shifted sequence and returns the MixedLM
cross-entropy, the MMD losses and, when the config sets direction
classifiers, their loss over the style embeddings; in rendering, the decoder
consumes the embeddings one position at a time over static KV caches
(`decode_step`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from ..configs import ModuleConfig
from ..device import resolve_device
from .classifiers import (
    MultiHeadEmbeddingClassifier,
    MultiHeadEmbeddingClassifierConfig,
    MultiHeadEmbeddingClassifierOutput,
)
from .dropout import dropout_generator
from .embeddings import TupleTokenHeadConfig, build_stream_embeddings
from .mmd import (
    MMDSampler,
    MMDTupleTransformer,
    MMDTupleTransformerConfig,
    MMDTupleTransformerOutput,
    mmd_sampler as mmd_sampler_for,
)
from .tuple_transformer import EmbeddingModes, TupleTransformerConfig, TupleTransformerModule

IGNORE_INDEX = -100


class LMModes:
    MLM = "mlm"
    CLM = "clm"
    MixedLM = "mixlm"


def lm_losses(logits: Dict[str, torch.Tensor], labels: torch.Tensor, ignore_index: int = IGNORE_INDEX):
    """Per-stream cross-entropy averaged over the streams that carry labels
    (wrappers.py:55-64). Streams without any valid label count neither in the
    numerator nor in the denominator."""
    losses = {}
    total = denom = 0.0
    for i, (key, lg) in enumerate(logits.items()):
        lab = labels[..., i]
        valid = lab != ignore_index
        nvalid = valid.sum()
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -logp.gather(-1, lab.clamp(0, lg.shape[-1] - 1)[..., None].long())[..., 0]
        stream_loss = (nll * valid).sum() / nvalid.clamp_min(1)
        has = (nvalid > 0).to(stream_loss.dtype)
        losses[key] = stream_loss
        total = total + stream_loss * has
        denom = denom + has
    return total / torch.clamp_min(torch.as_tensor(denom), 1.0), losses


def shift_for_lm(mode, perf, labels, masked_perf, context, style, mask, context_is_cat: bool):
    """CLM/MixedLM shift by one (wrappers.py:290-307, 409-431): the input drops
    the last position; labels, masked sequence, context and style drop the first."""
    if mode not in (LMModes.CLM, LMModes.MixedLM):
        return perf, labels, masked_perf, context, style, mask
    seq = perf[:, :-1]
    labels = labels[:, 1:] if labels is not None else None
    masked = masked_perf[:, 1:] if masked_perf is not None else None
    if context is not None and context_is_cat:
        context = context[:, 1:]
    if style is not None:
        style = style[:, 1:]
    if mask is not None and mask.shape[1] == seq.shape[1] + 1:
        mask = mask[:, :-1]
    return seq, labels, masked, context, style, mask


@dataclass
class ScorePerformerOutput:
    logits: Dict[str, torch.Tensor]
    loss: Optional[torch.Tensor] = None
    losses: Dict[str, torch.Tensor] = field(default_factory=dict)
    perf_encoder: Optional[MMDTupleTransformerOutput] = None
    classifiers: Optional[MultiHeadEmbeddingClassifierOutput] = None


@dataclass
class ScorePerformerConfig(ModuleConfig):
    num_tokens: Optional[Dict[str, int]] = None
    dim: int = 256
    perf_decoder: TupleTransformerConfig = field(default_factory=TupleTransformerConfig)
    score_encoder: Optional[TupleTransformerConfig] = None
    perf_encoder: Optional[MMDTupleTransformerConfig] = None
    classifiers: Optional[MultiHeadEmbeddingClassifierConfig] = None
    tie_token_emb: bool = False
    mode: Optional[str] = None
    num_score_tokens: Optional[Dict[str, int]] = None


class _DecoderWrapper(nn.Module):
    """The reference wraps the decoder in its LM wrapper, so the decoder's
    parameters live under `perf_decoder.model.`."""

    def __init__(self, model: TupleTransformerModule):
        super().__init__()
        self.model = model


class ScorePerformerModel(nn.Module):
    """Built on the GPU unless `device` says otherwise; with no GPU the
    default raises."""

    def __init__(self, config: ScorePerformerConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        num_tokens = cfg.num_tokens
        num_score_tokens = cfg.num_score_tokens or num_tokens
        shared = (
            build_stream_embeddings(num_tokens, cfg.perf_decoder.token_embeddings, cfg.dim)
            if cfg.tie_token_emb
            else None
        )
        self.score_encoder = None
        if cfg.score_encoder is not None:
            self.score_encoder = TupleTransformerModule(
                num_score_tokens, cfg.score_encoder.replace(dim=cfg.dim, lm_head=None), shared_streams=shared
            )
        self.perf_encoder = None
        if cfg.perf_encoder is not None:
            self.perf_encoder = MMDTupleTransformer(
                num_tokens, cfg.perf_encoder.replace(dim=cfg.dim, lm_head=None), shared_streams=shared
            )
        self.classifiers = None
        if cfg.classifiers is not None and cfg.classifiers.num_classes:
            assert self.perf_encoder is not None
            self.classifiers = MultiHeadEmbeddingClassifier(
                self.perf_encoder.embedding_dim, cfg.classifiers.num_classes, cfg.classifiers
            )
        dec_cfg = cfg.perf_decoder.replace(
            dim=cfg.dim,
            context_emb_dim=None if cfg.score_encoder is None else cfg.dim,
            style_emb_dim=None if cfg.perf_encoder is None else cfg.perf_encoder.embedding_dim,
        )
        dec_cfg.transformer = dec_cfg.transformer.replace(cross_attend=cfg.score_encoder is not None)
        if dec_cfg.lm_head is None:
            dec_cfg.lm_head = TupleTokenHeadConfig(_target_="lm")
        self.perf_decoder = _DecoderWrapper(TupleTransformerModule(num_tokens, dec_cfg, shared_streams=shared))
        self.to(device)

    @property
    def decoder(self) -> TupleTransformerModule:
        return self.perf_decoder.model

    def forward_encoders(self, perf=None, perf_mask=None, score=None, score_mask=None,
                         bars=None, beats=None, onsets=None, deadpan_mask=None,
                         compute_loss: bool = False, latent_generator=None,
                         mmd_sampler: Optional[MMDSampler] = None):
        score_emb = perf_emb = perf_enc_out = None
        if self.score_encoder is not None:
            score_emb = self.score_encoder(score, mask=score_mask)
        if self.perf_encoder is not None:
            perf_enc_out = self.perf_encoder(
                perf, mask=perf_mask, bars=bars, beats=beats, onsets=onsets, deadpan_mask=deadpan_mask,
                compute_loss=compute_loss, latent_generator=latent_generator, sampler=mmd_sampler,
            )
            perf_emb = perf_enc_out.embeddings
        return score_emb, perf_emb, perf_enc_out

    def forward(self, perf, perf_mask=None, score=None, score_mask=None, noisy_perf=None,
                noisy_perf_mask=None, masked_perf=None, labels=None, bars=None, beats=None,
                onsets=None, directions=None, deadpan_mask=None, compute_loss: bool = True,
                generators: Optional[Dict[str, torch.Generator]] = None,
                mmd_sampler: Optional[MMDSampler] = None) -> ScorePerformerOutput:
        """The training forward (model.py:259-351): encoders, the shifted
        decoder, the LM and MMD losses, and the direction classifiers' loss
        when the model has them and `directions` is given. Inputs carry the
        names of `data.collators.scoreperformer_model_inputs`. In `module.train()`
        mode dropout draws from generators["dropout"] and latent dropout from
        generators["latent_dropout"]; the MMD samples come from `mmd_sampler`
        or generators["mmd"]."""
        cfg = self.config
        generators = generators or {}
        if compute_loss and mmd_sampler is None and self.perf_encoder is not None:
            enc = self.perf_encoder.config
            mmd_sampler = mmd_sampler_for(generators.get("mmd"), enc.mmd_num_samples, enc.mmd_max_num_latents,
                                          perf.device)
        context_is_cat = self.decoder.config.context_emb_mode == EmbeddingModes.CONCAT
        with dropout_generator(generators.get("dropout")):
            score_emb, perf_emb, perf_enc_out = self.forward_encoders(
                perf=noisy_perf if noisy_perf is not None else perf,
                perf_mask=noisy_perf_mask if noisy_perf_mask is not None else perf_mask,
                score=score, score_mask=score_mask, bars=bars, beats=beats, onsets=onsets,
                deadpan_mask=deadpan_mask, compute_loss=compute_loss,
                latent_generator=generators.get("latent_dropout"), mmd_sampler=mmd_sampler,
            )
            seq, shifted_labels, shifted_masked, context, style, dec_mask = shift_for_lm(
                cfg.mode, perf, labels, masked_perf, score_emb, perf_emb, perf_mask, context_is_cat,
            )
            hidden = self.decoder(
                seq, mask=dec_mask,
                x_extra=[shifted_masked] if shifted_masked is not None else None,
                style_embeddings=style, context=context,
                context_mask=None if context_is_cat else score_mask,
            )
            clf_out = None
            if self.classifiers is not None and directions is not None:
                clf_mask = perf_mask
                if deadpan_mask is not None and clf_mask is not None:
                    clf_mask = clf_mask & ~deadpan_mask[:, None]
                clf_out = self.classifiers(
                    perf_enc_out.full_embeddings, labels=directions,
                    sample_weights=clf_mask.float() if clf_mask is not None else None,
                )
        logits = self.decoder.apply_lm_head(hidden)

        loss, losses = None, {}
        if compute_loss and shifted_labels is not None:
            loss, stream_losses = lm_losses(logits, shifted_labels)
            losses.update({f"loss/{k}": v for k, v in stream_losses.items()})
            losses["loss/lm"] = loss
        if perf_enc_out is not None and perf_enc_out.loss is not None:
            loss = perf_enc_out.loss if loss is None else loss + perf_enc_out.loss
            losses.update(perf_enc_out.losses)
        if clf_out is not None and clf_out.loss is not None:
            loss = clf_out.loss if loss is None else loss + clf_out.loss
            losses.update(clf_out.losses)
        return ScorePerformerOutput(logits=logits, loss=loss, losses=losses, perf_encoder=perf_enc_out,
                                    classifiers=clf_out)

    def encode_embeddings(self, perf, perf_mask=None, score=None, score_mask=None,
                          bars=None, beats=None, onsets=None):
        """Encoder pass only: (score_emb, style_emb, perf_encoder output)."""
        return self.forward_encoders(
            perf=perf, perf_mask=perf_mask, score=score, score_mask=score_mask,
            bars=bars, beats=beats, onsets=onsets,
        )

    def decode_step(self, seq_tokens, masked_tokens=None, style_embeddings=None, context=None,
                    caches=None, cache_index=None, mask=None):
        """Decoder hidden states of a few positions over static KV caches,
        which are updated in place. Inputs are the already shifted decoder
        tokens."""
        return self.decoder(
            seq_tokens, mask=mask,
            x_extra=[masked_tokens] if masked_tokens is not None else None,
            style_embeddings=style_embeddings,
            context=context,
            caches=caches, cache_index=cache_index,
        )

    def init_decoder_cache(self, batch: int, max_len: int, dtype=torch.float32, device="cpu"):
        return self.decoder.init_cache(batch, max_len, dtype, device)

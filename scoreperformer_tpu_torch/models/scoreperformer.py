"""ScorePerformer composite model and the plain Performer LM.

Counterpart of scoreperformer_tpu/models/scoreperformer.py: the score encoder
and the MMD style encoder produce context and style embeddings. In training,
`forward` runs the decoder over the shifted sequence and returns the MixedLM
cross-entropy (with a regression head, plus its L1 term), the MMD losses and,
when the config sets direction classifiers, their loss over the style
embeddings; in rendering, the decoder consumes the embeddings one position at
a time over static KV caches (`decode_step`). `PerformerModel` is the
standalone performance LM, with the same decode-path methods, so that the
same wrappers (`ar_generate`, `mlm_unmask`) drive it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs import ModuleConfig
from ..device import resolve_device
from ..parallel.collectives import data_total, partial_ratio
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
from .moe import moe_summary
from .tuple_transformer import EmbeddingModes, TupleTransformerConfig, TupleTransformerModule, TupleTransformerOutput

IGNORE_INDEX = -100


class LMModes:
    MLM = "mlm"
    CLM = "clm"
    MixedLM = "mixlm"


def lm_losses(logits: Dict[str, torch.Tensor], labels: torch.Tensor, ignore_index: int = IGNORE_INDEX):
    """Per-stream cross-entropy averaged over the streams that carry labels
    (wrappers.py:55-64). Streams without any valid label count neither in the
    numerator nor in the denominator. On a data axis each term is this
    rank's partial: its tokens' sum over the global batch's count."""
    losses = {}
    total = denom = 0.0
    for i, (key, lg) in enumerate(logits.items()):
        lab = labels[..., i]
        valid = lab != ignore_index
        nvalid = data_total(valid.sum())
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -logp.gather(-1, lab.clamp(0, lg.shape[-1] - 1)[..., None].long())[..., 0]
        stream_loss = (nll * valid).sum() / nvalid.clamp_min(1)
        has = (nvalid > 0).to(stream_loss.dtype)
        losses[key] = stream_loss
        total = total + stream_loss * has
        denom = denom + has
    return total / torch.clamp_min(torch.as_tensor(denom), 1.0), losses


def regression_losses(reg_values: Dict[str, torch.Tensor], logits_keys: List[str], labels: torch.Tensor,
                      token_values: Dict[str, list], num_special: int = 4):
    """L1 regression against the token values of the non-special labels
    (wrappers.py:66-78): (mean over the regressed streams, {"<key>/l1": term})."""
    reg_losses = {}
    for i, key in enumerate(logits_keys):
        if key not in reg_values:
            continue
        lab = labels[..., i]
        valid = lab > (num_special - 1)
        values = torch.as_tensor(token_values[key], dtype=torch.float32, device=lab.device)
        targets = values[lab.clamp(0, len(values) - 1).long()]
        l1 = (reg_values[key][..., 0] - targets).abs()
        reg_losses[f"{key}/l1"] = partial_ratio((l1 * valid).sum(), valid.sum(), min_den=1)
    if not reg_losses:
        return 0.0, reg_losses
    return sum(reg_losses.values()) / len(reg_losses), reg_losses


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
    """`logits` and `reg_values` are also `perf_decoder`'s (the JAX output
    keeps them there only); `score_encoder` holds the score encoder's hidden
    state."""
    logits: Dict[str, torch.Tensor]
    loss: Optional[torch.Tensor] = None
    losses: Dict[str, torch.Tensor] = field(default_factory=dict)
    perf_decoder: Optional[TupleTransformerOutput] = None
    score_encoder: Optional[TupleTransformerOutput] = None
    perf_encoder: Optional[MMDTupleTransformerOutput] = None
    classifiers: Optional[MultiHeadEmbeddingClassifierOutput] = None
    reg_values: Optional[Dict[str, torch.Tensor]] = None
    # MoE models: the aux losses of this forward's MoE layers summed (not in
    # `loss`: the trainer adds it) and their drop rates' mean (logged only)
    moe_aux: Optional[torch.Tensor] = None
    moe_drop: Optional[torch.Tensor] = None


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
                         mmd_sampler: Optional[MMDSampler] = None, moe_stats: Optional[list] = None):
        """(score_emb, perf_emb, score_enc_out, perf_enc_out), as the JAX
        model's (model.py:244-278)."""
        score_emb = perf_emb = score_enc_out = perf_enc_out = None
        if self.score_encoder is not None:
            score_enc_out = self.score_encoder(score, mask=score_mask, moe_stats=moe_stats, return_embeddings=True)
            score_emb = score_enc_out.hidden_state
        if self.perf_encoder is not None:
            perf_enc_out = self.perf_encoder(
                perf, mask=perf_mask, bars=bars, beats=beats, onsets=onsets, deadpan_mask=deadpan_mask,
                compute_loss=compute_loss, latent_generator=latent_generator, sampler=mmd_sampler,
                moe_stats=moe_stats,
            )
            perf_emb = perf_enc_out.embeddings
        return score_emb, perf_emb, score_enc_out, perf_enc_out

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
        or generators["mmd"]. An MoE model reports its layers' aux loss and
        drop rate in `moe_aux` and `moe_drop`, outside `loss`, as the JAX
        model sows them."""
        cfg = self.config
        generators = generators or {}
        moe_stats = []
        if compute_loss and mmd_sampler is None and self.perf_encoder is not None:
            enc = self.perf_encoder.config
            mmd_sampler = mmd_sampler_for(generators.get("mmd"), enc.mmd_num_samples, enc.mmd_max_num_latents,
                                          perf.device)
        context_is_cat = self.decoder.config.context_emb_mode == EmbeddingModes.CONCAT
        with dropout_generator(generators.get("dropout")):
            score_emb, perf_emb, score_enc_out, perf_enc_out = self.forward_encoders(
                perf=noisy_perf if noisy_perf is not None else perf,
                perf_mask=noisy_perf_mask if noisy_perf_mask is not None else perf_mask,
                score=score, score_mask=score_mask, bars=bars, beats=beats, onsets=onsets,
                deadpan_mask=deadpan_mask, compute_loss=compute_loss,
                latent_generator=generators.get("latent_dropout"), mmd_sampler=mmd_sampler, moe_stats=moe_stats,
            )
            seq, shifted_labels, shifted_masked, context, style, dec_mask = shift_for_lm(
                cfg.mode, perf, labels, masked_perf, score_emb, perf_emb, perf_mask, context_is_cat,
            )
            hidden = self.decoder(
                seq, mask=dec_mask,
                x_extra=[shifted_masked] if shifted_masked is not None else None,
                style_embeddings=style, context=context,
                context_mask=None if context_is_cat else score_mask, moe_stats=moe_stats,
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
        reg_values = self.decoder.apply_regression_head(hidden)

        loss, losses = None, {}
        if compute_loss and shifted_labels is not None:
            loss, stream_losses = lm_losses(logits, shifted_labels)
            losses.update({f"loss/{k}": v for k, v in stream_losses.items()})
            if reg_values is not None:
                token_values = self.decoder.config.token_embeddings.token_values or {}
                reg_loss, reg = regression_losses(reg_values, list(logits), shifted_labels, token_values)
                loss = loss + reg_loss
                losses.update(reg)
            losses["loss/lm"] = loss
        if perf_enc_out is not None and perf_enc_out.loss is not None:
            loss = perf_enc_out.loss if loss is None else loss + perf_enc_out.loss
            losses.update(perf_enc_out.losses)
        if clf_out is not None and clf_out.loss is not None:
            loss = clf_out.loss if loss is None else loss + clf_out.loss
            losses.update(clf_out.losses)
        dec_out = TupleTransformerOutput(hidden_state=hidden, logits=logits, reg_values=reg_values)
        return ScorePerformerOutput(logits=logits, loss=loss, losses=losses, perf_decoder=dec_out,
                                    score_encoder=score_enc_out, perf_encoder=perf_enc_out, classifiers=clf_out,
                                    reg_values=reg_values, **moe_summary(moe_stats))

    def encode_embeddings(self, perf, perf_mask=None, score=None, score_mask=None,
                          bars=None, beats=None, onsets=None):
        """Encoder pass only: (score_emb, style_emb, perf_encoder output)."""
        score_emb, style_emb, _, perf_enc_out = self.forward_encoders(
            perf=perf, perf_mask=perf_mask, score=score, score_mask=score_mask,
            bars=bars, beats=beats, onsets=onsets,
        )
        return score_emb, style_emb, perf_enc_out

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

    @property
    def perf_decoder_dim(self) -> int:
        return self.config.dim

    def init_decoder_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """The decoder's static KV caches, on the parameters' device unless
        `device` is given."""
        return self.decoder.init_cache(batch, max_len, dtype, device or next(self.parameters()).device)


@dataclass
class PerformerConfig(ModuleConfig):
    transformer: TupleTransformerConfig = field(default_factory=TupleTransformerConfig)
    mode: Optional[str] = None
    num_tokens: Optional[Dict[str, int]] = None


class PerformerModel(nn.Module):
    """The standalone performance LM (model.py:50-122): one TupleTransformer
    over the performance tokens, trained as a CLM, MLM or MixedLM by
    `config.mode`. Its parameters live under `transformer.model.`, the
    reference's names. Built on the GPU unless `device` says otherwise."""

    def __init__(self, config: PerformerConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        cfg = config.transformer
        if cfg.lm_head is None:
            cfg = cfg.replace(lm_head=TupleTokenHeadConfig(_target_="lm"))
        self.transformer = _DecoderWrapper(TupleTransformerModule(config.num_tokens, cfg))
        self.to(device)

    @property
    def decoder(self) -> TupleTransformerModule:
        return self.transformer.model

    @property
    def perf_decoder(self) -> _DecoderWrapper:
        """The decode path's decoder under the ScorePerformer's name."""
        return self.transformer

    @property
    def perf_decoder_dim(self) -> int:
        return self.config.transformer.dim

    def forward(self, perf, mask=None, labels=None, masked_perf=None, compute_loss: bool = True,
                generators: Optional[Dict[str, torch.Generator]] = None) -> ScorePerformerOutput:
        """The training forward: the mode's shift, the transformer, the
        per-stream cross-entropy. Inputs carry the names of
        `data.performer_model_inputs`; in `module.train()` mode dropout
        draws from generators["dropout"]. MoE layers report as in
        `ScorePerformerModel.forward`."""
        seq, labels, masked, _, _, mask = shift_for_lm(self.config.mode, perf, labels, masked_perf, None, None,
                                                       mask, False)
        moe_stats = []
        with dropout_generator((generators or {}).get("dropout")):
            hidden = self.decoder(seq, mask=mask, x_extra=[masked] if masked is not None else None,
                                  moe_stats=moe_stats)
        logits = self.decoder.apply_lm_head(hidden)
        loss, losses = None, {}
        if compute_loss and labels is not None:
            loss, stream_losses = lm_losses(logits, labels)
            losses = {f"loss/{k}": v for k, v in stream_losses.items()}
        return ScorePerformerOutput(logits=logits, loss=loss, losses=losses, **moe_summary(moe_stats))

    def decode_step(self, seq_tokens, masked_tokens=None, style_embeddings=None, context=None,
                    caches=None, cache_index=None, mask=None):
        """The transformer's hidden states of a few positions over static KV
        caches, updated in place; a Performer has no style or context, and
        ignores them as the JAX model does."""
        return self.decoder(
            seq_tokens, mask=mask,
            x_extra=[masked_tokens] if masked_tokens is not None else None,
            caches=caches, cache_index=cache_index,
        )

    def init_decoder_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """The transformer's static KV caches, on the parameters' device
        unless `device` is given."""
        return self.decoder.init_cache(batch, max_len, dtype, device or next(self.parameters()).device)

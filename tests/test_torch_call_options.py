"""The call options of the JAX modules that the port takes with the same
meaning, held to the JAX package on the CPU on the same numpy inputs and
weights: the MMD encoder's external `latents` and `mask_bars`; the tuple
transformer's `return_embeddings`, `return_hiddens` and `logits_keys` (and
the stack's `return_hiddens`); the tied head's `batched` (through
`apply_lm_head`); the ScorePerformer output's `perf_decoder` and
`score_encoder` and `forward_encoders`' fourth value; both models'
`perf_decoder_dim`; `save_checkpoint`'s `extra_meta`; `top_k`'s `method` and
`recall`.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scoreperformer_tpu.ops import sampling as jsampling
from scoreperformer_tpu.training import checkpoint as jcheckpoint

from scoreperformer_tpu_torch.models.tuple_transformer import TupleTransformerOutput
from scoreperformer_tpu_torch.ops import sampling as tsampling
from scoreperformer_tpu_torch.training import checkpoint as tcheckpoint

import test_torch_performer as tperformer
from test_torch_modules import LAYER_TOL, MODEL_TOL, NUM_TOKENS, apply, build_pair, close, make_inputs, rand, t, \
    tiny_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    inputs = make_inputs()
    model, variables, port = build_pair(tiny_config(), inputs)
    return model, variables, port, inputs


def ids(x):
    return t(x, torch.int64)


def external_latents(port, b, seed=20):
    """One latent tensor a level of the hierarchical encoder (mean, bar, beat
    and onset levels): (b, 1, d) at the mean level, (b, max_segments, d) at
    the others, with zero rows (empty segments)."""
    rng = np.random.RandomState(seed)
    segments = port.perf_encoder.config.max_segments
    out = []
    for mode, d in zip(port.perf_encoder.modes, port.perf_encoder.latent_dims):
        n = 1 if mode == "mean" else segments
        x = rng.randn(b, n, d).astype(np.float32)
        if n > 1:
            x[:, rng.rand(n) < 0.5] = 0.0
        out.append(x)
    return out


@torch.no_grad()
@pytest.mark.parametrize("with_latents,mask_bars", [(True, False), (False, True), (True, True)])
def test_mmd_encoder_external_latents_and_mask_bars(pair, with_latents, mask_bars):
    """The MMD encoder with external latents per level (in place of the
    encoded ones) and with the bar ids hidden: embeddings, latents and the
    hidden state as JAX's."""
    model, variables, port, x = pair
    lat = external_latents(port, x["perf"].shape[0]) if with_latents else None
    args = [x[k] for k in ("perf", "mask", "bars", "beats", "onsets")]
    want = model.apply(variables, *map(jnp.asarray, args), method=lambda m, p, k, ba, be, on: m.perf_encoder(
        p, mask=k, bars=ba, beats=be, onsets=on, compute_loss=False, mask_bars=mask_bars,
        latents=None if lat is None else [jnp.asarray(a) for a in lat]))
    got = port.perf_encoder(ids(x["perf"]), mask=t(x["mask"]), bars=t(x["bars"]), beats=t(x["beats"]),
                            onsets=t(x["onsets"]), mask_bars=mask_bars,
                            latents=None if lat is None else [t(a) for a in lat])
    close(want.hidden_state, got.hidden_state, MODEL_TOL)
    close(want.embeddings, got.embeddings, MODEL_TOL)
    for w, g in zip(want.latents, got.latents):
        close(w, g, MODEL_TOL)
    plain = port.perf_encoder(ids(x["perf"]), mask=t(x["mask"]), bars=t(x["bars"]), beats=t(x["beats"]),
                              onsets=t(x["onsets"]))
    assert not torch.allclose(plain.embeddings, got.embeddings)  # the option changes the result


@torch.no_grad()
def test_stack_returns_its_hiddens(pair):
    model, variables, port, x = pair
    h = rand(4, 2, 12, 32)
    want_out, _, want = apply(model, variables, lambda m, h, k: m.score_encoder.transformer(
        h, mask=k, return_hiddens=True), h, x["mask"])
    got_out, got = port.score_encoder.transformer(t(h), mask=t(x["mask"]), return_hiddens=True)
    close(want_out, got_out)
    assert len(got) == len(want) == 2  # one self-attention layer's input, then the output
    for w, g in zip(want, got):
        close(w, g)


@torch.no_grad()
@pytest.mark.parametrize("options", [dict(return_hiddens=True), dict(logits_keys=["Pitch", "Velocity"]),
                                     dict(return_embeddings=True, return_hiddens=True),
                                     dict(return_embeddings=False)])
def test_decoder_output_options(pair, options):
    """The decoder with the JAX module's output options: hidden state,
    logits (of `logits_keys` only), no logits with `return_embeddings`,
    and every self-attention layer's input and the output as hiddens."""
    model, variables, port, x = pair
    style, context = rand(6, 2, 12, port.perf_encoder.embedding_dim), rand(7, 2, 12, 32)
    args = (x["perf"], x["mask"], x["masked"], style, context)
    want = apply(model, variables, lambda m, p, k, q, s, c: m.perf_decoder(
        p, mask=k, x_extra=[q], style_embeddings=s, context=c, **options), *args)
    got = port.decoder(ids(x["perf"]), mask=t(x["mask"]), x_extra=[ids(x["masked"])], style_embeddings=t(style),
                       context=t(context), **options)
    assert isinstance(got, TupleTransformerOutput)
    close(want.hidden_state, got.hidden_state, MODEL_TOL)
    if options.get("return_embeddings"):
        assert got.logits is None and want.logits is None
    else:
        assert list(got.logits) == list(want.logits) == options.get("logits_keys", list(NUM_TOKENS))
        for key in got.logits:
            close(want.logits[key], got.logits[key], MODEL_TOL)
    assert got.reg_values is None and want.reg_values is None and got.caches is None and want.caches is None
    if options.get("return_hiddens"):
        assert len(got.hiddens) == len(want.hiddens) == 3
        for w, g in zip(want.hiddens, got.hiddens):
            close(w, g, MODEL_TOL)
    else:
        assert got.hiddens is None and want.hiddens is None


@torch.no_grad()
def test_a_call_without_the_options_returns_the_hidden_state(pair):
    """A deliberate deviation: called without any of the three options, the
    port's module returns its hidden state alone (its callers apply the heads
    themselves), where the JAX module returns an output with the logits."""
    model, variables, port, x = pair
    want = apply(model, variables, lambda m, s, k: m.score_encoder(s, mask=k), x["score"], x["mask"])
    got = port.score_encoder(ids(x["score"]), mask=t(x["mask"]))
    assert isinstance(got, torch.Tensor) and want.logits is None  # the score encoder has no head
    close(want.hidden_state, got, MODEL_TOL)


@torch.no_grad()
def test_scoreperformer_output_keeps_the_decoder_and_score_encoder_outputs(pair):
    """`forward_encoders` returns (score_emb, perf_emb, score_enc_out,
    perf_enc_out) and the model's output keeps the decoder's and the score
    encoder's outputs, as JAX's."""
    model, variables, port, x = pair
    names = ("perf", "mask", "score", "mask", "masked", "bars", "beats", "onsets")
    j = [jnp.asarray(x[k]) for k in names]
    want = model.apply(variables, j[0], perf_mask=j[1], score=j[2], score_mask=j[3], masked_perf=j[4], bars=j[5],
                       beats=j[6], onsets=j[7], compute_loss=False)
    tx = [ids(x[k]) if x[k].dtype != bool else t(x[k]) for k in names]
    got = port(tx[0], perf_mask=tx[1], score=tx[2], score_mask=tx[3], masked_perf=tx[4], bars=tx[5], beats=tx[6],
               onsets=tx[7], compute_loss=False)
    close(want.score_encoder.hidden_state, got.score_encoder.hidden_state, MODEL_TOL)
    close(want.perf_decoder.hidden_state, got.perf_decoder.hidden_state, MODEL_TOL)
    for key in NUM_TOKENS:
        close(want.perf_decoder.logits[key], got.perf_decoder.logits[key], MODEL_TOL)
        assert got.perf_decoder.logits[key] is got.logits[key]
    jenc = model.apply(variables, j[0], j[1], j[2], j[3], j[5], j[6], j[7], compute_loss=False,
                       method="forward_encoders")
    tenc = port.forward_encoders(tx[0], tx[1], tx[2], tx[3], tx[5], tx[6], tx[7])
    assert len(tenc) == len(jenc) == 4
    close(jenc[0], tenc[0], MODEL_TOL)
    close(jenc[2].hidden_state, tenc[2].hidden_state, MODEL_TOL)
    close(jenc[3].embeddings, tenc[3].embeddings, MODEL_TOL)


@torch.no_grad()
def test_batched_tied_head_matches_jax(pair):
    """`apply_lm_head(h, batched=True)`: one (..., S, Vmax) tensor from the
    zero-padded stacked tables, as JAX's; a stream's columns at or past its
    vocabulary are 0, the others its per-stream logits."""
    model, variables, port, _ = pair
    h = rand(8, 2, 12, 32)
    want = apply(model, variables, lambda m, h: m.perf_decoder.apply_lm_head(h, batched=True), h)
    got = port.decoder.apply_lm_head(t(h), batched=True)
    vmax = max(NUM_TOKENS.values())
    assert got.shape == (2, 12, len(NUM_TOKENS), vmax)
    close(want, got, LAYER_TOL)
    per_stream = port.decoder.apply_lm_head(t(h))
    for s, (key, num) in enumerate(NUM_TOKENS.items()):
        assert torch.equal(got[..., s, num:], torch.zeros_like(got[..., s, num:]))
        close(per_stream[key].numpy(), got[..., s, :num], LAYER_TOL)


def test_batched_head_refusals(pair, monkeypatch):
    """Where JAX asserts, the port raises ValueError: `keys` with `batched`,
    stream dims that differ, a head that is not tied."""
    _, _, port, _ = pair
    h = torch.zeros(1, 3, 32)
    with pytest.raises(ValueError, match="all streams"):
        port.decoder.apply_lm_head(h, keys=["Pitch"], batched=True)
    monkeypatch.setitem(port.decoder.token_emb.emb_dims_map, "Bar", 8)
    with pytest.raises(ValueError, match="uniform stream dims"):
        port.decoder.apply_lm_head(h, batched=True)
    monkeypatch.undo()
    _, _, performer = tperformer.build_pair(tperformer.performer_config(head="lm"), tperformer.tokens())
    with pytest.raises(ValueError, match="tied LM head"):
        performer.decoder.apply_lm_head(h, batched=True)


def test_perf_decoder_dim_matches_jax(pair):
    """Both models' `perf_decoder_dim`: the ScorePerformer's `config.dim`,
    the Performer's transformer's."""
    model, _, port, _ = pair
    assert port.perf_decoder_dim == model.perf_decoder_dim == 32
    cfg = tperformer.performer_config()
    cfg["transformer"]["dim"] = 48
    jmodel, _, performer = tperformer.build_pair(cfg, tperformer.tokens())
    assert performer.perf_decoder_dim == jmodel.perf_decoder_dim == 48


def test_save_checkpoint_merges_extra_meta(pair, tmp_path):
    """`extra_meta` joins the meta file's keys beside the trainer state and
    the model config, as in the JAX checkpoint."""
    model, variables, port, _ = pair
    meta = dict(trainer_state={"global_step": 3}, model_config={"_name_": "ScorePerformer"},
                extra_meta={"tokenizer": "spmuple", "notes": [1, 2]})
    jdir = jcheckpoint.save_checkpoint(str(tmp_path / "jax"), {"w": np.zeros(2, np.float32)}, **meta)
    tdir = tcheckpoint.save_checkpoint(str(tmp_path / "port"), port, **meta)
    want = json.loads((tmp_path / "jax" / "meta.json").read_text())
    got = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert got == want and got["tokenizer"] == "spmuple"
    assert jdir.endswith("jax") and tdir.endswith("port")


@pytest.mark.parametrize("recall", [1.0, 0.95])
@pytest.mark.parametrize("method", ["sort", "exact", "approx"])
def test_top_k_method_and_recall(method, recall):
    """Every method keeps what JAX's CPU result keeps (its `approx_max_k`
    is exact there, which meets any recall target), ties included."""
    rng = np.random.RandomState(5)
    logits = rng.randn(3, 4, 97).astype(np.float32)
    logits[0, 0, :10] = 1.5  # ties at the k-th value
    for k, thres in ((None, 0.9), (7, 0.9), (1, 0.5)):
        want = np.asarray(jsampling.top_k(jnp.asarray(logits), thres, k, method=method, recall=recall))
        got = tsampling.top_k(torch.from_numpy(logits), thres, k, method=method, recall=recall).numpy()
        np.testing.assert_array_equal(np.isfinite(got), want > jsampling.NEG_INF)
        np.testing.assert_array_equal(got[np.isfinite(got)], want[want > jsampling.NEG_INF])

"""The PyTorch port's modules against the JAX package's, on the CPU.

Same inputs (numpy, from a seed) and the same weights (a JAX `model.init`
carried over by `scoreperformer_tpu_torch.convert`) go through both. Each
layer must agree to atol/rtol 1e-5; whole encoders to 1e-4, because flax's
LayerNorm takes the variance as E[x^2]-E[x]^2 and the two frameworks sum in
other orders, and the differences add up over the layers.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.models import MODELS
from scoreperformer_tpu.models import attention as jattention
from scoreperformer_tpu.models import layers as jlayers

from scoreperformer_tpu_torch.convert import load_state_dict, state_dict_from_jax
from scoreperformer_tpu_torch.models import attention as tattention
from scoreperformer_tpu_torch.models import layers as tlayers
from scoreperformer_tpu_torch.models.factory import build_scoreperformer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)

NUM_TOKENS = {
    "Bar": 20, "Position": 36, "Pitch": 24, "Velocity": 16, "Duration": 20,
    "Tempo": 12, "TimeSig": 8, "RelOnsetDev": 21, "RelPerfDuration": 17,
}
SCORE_TOKENS = {k: v for k, v in NUM_TOKENS.items() if not k.startswith("Rel")}
PERF_DIMS = (3, 5, 7, 8)  # Velocity, Tempo, RelOnsetDev, RelPerfDuration


def tiny_config(use_flash=False, num_tokens=NUM_TOKENS, score_tokens=SCORE_TOKENS,
                token_values=None, max_segments=64, variant=None):
    if token_values is None:
        token_values = {k: np.linspace(0, 1, v).tolist() for k, v in num_tokens.items()}
    emb = {"_target_": "simple", "emb_dims": 16, "mode": "cat", "emb_norm": True,
           "discrete": False, "continuous": True, "continuous_dense": True,
           "discrete_ids": [0, 1, 2, 3], "token_values": token_values}
    attn = {"dim_head": 8, "one_kv_head": True, "alibi_pos_bias": True,
            "alibi_learned": True, "use_flash": use_flash}
    ff = {"mult": 2, "glu": True, "swish": True}

    def enc(depth):
        return {"_target_": "encoder", "depth": depth, "heads": 2, "attention": attn, "feed_forward": ff}

    cfg = {
        "num_tokens": num_tokens, "num_score_tokens": score_tokens,
        "dim": 32, "tie_token_emb": True, "mode": "mixlm",
        "score_encoder": {"token_embeddings": dict(emb), "emb_norm": True, "use_abs_pos_emb": False,
                          "max_seq_len": 512, "transformer": enc(1)},
        "perf_encoder": {"token_embeddings": dict(emb), "emb_norm": True, "use_abs_pos_emb": False,
                         "max_seq_len": 512, "latent_dim": [8, 6, 4, 2],
                         "aggregate_mode": ["mean", "bar_mean", "beat_mean", "onset_mean"],
                         "hierarchical": True, "max_segments": max_segments, "transformer": enc(2)},
        "perf_decoder": {"token_embeddings": {**emb, "_target_": "multi-seq", "multiseq_mode": "post-cat"},
                         "emb_norm": True, "use_abs_pos_emb": False, "max_seq_len": 512,
                         "context_emb_mode": "cat", "style_emb_mode": "adanorm",
                         "transformer": {"_target_": "decoder", "depth": 2, "heads": 2,
                                         "attention": attn, "feed_forward": ff},
                         "lm_head": {"_target_": "lm-tied"}},
    }
    if variant == "isolated_bars":
        # block-diagonal bar attention (no flash), flat (non-hierarchical) latents
        cfg["perf_encoder"].update(latent_dim=[8, 6, 4], hierarchical=False,
                                   aggregate_mode=["isolated_bar_mean", "beat_mean", "onset_mean"])
    if variant == "abs_pos_post_norm":
        # absolute positions (offset by the cache index while decoding) and a
        # post-norm score encoder
        cfg["score_encoder"]["use_abs_pos_emb"] = cfg["perf_decoder"]["use_abs_pos_emb"] = True
        cfg["score_encoder"]["transformer"]["pre_norm"] = False
    return cfg


def make_inputs(seed=0, b=2, t=12):
    rng = np.random.RandomState(seed)
    perf = np.stack([rng.randint(4, v, (b, t)) for v in NUM_TOKENS.values()], -1).astype(np.int32)
    masked = perf.copy()
    masked[..., PERF_DIMS] = 1
    mask = np.ones((b, t), bool)
    mask[1, t - 3:] = False  # right padding on the second sequence
    return {
        "perf": perf, "masked": masked, "score": perf[..., : len(SCORE_TOKENS)].copy(), "mask": mask,
        "bars": np.sort(rng.randint(4, 8, (b, t)), 1).astype(np.int32),
        "beats": np.sort(rng.randint(4, 16, (b, t)), 1).astype(np.int32),
        "onsets": np.sort(rng.randint(4, t + 4, (b, t)), 1).astype(np.int32),
    }


def build_pair(cfg, inputs):
    """(JAX model, JAX variables, port model on the CPU) with the same weights."""
    model, _ = MODELS.get("ScorePerformer")(**cfg)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "latent_dropout": jax.random.PRNGKey(2), "mmd": jax.random.PRNGKey(3)}
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.jit(lambda r, j: model.init(
        r, j["perf"], perf_mask=j["mask"], score=j["score"], score_mask=j["mask"],
        masked_perf=j["masked"], bars=j["bars"], beats=j["beats"], onsets=j["onsets"],
        deadpan_mask=jnp.zeros(j["perf"].shape[0], bool),
    ))(rngs, j)
    port, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    load_state_dict(port, state_dict_from_jax(jax.device_get(variables["params"])))
    return model, variables, port.eval()


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out.to(dtype) if dtype is not None else out


def close(jax_out, torch_out, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(torch_out.detach()), np.asarray(jax_out), **tol)


@pytest.fixture(scope="module", params=[(False, None), (True, None), (False, "abs_pos_post_norm"),
                                        (True, "isolated_bars")],
                ids=["xla_attention", "flash_attention", "abs_pos_post_norm", "isolated_bars"])
def pair(request):
    inputs = make_inputs()
    use_flash, variant = request.param
    model, variables, port = build_pair(tiny_config(use_flash=use_flash, variant=variant), inputs)
    return model, variables, port, inputs


def apply(model, variables, fn, *args):
    return model.apply(variables, *map(jnp.asarray, args), method=lambda m, *a: fn(m, *a))


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- whole-model parity ----


@torch.no_grad()
def test_every_parameter_filled(pair):
    model, variables, port, _ = pair
    sd = state_dict_from_jax(jax.device_get(variables["params"]))
    own = port.state_dict()
    # tied streams: the JAX tree holds them once, the port under every owner
    assert len(sd) <= len(own)
    for name, value in sd.items():
        name = name.replace("proj|0", "proj")
        np.testing.assert_array_equal(own[name].numpy(), np.asarray(value))


@torch.no_grad()
def test_stream_tables(pair):
    model, variables, port, _ = pair
    want = apply(model, variables, lambda m: m.perf_decoder.token_emb.tables())
    got = port.decoder.token_emb.tables()
    for key in NUM_TOKENS:
        close(want[key], got[key])


@torch.no_grad()
def test_token_embeddings_cat_and_post_cat(pair):
    model, variables, port, x = pair
    close(apply(model, variables, lambda m, s: m.score_encoder.token_emb(s), x["score"]),
          port.score_encoder.token_emb(t(x["score"], torch.int64)))
    want = apply(model, variables, lambda m, p, q: m.perf_decoder.token_emb(p, x_extra=[q]),
                 x["perf"], x["masked"])
    close(want, port.decoder.token_emb(t(x["perf"], torch.int64), [t(x["masked"], torch.int64)]))


@torch.no_grad()
def test_attention_and_feed_forward_layers(pair):
    model, variables, port, x = pair
    h = rand(1, 2, 12, 32)
    want, _ = apply(model, variables, lambda m, h, k: m.score_encoder.transformer.layers[0](h, mask=k),
                    h, x["mask"])
    close(want, port.score_encoder.transformer.layers[0][1](t(h), mask=t(x["mask"])))
    want = apply(model, variables, lambda m, h: m.score_encoder.transformer.layers[1](h), h)
    close(want, port.score_encoder.transformer.layers[1][1](t(h)))


@torch.no_grad()
def test_layer_norm_and_adaptive_layer_norm(pair):
    model, variables, port, _ = pair
    h, style = rand(2, 2, 12, 32), rand(3, 2, 12, port.perf_encoder.embedding_dim)
    want = apply(model, variables, lambda m, h: m.score_encoder.transformer.norms[0](h), h)
    close(want, port.score_encoder.transformer.layers[0][0][0](t(h)))
    want = apply(model, variables, lambda m, h, s: m.perf_decoder.transformer.norms[0](h, condition=s), h, style)
    close(want, port.decoder.transformer.layers[0][0][0](t(h), t(style)))
    want = apply(model, variables, lambda m, h: m.perf_decoder.transformer.final_norm(h), h)
    close(want, port.decoder.transformer.final_norm(t(h)))


@torch.no_grad()
def test_transformer_stack(pair):
    model, variables, port, x = pair
    h = rand(4, 2, 12, 32)
    want, _, _ = apply(model, variables, lambda m, h, k: m.score_encoder.transformer(h, mask=k), h, x["mask"])
    close(want, port.score_encoder.transformer(t(h), mask=t(x["mask"])))


@torch.no_grad()
def test_tied_lm_head(pair):
    model, variables, port, _ = pair
    h = rand(5, 2, 3, 32)
    want = apply(model, variables, lambda m, h: m.perf_decoder.apply_lm_head(h), h)
    got = port.decoder.apply_lm_head(t(h))
    assert list(got) == list(NUM_TOKENS)
    for key in NUM_TOKENS:
        close(want[key], got[key])


@torch.no_grad()
def test_score_encoder(pair):
    model, variables, port, x = pair
    want = apply(model, variables, lambda m, s, k: m.score_encoder(s, mask=k, return_embeddings=True).hidden_state,
                 x["score"], x["mask"])
    close(want, port.score_encoder(t(x["score"], torch.int64), mask=t(x["mask"])), MODEL_TOL)


@torch.no_grad()
def test_mmd_style_encoder(pair):
    model, variables, port, x = pair
    args = [x[k] for k in ("perf", "mask", "bars", "beats", "onsets")]
    want = apply(model, variables, lambda m, p, k, ba, be, on: m.perf_encoder(
        p, mask=k, bars=ba, beats=be, onsets=on, compute_loss=False), *args)
    got = port.perf_encoder(*(t(a, torch.int64 if a.dtype != bool else None) for a in args[:1]),
                            mask=t(x["mask"]), bars=t(x["bars"]), beats=t(x["beats"]), onsets=t(x["onsets"]))
    close(want.embeddings, got.embeddings, MODEL_TOL)
    for w, g in zip(want.latents, got.latents):
        close(w, g, MODEL_TOL)


@torch.no_grad()
def test_encode_embeddings(pair):
    model, variables, port, x = pair
    args = [x[k] for k in ("perf", "mask", "score", "mask", "bars", "beats", "onsets")]
    want_score, want_style, _ = model.apply(variables, *map(jnp.asarray, args), method="encode_embeddings")
    got_score, got_style, _ = port.encode_embeddings(
        *(t(a, torch.int64) if a.dtype != bool else t(a) for a in args))
    close(want_score, got_score, MODEL_TOL)
    close(want_style, got_style, MODEL_TOL)


@torch.no_grad()
def test_decode_steps_over_the_ring_cache(pair):
    model, variables, port, x = pair
    b, T = 2, 6
    style, context = rand(6, b, T, port.perf_encoder.embedding_dim), rand(7, b, T, 32)
    jcaches = model.apply(variables, b, T, method=lambda m, bb, tt: m.init_decoder_cache(bb, tt))
    tcaches = port.init_decoder_cache(b, T, device="cpu")
    for j in range(T + 2):  # the last two steps wrap the ring
        p = j % T
        args = (x["perf"][:, p : p + 1], x["masked"][:, p : p + 1], style[:, p : p + 1], context[:, p : p + 1])
        out = model.apply(variables, *map(jnp.asarray, args), caches=jcaches, cache_index=j, method="decode_step")
        jcaches = out.caches
        got = port.decode_step(t(args[0], torch.int64), t(args[1], torch.int64), t(args[2]), t(args[3]),
                               caches=tcaches, cache_index=torch.tensor([j]))
        close(out.hidden_state, got)
        for jc, tc in zip(jcaches, tcaches):
            if jc is not None:
                close(jc["k"], tc["k"])
                close(jc["v"], tc["v"])


@torch.no_grad()
def test_softmax_bf16_stack_and_encoders_match_jax():
    """A tiny model whose attention layers all set softmax_bf16 and
    fused_mask_select (as recipes/scoreperformer/scale_1024.yaml does): the
    score encoder's stack and both encoders' embeddings against JAX's.
    Measured: 9.5e-7 on the stack and 7.2e-7 on the embeddings (both
    frameworks round the same bf16 steps), held to MODEL_TOL; the same
    weights with the fp32 softmax are 2.5e-3 to 1.1e-2 off, so the test
    tells the two apart."""
    inputs = make_inputs()
    cfg = tiny_config()
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"]["attention"] = {**cfg[key]["transformer"]["attention"],
                                                "softmax_bf16": True, "fused_mask_select": True}
    model, variables, port = build_pair(cfg, inputs)
    h = rand(4, 2, 12, 32)
    want, _, _ = apply(model, variables, lambda m, h, k: m.score_encoder.transformer(h, mask=k), h, inputs["mask"])
    args = [inputs[k] for k in ("perf", "mask", "score", "mask", "bars", "beats", "onsets")]
    want_emb = model.apply(variables, *map(jnp.asarray, args), method="encode_embeddings")[:2]
    targs = [t(a, torch.int64) if a.dtype != bool else t(a) for a in args]
    errors = {}
    for flag in (True, False):
        for m in port.modules():
            if isinstance(m, tattention.Attention):
                m.softmax_bf16 = flag
        got = port.score_encoder.transformer(t(h), mask=t(inputs["mask"]))
        got_emb = port.encode_embeddings(*targs)[:2]
        errors[flag] = max(np.abs(np.asarray(w) - g.numpy()).max() for w, g in zip([want, *want_emb], [got, *got_emb]))
        if flag:
            close(want, got, MODEL_TOL)
            for w, g in zip(want_emb, got_emb):
                close(w, g, MODEL_TOL)
    assert errors[True] <= 1e-5 and errors[False] > 1e-3, errors


# ---- single modules with their own weights ----


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 6, 8, 12])
def test_alibi_slopes(heads):
    np.testing.assert_array_equal(tlayers.alibi_slopes(heads).numpy(), np.asarray(jlayers.alibi_slopes(heads)))


@pytest.mark.parametrize("symmetric,learned,heads,total", [
    (True, True, 4, 4), (True, False, 2, 3), (False, False, 3, 4), (False, True, 4, 4),
])
def test_alibi_positional_bias(symmetric, learned, heads, total):
    jmod = jlayers.ALiBiPositionalBias(heads=heads, total_heads=total, symmetric=symmetric, learned=learned)
    pos_i, pos_j = np.array([5, 6, 7]), np.array([0, 7, 2, 3, 9, 5])  # ring-cache-like key positions
    variables = jmod.init(jax.random.PRNGKey(0), 3, 6, pos_i=pos_i, pos_j=pos_j)
    want = jmod.apply(variables, 3, 6, pos_i=pos_i, pos_j=pos_j)
    tmod = tlayers.ALiBiPositionalBias(heads, total, symmetric=symmetric, learned=learned)
    if learned:
        with torch.no_grad():
            tmod.learned_logslopes.copy_(t(variables["params"]["learned_logslopes"]))
    close(want, tmod(t(pos_i), t(pos_j)))


def _linear(mod, p):
    with torch.no_grad():
        mod.weight.copy_(t(p["kernel"]).T)
        if "bias" in p:
            mod.bias.copy_(t(p["bias"]))


@pytest.mark.parametrize("glu,swish,post_act_ln,no_bias", [
    (True, True, False, True), (False, False, False, False), (False, True, True, True),
])
def test_feed_forward(glu, swish, post_act_ln, no_bias):
    x = rand(8, 2, 5, 16)
    jmod = jlayers.FeedForward(dim=16, mult=2, glu=glu, swish=swish, post_act_ln=post_act_ln, no_bias=no_bias)
    params = jmod.init(jax.random.PRNGKey(1), x)["params"]
    tmod = tlayers.FeedForward(16, mult=2, glu=glu, swish=swish, post_act_ln=post_act_ln, no_bias=no_bias)
    _linear(tmod.ff[0].proj if glu else tmod.ff[0][0], params["proj_in"])
    _linear(tmod.ff[3], params["proj_out"])
    if post_act_ln:
        with torch.no_grad():
            tmod.ff[1].weight.copy_(t(params["post_act_norm"]["scale"]))
            tmod.ff[1].bias.copy_(t(params["post_act_norm"]["bias"]))
    close(jmod.apply({"params": params}, x), tmod(t(x)))


ATTENTION_CASES = {
    "mqa_causal_learned": dict(one_kv_head=True, causal=True, alibi_pos_bias=True, alibi_learned=True),
    "mha_asymmetric_partial_heads": dict(alibi_pos_bias=True, alibi_symmetric=False, alibi_num_heads=2),
    "mha_causal_window": dict(causal=True, max_attend=3, alibi_pos_bias=True),
    "mqa_attn_mask": dict(one_kv_head=True, alibi_pos_bias=True, alibi_learned=True),
    "flash_mqa": dict(one_kv_head=True, alibi_pos_bias=True, alibi_learned=True, use_flash=True),
    "flash_mha_causal": dict(causal=True, alibi_pos_bias=True, use_flash=True),
    "flash_no_alibi": dict(use_flash=True),
    "cross_attention": dict(one_kv_head=True, alibi_pos_bias=True),
}


def _attention_pair(kw, x, heads=3, dim_head=8, **call):
    jmod = jattention.Attention(dim=16, dim_head=dim_head, heads=heads, **kw)
    params = jmod.init(jax.random.PRNGKey(2), x, **call)["params"]
    # the port always takes the fused mask select
    tmod = tattention.Attention(16, dim_head=dim_head, heads=heads,
                                **{k: v for k, v in kw.items() if k != "fused_mask_select"})
    for name in ("to_q", "to_k", "to_v", "to_out"):
        _linear(getattr(tmod, name), params[name])
    if "rel_pos" in params:
        with torch.no_grad():
            tmod.rel_pos.learned_logslopes.copy_(t(params["rel_pos"]["learned_logslopes"]))
    return jmod, params, tmod


def _full_path_inputs(case):
    """x and the call's keyword arguments for JAX and for the port."""
    x = rand(9, 2, 7, 16)
    mask = np.ones((2, 7), bool)
    mask[1, 5:] = False
    call = {"mask": mask}
    tcall = {"mask": t(mask)}
    if case == "mqa_attn_mask":
        am = np.random.RandomState(10).rand(2, 7, 7) < 0.7
        am[:, np.arange(7), np.arange(7)] = True
        call["attn_mask"], tcall["attn_mask"] = am, t(am)
    if case == "cross_attention":
        ctx = rand(11, 2, 9, 16)
        cmask = np.ones((2, 9), bool)
        cmask[0, 7:] = False
        call.update(context=ctx, context_mask=cmask)
        tcall.update(context=t(ctx), context_mask=t(cmask))
    return x, call, tcall


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_full_path(case):
    x, call, tcall = _full_path_inputs(case)
    jmod, params, tmod = _attention_pair(ATTENTION_CASES[case], x, **call)
    want, _ = jmod.apply({"params": params}, x, **call)
    with torch.no_grad():
        close(want, tmod(t(x), **tcall))


@pytest.mark.parametrize("case", [c for c in ATTENTION_CASES if not c.startswith("flash")])
def test_attention_fused_mask_select(case):
    """The port's one select of the ANDed masks (key mask, attn_mask, window,
    causality) against JAX's two forms of the flag: those two give the same
    bits, and the port is within 1e-5 of them."""
    x, call, tcall = _full_path_inputs(case)
    jmod, params, tmod = _attention_pair({**ATTENTION_CASES[case], "fused_mask_select": True}, x, **call)
    fused, _ = jmod.apply({"params": params}, x, **call)
    per_mask, _ = jmod.clone(fused_mask_select=False).apply({"params": params}, x, **call)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(per_mask))
    with torch.no_grad():
        close(fused, tmod(t(x), **tcall))


@pytest.mark.parametrize("one_kv_head", [True, False], ids=["mqa", "mha"])
def test_attention_ring_cache_fused_mask_select(one_kv_head):
    """The ring cache's masks (key validity, causality, the key mask) in one
    select, against JAX's fused path over single steps that wrap a 6-slot
    ring."""
    kw = dict(one_kv_head=one_kv_head, causal=True, alibi_pos_bias=True, fused_mask_select=True)
    x = rand(12, 2, 9, 16)
    jmod, params, tmod = _attention_pair(kw, x[:, :4])
    kv = 8 if one_kv_head else 24
    jcache, tcache = jattention.init_kv_cache(2, 6, kv), tattention.init_kv_cache(2, 6, kv)
    mask = np.ones((2, 6), bool)
    for i in range(8):
        want, jcache = jmod.apply({"params": params}, x[:, i : i + 1], mask=mask, cache=jcache, cache_index=i)
        with torch.no_grad():
            got = tmod(t(x[:, i : i + 1]), mask=t(mask), cache=tcache, cache_index=torch.tensor([i]))
        close(want, got)


@pytest.mark.parametrize("one_kv_head", [True, False])
def test_attention_ring_cache(one_kv_head):
    """A 4-position prefill, then single steps that wrap a 6-slot ring."""
    kw = dict(one_kv_head=one_kv_head, causal=True, alibi_pos_bias=True, alibi_learned=True)
    x = rand(12, 2, 9, 16)
    jmod, params, tmod = _attention_pair(kw, x[:, :4])
    kv = 8 if one_kv_head else 24
    jcache = jattention.init_kv_cache(2, 6, kv)
    tcache = tattention.init_kv_cache(2, 6, kv)
    steps = [(0, 4)] + [(i, 1) for i in range(4, 9)]
    for idx, n in steps:
        want, jcache = jmod.apply({"params": params}, x[:, idx : idx + n], cache=jcache, cache_index=idx)
        with torch.no_grad():
            got = tmod(t(x[:, idx : idx + n]), cache=tcache, cache_index=torch.tensor([idx]))
        close(want, got)
        close(jcache["k"], tcache["k"])  # written in place
        close(jcache["v"], tcache["v"])


CHUNK, CAP = 16, 48


def _chunked_caches(kv, cache_dtype, base, seed=14):
    """A written prefix and fresh buffers for one chunked decode step, as
    the JAX decode holds them: fp32, bf16, or int8 rows with their scales
    (JAX's `quantize_kv_rows`); fresh buffers in the cache's type, fp32
    under int8. Returns (JAX cache, port cache)."""
    rng = np.random.RandomState(seed)
    pk, pv = rng.randn(2, CAP, 2, kv).astype(np.float32)
    fk, fv = rng.randn(2, CHUNK, 2, kv).astype(np.float32)
    if cache_dtype == "int8":
        (qk, sk), (qv, sv) = jattention.quantize_kv_rows(jnp.asarray(pk)), jattention.quantize_kv_rows(jnp.asarray(pv))
        jcache = {"k": qk, "k_s": sk, "v": qv, "v_s": sv}
        fresh = jnp.float32
    else:
        fresh = jnp.dtype(cache_dtype)
        jcache = {"k": jnp.asarray(pk, fresh), "v": jnp.asarray(pv, fresh)}
    jcache.update(fk=jnp.asarray(fk, fresh), fv=jnp.asarray(fv, fresh), base=base)
    tcache = {k: (v if k == "base" else torch.from_numpy(np.array(v.astype(jnp.float32)))
                  .to(getattr(torch, str(v.dtype)))) for k, v in jcache.items()}
    return jcache, tcache


@pytest.mark.parametrize("one_kv_head", [True, False], ids=["mqa", "mha"])
@pytest.mark.parametrize("base", [0, CHUNK, 2 * CHUNK], ids=["base0", "base_chunk", "base_mid"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_attention_chunked_cache(cache_dtype, base, one_kv_head):
    """One chunked decode step: the port's prefix_attend + fresh half +
    logsumexp combine against the JAX module's single softmax over
    [prefix | fresh], with fp32, bf16 and int8 prefix caches; the step's
    rows land in the fresh buffers in place."""
    kw = dict(one_kv_head=one_kv_head, causal=True, alibi_pos_bias=True, alibi_learned=True)
    x = rand(15, 2, 1, 16)
    jmod, params, tmod = _attention_pair(kw, x)
    jcache, tcache = _chunked_caches(8 if one_kv_head else 24, cache_dtype, base)
    idx = base + 5
    want, new = jmod.apply({"params": params}, x, cache=jcache, cache_index=idx)
    with torch.no_grad():
        got = tmod(t(x), cache=tcache, cache_index=torch.tensor([idx]))
    close(want, got)
    for key in ("fk", "fv"):  # written in place
        close(new[key].astype(jnp.float32), tcache[key].float())


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("base", [0, 2 * CHUNK], ids=["base0", "base_mid"])
@pytest.mark.parametrize("heads,dim_head", [(2, 16), (8, 128)], ids=["h2_d16", "h8_d128"])
def test_attention_chunked_cache_at_the_recipes_head_dims(heads, dim_head, base, cache_dtype):
    """test_attention_chunked_cache at the head counts and dims of the
    decoders of recipes/smoke.yaml (2 of 16) and
    recipes/scoreperformer/scale_1024.yaml (8 of 128), one KV head."""
    kw = dict(one_kv_head=True, causal=True, alibi_pos_bias=True, alibi_learned=True)
    x = rand(15, 2, 1, 16)
    jmod, params, tmod = _attention_pair(kw, x, heads=heads, dim_head=dim_head)
    jcache, tcache = _chunked_caches(dim_head, cache_dtype, base)
    idx = base + 5
    want, new = jmod.apply({"params": params}, x, cache=jcache, cache_index=idx)
    with torch.no_grad():
        got = tmod(t(x), cache=tcache, cache_index=torch.tensor([idx]))
    close(want, got)
    for key in ("fk", "fv"):  # written in place
        close(new[key].astype(jnp.float32), tcache[key].float())


def test_attention_chunked_cache_folds_max_attend_and_rejects_row_masks():
    """`max_attend` folds into the prefix bias; a key mask that differs
    between batch rows cannot, and raises."""
    kw = dict(one_kv_head=True, causal=True, alibi_pos_bias=True, max_attend=20)
    x = rand(16, 2, 1, 16)
    jmod, params, tmod = _attention_pair(kw, x)
    jcache, tcache = _chunked_caches(8, "float32", 2 * CHUNK)
    want, _ = jmod.apply({"params": params}, x, cache=jcache, cache_index=2 * CHUNK + 3)
    with torch.no_grad():
        close(want, tmod(t(x), cache=tcache, cache_index=torch.tensor([2 * CHUNK + 3])))
        with pytest.raises(NotImplementedError):
            tmod(t(x), mask=torch.ones(2, CAP + CHUNK, dtype=torch.bool), cache=tcache,
                 cache_index=torch.tensor([2 * CHUNK + 3]))


@pytest.mark.parametrize("kind", ["mask", "attn_mask"])
def test_attention_chunked_cache_folds_shared_masks(kind):
    """A key mask or attn_mask shared by the batch rows folds into the one
    bias over [prefix | fresh]: keys it drops from both halves, the query's
    own slot kept."""
    kw = dict(one_kv_head=True, causal=True, alibi_pos_bias=True, alibi_learned=True)
    x = rand(17, 2, 1, 16)
    jmod, params, tmod = _attention_pair(kw, x)
    jcache, tcache = _chunked_caches(8, "float32", 2 * CHUNK)
    idx = 2 * CHUNK + 5
    # (batch 1, keys) as a key mask, (query row, keys) as an attn_mask
    keep = np.random.RandomState(18).rand(1, CAP + CHUNK) > 0.3
    keep[0, CAP + 5] = True
    want, _ = jmod.apply({"params": params}, x, cache=jcache, cache_index=idx, **{kind: jnp.asarray(keep)})
    with torch.no_grad():
        got = tmod(t(x), cache=tcache, cache_index=torch.tensor([idx]), **{kind: torch.from_numpy(keep)})
    close(want, got)


# ---- guards ----


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "scoreperformer_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py", root / "chip_probe_flash_bwd.py", root / "chip_probe_flash_fwd_bf16.py",
        root / "chip_probe_flash_fwd.py", root / "chip_probe_decode.py", root / "chip_probe_head_shapes.py",
        root / "chip_probe_recipe_shapes.py", root / "chip_probe_precision.py"]
    assert len(files) > 20
    names = {str(p.relative_to(root)) for p in files}
    for serving in ("inference/server.py", "serve.py", "render.py", "ops/prefix_attend.py"):
        assert f"scoreperformer_tpu_torch/{serving}" in names
    for paper in ("models/classifiers.py", "data/prepare.py", "data/musicxml_directions.py", "data/music_constants.py",
                  "prepare_dataset.py", "training/tensorboard.py"):
        assert f"scoreperformer_tpu_torch/{paper}" in names
    for streaming in ("inference/generator.py", "inference/messengers.py", "examples/interactive_streaming.py",
                      "examples/train_render_lifecycle.py"):
        assert f"scoreperformer_tpu_torch/{streaming}" in names
    for performer in ("data/performance.py", "models/wrappers.py", "ops/sampling.py"):
        assert f"scoreperformer_tpu_torch/{performer}" in names
    for module in ("models/moe.py", "ops/tokenizer_ops.py", "utils/plots.py", "utils/playback.py"):
        assert f"scoreperformer_tpu_torch/{module}" in names
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "scoreperformer_tpu"), f"{path} imports {name}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from scoreperformer_tpu_torch.inference import load_model_from_checkpoint, render_performance
    from scoreperformer_tpu_torch.models.scoreperformer import ScorePerformerModel
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scoreperformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScorePerformerModel(build_scoreperformer_config(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model_from_checkpoint(str(tmp_path / "model.pt"))
    port, _ = build_scoreperformer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_performance(port, None, None)
    # training: the components and `python -m scoreperformer_tpu_torch.train`
    from scoreperformer_tpu_torch import train
    from scoreperformer_tpu_torch.training import ExperimentComponents

    with pytest.raises(RuntimeError, match="CUDA"):
        ExperimentComponents(config={})
    recipes = Path(__file__).resolve().parents[1] / "recipes"
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["-r", str(recipes), "-n", "scoreperformer/no_classifiers.yaml"])

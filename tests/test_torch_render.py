"""The port's decode loop and render path against the JAX package's, on the CPU.

Greedy decoding must give IDENTICAL tokens: the same weights and inputs go
through `mixedlm_unmask` (chunked and classic) and through the whole
`render_performance` of both packages. Sampling cannot share JAX's random
stream; it is checked by its limits (near-zero temperature is greedy) and by
what it may touch.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from scoreperformer_tpu.data.synthetic import synthetic_score as jax_synthetic_score
from scoreperformer_tpu.inference.render import render_performance as jax_render
from scoreperformer_tpu.models.wrappers import mixedlm_unmask as jax_unmask
from scoreperformer_tpu.tokenizers import SPMupleWindow as JaxTokenizer
from scoreperformer_tpu.tokenizers import TokenizerConfig as JaxTokenizerConfig
from scoreperformer_tpu.training.torch_convert import export_reference_state_dict

from scoreperformer_tpu_torch.data import synthetic_score
from scoreperformer_tpu_torch.inference import load_model_from_checkpoint, render_performance
from scoreperformer_tpu_torch.models.wrappers import NEG_INF, batched_column_mask, batched_top_k, mixedlm_unmask
from scoreperformer_tpu_torch.ops.sampling import top_k
from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_port_modules", Path(__file__).with_name("test_torch_modules.py")
)
tm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tm)

T = 37  # 36 steps: two full chunks of 16 and a padded third


@pytest.fixture(scope="module")
def pair():
    return tm.build_pair(tm.tiny_config(use_flash=True), tm.make_inputs())


def decode_inputs(seed=21, b=2):
    rng = np.random.RandomState(seed)
    tokens = np.stack([rng.randint(4, v, (b, T)) for v in tm.NUM_TOKENS.values()], -1).astype(np.int32)
    masked = tokens.copy()
    masked[..., tm.PERF_DIMS] = 1
    tokens_in = tokens.copy()
    tokens_in[:, 1:, tm.PERF_DIMS] = 1
    return {
        "tokens": tokens_in, "masked": masked,
        "style": rng.randn(b, T, 20).astype(np.float32) * 0.5,
        "context": rng.randn(b, T, 32).astype(np.float32) * 0.5,
        "valid_len": np.array([T, T - 5], np.int32),
    }


FORBID = {3: [5, 6, 7]}


def port_unmask(port, x, **kw):
    return mixedlm_unmask(
        port, torch.as_tensor(x["tokens"], dtype=torch.int64), torch.as_tensor(x["masked"], dtype=torch.int64),
        style_embeddings=torch.from_numpy(x["style"]), context=torch.from_numpy(x["context"]),
        valid_len=torch.as_tensor(x["valid_len"], dtype=torch.int64),
        forbid_ids={s: torch.tensor(v) for s, v in FORBID.items()}, **kw,
    ).numpy()


def _top_k_per_stream(logits, **kw):
    """`top_k` under another name: selects the per-stream sampling path."""
    return top_k(logits, **kw)


@pytest.mark.parametrize("filter_fn", [top_k, _top_k_per_stream], ids=["batched", "per_stream"])
@pytest.mark.parametrize("chunk_size", [16, None], ids=["chunked16", "classic"])
def test_greedy_mixedlm_unmask_matches_jax(pair, chunk_size, filter_fn):
    model, variables, port = pair
    x = decode_inputs()
    want = jax_unmask(
        model, variables, jnp.asarray(x["tokens"]), jnp.asarray(x["masked"]), jax.random.PRNGKey(0),
        style_embeddings=jnp.asarray(x["style"]), context=jnp.asarray(x["context"]),
        valid_len=jnp.asarray(x["valid_len"]), greedy=True, chunk_size=chunk_size,
        forbid_ids={s: jnp.asarray(v) for s, v in FORBID.items()},
    )
    got = port_unmask(port, x, greedy=True, chunk_size=chunk_size, filter_fn=filter_fn)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the padded second sequence keeps its masks past valid_len
    assert (got[1, T - 4:, tm.PERF_DIMS[0]] == 1).all()


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_greedy_mixedlm_unmask_cache_dtypes_match_jax(pair, cache_dtype):
    """Chunked greedy decoding over fp32, bf16 and int8 (quantized once per
    chunk at the merge) caches: the same tokens as JAX's with that cache."""
    model, variables, port = pair
    x = decode_inputs(seed=22)
    want = jax_unmask(
        model, variables, jnp.asarray(x["tokens"]), jnp.asarray(x["masked"]), jax.random.PRNGKey(0),
        style_embeddings=jnp.asarray(x["style"]), context=jnp.asarray(x["context"]),
        valid_len=jnp.asarray(x["valid_len"]), greedy=True, cache_dtype=jnp.dtype(cache_dtype),
        forbid_ids={s: jnp.asarray(v) for s, v in FORBID.items()}, sample_dims=tm.PERF_DIMS,
    )
    got = port_unmask(port, x, greedy=True, cache_dtype=getattr(torch, cache_dtype), sample_dims=tm.PERF_DIMS)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_int8_cache_needs_the_chunked_decode(pair):
    _, _, port = pair
    with pytest.raises(ValueError, match="chunked"):
        port_unmask(port, decode_inputs(), greedy=True, cache_dtype=torch.int8, chunk_size=None)


def test_per_row_temperature(pair):
    """A (b,) temperature tensor applies row by row: a near-zero row decodes
    greedily while the other samples; equal values match the scalar."""
    _, _, port = pair
    x = decode_inputs()
    greedy = port_unmask(port, x, greedy=True)

    def sampled(temperature, seed=3):
        return port_unmask(port, x, generator=torch.Generator().manual_seed(seed), temperature=temperature,
                           sample_dims=tm.PERF_DIMS)

    mixed = sampled(torch.tensor([1e-7, 5.0]))
    np.testing.assert_array_equal(mixed[0], greedy[0])
    assert (mixed[1] != greedy[1]).any()
    np.testing.assert_array_equal(sampled(torch.tensor([0.7, 0.7])), sampled(0.7))


def test_sampling_fills_only_masked_slots_and_respects_forbids(pair):
    _, _, port = pair
    x = decode_inputs()
    gen = torch.Generator().manual_seed(0)
    got = port_unmask(port, x, generator=gen, filter_kwargs={"k": 5}, sample_dims=tm.PERF_DIMS)
    masked_slots = x["tokens"] == 1
    np.testing.assert_array_equal(got[~masked_slots], x["tokens"][~masked_slots])
    filled = got[0][masked_slots[0]]
    assert (filled > 1).all()  # neither PAD nor MASK
    assert not np.isin(got[:, 1:, 3], FORBID[3]).any()


@pytest.mark.parametrize("sample_dims", [None, tm.PERF_DIMS], ids=["batched", "per_stream"])
def test_near_zero_temperature_sampling_is_greedy(pair, sample_dims):
    _, _, port = pair
    x = decode_inputs()
    greedy = port_unmask(port, x, greedy=True)
    gen = torch.Generator().manual_seed(1)
    sampled = port_unmask(port, x, generator=gen, temperature=1e-7, sample_dims=sample_dims)
    np.testing.assert_array_equal(sampled, greedy)


@pytest.mark.parametrize("kw", [{"thres": 0.9}, {"thres": 0.5}, {"k": 3}])
def test_batched_top_k_matches_per_stream_top_k(kw):
    """The stacked filter keeps, per stream, exactly what `top_k` keeps on
    that stream alone (ties included); PAD/MASK/forbidden/padded columns stay out."""
    rng = np.random.RandomState(4)
    sizes = list(tm.NUM_TOKENS.values())
    logits = [torch.from_numpy(np.round(rng.randn(3, V) * 2).astype(np.float32) / 2) for V in sizes]
    col_mask = batched_column_mask(sizes, 0, 1, {3: torch.tensor([5, 6])})
    stacked = torch.stack([F.pad(l, (0, max(sizes) - l.shape[-1]), value=NEG_INF) for l in logits], 1) + col_mask
    ks = [max(1, min(kw["k"], V)) if "k" in kw else math.ceil((1 - kw["thres"]) * V) for V in sizes]
    got = batched_top_k(stacked, torch.tensor(ks))
    for s, (lg, V) in enumerate(zip(logits, sizes)):
        lg = lg.clone()
        lg[:, [0, 1]] = NEG_INF
        if s == 3:
            lg[:, [5, 6]] = NEG_INF
        want = top_k(lg, **kw)
        np.testing.assert_array_equal(got[:, s, :V].numpy() > NEG_INF / 2, want.numpy() > NEG_INF / 2)


def _render_config(tokenizer, n_notes):
    token_values = {k: v.tolist() for k, v in tokenizer.token_values(normalize=True).items()}
    return tm.tiny_config(use_flash=True, num_tokens=tokenizer.performance_sizes,
                          score_tokens=tokenizer.score_sizes, token_values=token_values,
                          max_segments=n_notes + 4)


def test_render_performance_matches_jax(tmp_path):
    """A 4-bar synthetic score through both packages' render, greedy: the
    same notes, velocities and timings."""
    ap = {"max_bar_embedding": 32}
    jtok, ttok = JaxTokenizer(JaxTokenizerConfig(additional_params=ap)), SPMupleWindow(TokenizerConfig(additional_params=ap))
    jscore, tscore = jax_synthetic_score(np.random.RandomState(3), n_bars=4), synthetic_score(np.random.RandomState(3), n_bars=4)
    n_notes = len(ttok.score_midi_to_tokens(tscore).ids)
    cfg = _render_config(ttok, n_notes)

    rng = np.random.RandomState(0)
    sizes = list(ttok.performance_sizes.values())
    inputs = tm.make_inputs()
    inputs["perf"] = np.stack([rng.randint(4, v, (2, 12)) for v in sizes], -1).astype(np.int32)
    inputs["masked"] = inputs["perf"].copy()
    inputs["score"] = inputs["perf"][..., : len(ttok.score_sizes)].copy()
    model, variables, port = tm.build_pair(cfg, inputs)

    want = jax_render(model, variables, jtok, jscore, rng=jax.random.PRNGKey(0), greedy=True)
    got = render_performance(port, ttok, tscore, greedy=True, device="cpu",
                             output_path=str(tmp_path / "performance.mid"))
    assert got.num_notes == want.num_notes > 0
    w, g = want.all_notes(), got.all_notes()
    for field in ("pitch", "velocity", "start", "end"):
        np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    assert (tmp_path / "performance.mid").exists()


def test_load_model_from_reference_checkpoint(pair, tmp_path):
    """A reference single-file checkpoint (reference names, torch tensors)
    loads into the port with every weight in place."""
    model, variables, port = pair
    sd = export_reference_state_dict(jax.device_get(variables["params"]))
    cfg = {"_name_": "ScorePerformer", **tm.tiny_config(use_flash=True)}
    path = tmp_path / "model.pt"
    torch.save({"model": {"config": cfg, "state_dict": {k: torch.tensor(np.array(v)) for k, v in sd.items()}}}, path)
    loaded, _ = load_model_from_checkpoint(str(path), device="cpu")
    want, got = port.state_dict(), loaded.state_dict()
    assert list(want) == list(got)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)

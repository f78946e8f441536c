"""The chunked decode's variants against the JAX package and the classic path.

tests/test_models.py:561-765 holds the JAX package's variants of the chunked
`mixedlm_unmask` to its classic scan; here the port's `static_prefix`,
`unrolled_chunks` (with and without a static prefix), `capacity_stages` and
`chunk_tokens` (rows), with chunk sizes that do not divide the step count
and stage counts that do not divide the chunk count, give the port's classic
greedy tokens, which are JAX's classic tokens, on tests/test_torch_modules.py's
tiny model (T = 37: 36 steps); one variant of each kind (static prefix,
stages, rows) is also run through JAX's variant itself (JAX compiles its
unrolled loops for seconds a chunk). Int8 caches keep JAX's gate (agreement
with fp32 >= 0.95 on filled positions, no MASK or PAD filled, untouched
positions identical) and JAX's tokens; `valid_len` leaves the padded positions as they
are and decodes the rest as the truncated sequence; a bf16 prefix with fp32
fresh buffers agrees on > 0.97. Each variant attends over the prefix
capacity JAX's gives it (static prefix: cap = base, nothing launched in the
first chunk; stages: the stage's rows).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.models.wrappers import mixedlm_unmask as jax_unmask

from scoreperformer_tpu_torch.models import attention
from scoreperformer_tpu_torch.models.wrappers import mixedlm_unmask

torch.set_num_threads(1)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"unmask_variants_{name}", Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tm = _load("test_torch_modules")
tr = _load("test_torch_render")
T = tr.T

VARIANTS = {
    "static_prefix_8": dict(chunk_size=8, static_prefix=True),
    "static_prefix_5": dict(chunk_size=5, static_prefix=True),
    "unrolled_8": dict(chunk_size=8, unrolled_chunks=True),
    "unrolled_5": dict(chunk_size=5, unrolled_chunks=True),
    "unrolled_static_prefix_8": dict(chunk_size=8, unrolled_chunks=True, static_prefix=True),
    "stages_8x2": dict(chunk_size=8, capacity_stages=2),
    "stages_5x3": dict(chunk_size=5, capacity_stages=3),
    "rows_8": dict(chunk_size=8, chunk_tokens=True),
    "rows_5": dict(chunk_size=5, chunk_tokens=True),
    "rows_stages_8x2": dict(chunk_size=8, chunk_tokens=True, capacity_stages=2),
}


@pytest.fixture(scope="module")
def pair():
    return tm.build_pair(tm.tiny_config(use_flash=True), tm.make_inputs())


@pytest.fixture(scope="module")
def inputs():
    return tr.decode_inputs()


@pytest.fixture(scope="module")
def classic(pair, inputs):
    return tr.port_unmask(pair[2], inputs, greedy=True, chunk_size=None)


def jax_tokens(pair, x, **kw):
    model, variables, _ = pair
    if "cache_dtype" in kw:
        kw["cache_dtype"] = getattr(jnp, kw["cache_dtype"])
    return np.asarray(jax_unmask(
        model, variables, jnp.asarray(x["tokens"]), jnp.asarray(x["masked"]), jax.random.PRNGKey(0),
        style_embeddings=jnp.asarray(x["style"]), context=jnp.asarray(x["context"]),
        valid_len=jnp.asarray(x["valid_len"]), forbid_ids={s: jnp.asarray(v) for s, v in tr.FORBID.items()},
        greedy=True, **kw))


def port_tokens(pair, x, **kw):
    if "cache_dtype" in kw:
        kw["cache_dtype"] = getattr(torch, kw["cache_dtype"])
    if "fresh_dtype" in kw:
        kw["fresh_dtype"] = getattr(torch, kw["fresh_dtype"])
    return tr.port_unmask(pair[2], x, greedy=True, **kw)


JAX_CHECKED = ("static_prefix_8", "stages_8x2", "rows_8")


def test_the_classic_tokens_are_jax_classic_tokens(pair, inputs, classic):
    np.testing.assert_array_equal(classic, jax_tokens(pair, inputs, chunk_size=None))
    assert (classic != inputs["tokens"]).any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_gives_the_classic_tokens(pair, inputs, classic, variant):
    got = port_tokens(pair, inputs, **VARIANTS[variant])
    np.testing.assert_array_equal(got, classic)
    if variant in JAX_CHECKED:
        np.testing.assert_array_equal(got, jax_tokens(pair, inputs, **VARIANTS[variant]))


@pytest.mark.parametrize("extra,jax_checked", [
    (dict(chunk_size=8), True), (dict(chunk_size=5), False), (dict(chunk_size=8, capacity_stages=2), True),
    (dict(chunk_size=8, static_prefix=True), False), (dict(chunk_size=5, chunk_tokens=True), False),
], ids=["chunk8", "chunk5", "stages_8x2", "static_prefix_8", "rows_5"])
def test_int8_caches_keep_the_jax_gate(pair, inputs, classic, extra, jax_checked):
    """JAX's gate (tests/test_models.py:657-695), and JAX's own int8 tokens
    where marked."""
    q = port_tokens(pair, inputs, cache_dtype="int8", **extra)
    filled = inputs["tokens"] == 1
    filled[1, inputs["valid_len"][1]:] = False  # past valid_len nothing is filled
    assert np.all((q[filled] != 1) & (q[filled] != 0)), extra
    assert (q[filled] == classic[filled]).mean() >= 0.95
    np.testing.assert_array_equal(q[~filled], classic[~filled])
    if jax_checked:
        np.testing.assert_array_equal(q, jax_tokens(pair, inputs, cache_dtype="int8", **extra))


@pytest.mark.parametrize("extra", [dict(chunk_size=8, chunk_tokens=True), dict(chunk_size=5, static_prefix=True),
                                   dict(chunk_size=5, capacity_stages=3)], ids=["rows_8", "static_prefix_5", "stages_5x3"])
def test_valid_len_semantics(pair, inputs, extra):
    """Positions at or past a row's valid_len stay as they are, and the
    decoded prefix of the padded row equals the truncated sequence's."""
    v = 20
    x = {**inputs, "valid_len": np.array([T, v], np.int32)}
    out = port_tokens(pair, x, **extra)
    np.testing.assert_array_equal(out[1, v:], x["tokens"][1, v:])
    short = {k: x[k][:, :v] for k in ("tokens", "masked", "style", "context")} | {"valid_len": np.array([v, v], np.int32)}
    np.testing.assert_array_equal(out[1, :v], port_tokens(pair, short, **extra)[1])


@pytest.mark.parametrize("extra", [dict(chunk_size=8), dict(chunk_size=8, static_prefix=True),
                                   dict(chunk_size=8, chunk_tokens=True)], ids=["chunk8", "static_prefix_8", "rows_8"])
def test_bf16_prefix_with_fp32_fresh_buffers(pair, inputs, classic, extra):
    mixed = port_tokens(pair, inputs, cache_dtype="bfloat16", fresh_dtype="float32", **extra)
    assert (mixed == classic).mean() > 0.97


@pytest.mark.parametrize("variant,caps", [
    ("static_prefix_8", [8, 16, 24, 32]),  # cap = base; the first chunk calls nothing
    ("stages_8x2", [16, 16, 40, 40, 40]),  # 5 chunks in stages of 2 and 3: caches of 16 and 40 rows
    ("stages_5x3", [10, 10, 25, 25, 25, 40, 40, 40]),  # 8 chunks: stages of 2, 3, 3
    ("rows_8", [40] * 5),
    ("unrolled_static_prefix_8", [8, 16, 24, 32]),
])
def test_prefix_attend_runs_at_the_variant_caps(pair, inputs, monkeypatch, variant, caps):
    """The prefix each chunk attends over: `prefix_attend` is called once a
    decoder layer and step, with the cache capacity and `base` that the JAX
    variant's prefix has (the first static chunk calls it no time)."""
    seen = []
    orig = attention.prefix_attend

    def spy(q, pk, pv, bias, k_s=None, v_s=None, n_valid=None):
        seen.append((pk.shape[0], n_valid))
        return orig(q, pk, pv, bias, k_s, v_s, n_valid)

    monkeypatch.setattr(attention, "prefix_attend", spy)
    kw = VARIANTS[variant]
    port_tokens(pair, inputs, **kw)
    C, layers = kw["chunk_size"], 2
    chunks = [(cap, c * C) for c, cap in enumerate(caps, start=len(range(0, T - 1, C)) - len(caps))]
    assert seen == [(cap, base) for cap, base in chunks for _ in range(C * layers)]

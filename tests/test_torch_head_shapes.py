"""Head shapes the kernels are not built for, against the JAX package, on the CPU.

The kernels are built for head dims 16, 32, 64 and 128 and for 1, 2, 4 or 8
query heads a KV head in `prefix_attend`. On the GPU every other head dim up
to 128 runs at the next built width with zero columns, decode caches hold
each head at that width, and `prefix_attend` takes the query heads of one KV
head in groups of 8, the last padded with zero rows (`ops/head_layout.py`).
Here `head_layout.kernel_layout` is forced to say yes on the CPU, so the
same route runs with the plain versions standing in for the kernels:

- the padded flash route against the Pallas kernel in interpret mode and its
  VJP (o and lse 1e-5; dq, dk, dv 1e-5, dslopes 1e-5 * t, as
  tests/test_torch_kernels.py holds the unpadded route; an element with no
  valid key to 1e-5 of its largest value), and against the
  unpadded plain version bit for bit;
- `prefix_attend`'s groups and padded rows against the plain version on all
  heads at once (1e-6), over fp32, bf16 and int8 caches;
- tiny models at 6 heads of 48 (one KV head) and 3 heads of 24 (a KV head
  each): JAX's greedy tokens from `mixedlm_unmask` (chunked and classic;
  fp32, bf16 and int8 caches), the streaming generator's windows and the
  Performer's `ar_generate`, and one train step of the d = 48 model against
  `jax.value_and_grad` (loss 1e-5, gradients 1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.models.wrappers import mixedlm_unmask as jax_unmask
from scoreperformer_tpu.ops import flash_attention as jflash
from scoreperformer_tpu.ops.flash_attention import _flash_forward

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.ops import flash_attention as tflash
from scoreperformer_tpu_torch.ops import head_layout
from scoreperformer_tpu_torch.ops import prefix_attend as tprefix

import test_torch_performer as tp
import test_torch_streaming as ts
from test_torch_flash_head_dims import shaped_config
from test_torch_modules import build_pair, make_inputs, tiny_config
from test_torch_render import FORBID, decode_inputs, port_unmask
from test_torch_train import GRAD_TOL, jax_step, port_batch, replay, train_batch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# heads, dim_head, one KV head
SHAPES = {"h6_d48_mqa": (6, 48, True), "h3_d24_mha": (3, 24, False)}


@pytest.fixture
def kernel_layout(monkeypatch):
    """The kernels' head layout on CPU tensors: padded widths, head groups."""
    monkeypatch.setattr(head_layout, "kernel_layout", lambda device: True)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_kernel_head_dim_is_the_next_built_width():
    assert [head_layout.kernel_head_dim(d) for d in (1, 8, 16, 17, 24, 32, 33, 48, 64, 65, 96, 128)] == [
        16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 128]
    assert head_layout.head_width(48, "cpu") == 48
    with pytest.raises(ValueError, match="ROADMAP.md"):
        head_layout.kernel_head_dim(129)


# ---- the padded flash route ----

FLASH_CASES = [
    # b, h, t, d, hk, causal, padded ("empty": batch element 0 has no valid key)
    (2, h, t, d, hk, causal, padded)
    for i, (d, (h, hk)) in enumerate((d, hh) for d in (8, 24, 48, 96)
                                     for hh in ((3, 1), (6, 1), (12, 1), (3, 3), (6, 6), (12, 12)))
    for t, causal, padded in [((37, 20, 29)[i % 3], i % 2 == 0, (False, True, "empty")[i % 3])]
]


def flash_inputs(b, h, t, d, hk, padded):
    q, k, v = rand(2, b, h, t, d), rand(3, b, hk, t, d), rand(4, b, hk, t, d)
    slopes = np.abs(rand(5, h)) * 0.5
    mask = np.ones((b, t), bool)
    if padded:
        lengths = np.random.RandomState(6).randint(1, t + 1, b)
        if padded == "empty":
            lengths[0] = 0
        mask = np.arange(t)[None] < lengths[:, None]
    return q, k, v, slopes, mask


def flash_both_ways(monkeypatch, q, k, v, slopes, mask, dout, causal):
    """(o, lse, dq, dk, dv, dslopes) of the route at q's head dim and of the
    padded route (the kernels' layout forced)."""
    runs = []
    for padded in (False, True):
        if padded:
            monkeypatch.setattr(head_layout, "kernel_layout", lambda device: True)
        args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, slopes)]
        tmask = torch.from_numpy(mask)
        out = tflash.flash_attention_alibi(*args, mask=tmask, causal=causal)
        out.backward(torch.from_numpy(dout))
        o, lse = tflash.flash_attention_fwd(*(a.detach() for a in args), mask=tmask, causal=causal)
        runs.append([o, lse] + [a.grad for a in args])
        assert torch.equal(out.detach(), o)
    return runs


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_padded_flash_route_matches_pallas_and_the_plain_version(monkeypatch, b, h, t, d, hk, causal, padded):
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
    plain, got = flash_both_ways(monkeypatch, q, k, v, slopes, mask, dout, causal)
    assert got[0].shape == (b, h, t, d) and got[2].shape == q.shape and got[3].shape == k.shape
    for name, p, g in zip(("o", "lse", "dq", "dk", "dv", "dslopes"), plain, got):
        assert torch.equal(p, g), f"{name}: the padded route differs from the plain version's bits"
    want_o, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes),
        jnp.asarray(mask, jnp.float32), causal, d**-0.5, 256, 256, True, "highest", return_lse=True,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_o), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)
    _, vjp = jax.vjp(
        lambda *a: jflash.flash_attention_alibi(*a, mask=jnp.asarray(mask), causal=causal,
                                                interpret=True, precision="highest"),
        *map(jnp.asarray, (q, k, v, slopes)),
    )
    want = vjp(jnp.asarray(dout))
    for name, w, g in zip(("dq", "dk", "dv"), want, got[2:5]):
        w, g = np.asarray(w), g.numpy()
        if padded == "empty":  # P = 1 on that element: unnormalized sums (tests/test_torch_kernels.py)
            atol = 1e-5 * max(1.0, float(np.abs(w[0]).max()))
            np.testing.assert_allclose(g[0], w[0], atol=atol, rtol=1e-5, err_msg=f"{name}, empty element")
            w, g = w[1:], g[1:]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
    # dslopes to 1e-5 * t; with an element that has no valid key its terms
    # are unnormalized too (P = 1 on up to 256 keys): to 1e-5 of its largest
    want_dslopes = np.asarray(want[3])
    atol = 1e-5 * (max(t, float(np.abs(want_dslopes).max())) if padded == "empty" else t)
    np.testing.assert_allclose(got[5].numpy(), want_dslopes, atol=atol, rtol=1e-5)


def test_head_dims_above_128_raise(kernel_layout):
    q, k, v, slopes, _ = flash_inputs(1, 2, 9, 129, 1, False)
    with pytest.raises(ValueError, match="up to 128"):
        tflash.flash_attention_fwd(*map(torch.from_numpy, (q, k, v, slopes)))
    with pytest.raises(ValueError, match="up to 128"):
        tflash.flash_attention_alibi(*map(torch.from_numpy, (q, k, v, slopes)))


# ---- prefix_attend: head groups and padded rows ----


def padded_cache(x, kvh, width):
    """(cap, b, kvh * d) -> (cap, b, kvh * width), each head's columns past
    d zero."""
    cap, b, kv = x.shape
    return head_layout.pad_head_dim(x.reshape(cap, b, kvh, kv // kvh), width).flatten(2)


PREFIX_HEADS = [(3, 1), (5, 1), (6, 1), (12, 1), (16, 1), (12, 12)]


@pytest.mark.parametrize("n_valid", ["none", "partial", "full"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("h,kvh", PREFIX_HEADS, ids=[f"h{h}_kvh{k}" for h, k in PREFIX_HEADS])
@pytest.mark.parametrize("d", [8, 48])
def test_prefix_attend_groups_and_padded_rows_match_one_plain_call(kernel_layout, monkeypatch, d, h, kvh, dtype,
                                                                   n_valid):
    b, cap = 3, 40
    width = head_layout.kernel_head_dim(d)
    rng = np.random.RandomState(h * 100 + d)
    q = torch.from_numpy((rng.randn(b, h, d) * d**-0.5).astype(np.float32))
    pk, pv = torch.from_numpy(rng.randn(2, cap, b, kvh * d).astype(np.float32))
    bias = torch.from_numpy((-np.abs(rng.randn(h, cap)) * 2).astype(np.float32))
    k_s = v_s = None
    if dtype == "int8":
        from scoreperformer_tpu_torch.models.attention import quantize_kv_rows
        (pk, k_s), (pv, v_s) = quantize_kv_rows(pk), quantize_kv_rows(pv)
    elif dtype == "bf16":
        pk, pv = pk.bfloat16(), pv.bfloat16()
    n = {"none": 0, "partial": 23, "full": cap}[n_valid]
    want_o, want_lse = tprefix.prefix_attend_plain(q, pk, pv, bias, k_s, v_s, n_valid=n)
    launches = []
    attend = tprefix._attend

    def spy(q, *a, **kw):
        launches.append(tuple(q.shape))
        return attend(q, *a, **kw)

    monkeypatch.setattr(tprefix, "_attend", spy)
    got_o, got_lse = tprefix.prefix_attend(q, padded_cache(pk, kvh, width), padded_cache(pv, kvh, width), bias,
                                           k_s, v_s, n_valid=n)
    groups = [min(8, h - g) for g in range(0, h, 8)] if kvh == 1 else [h]
    assert launches == [(b, h if kvh == h else next(r for r in (1, 2, 4, 8) if r >= g), width) for g in groups]
    assert got_o.shape == (b, h, d) and got_lse.shape == (b, h)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=1e-6)


def test_prefix_attend_refuses_a_cache_at_the_head_dim(kernel_layout):
    q, cache, bias = torch.zeros(1, 2, 48), torch.zeros(4, 1, 48), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="64 columns a head"):
        tprefix.prefix_attend(q, cache, cache, bias)


# ---- tiny models at 6 heads of 48 (one KV head) and 3 heads of 24 ----


def shaped_tiny(heads, dim_head, one_kv_head, cfg=None, use_flash=True):
    """`cfg` (tests/test_torch_modules.py's tiny_config by default) with
    every stack at `heads` heads of `dim_head`."""
    cfg = cfg or tiny_config(use_flash=use_flash)
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        stack = cfg[key]["transformer"]
        stack.update(heads=heads, attention={**stack["attention"], "dim_head": dim_head, "one_kv_head": one_kv_head})
    return cfg


@pytest.fixture(scope="module", params=list(SHAPES), ids=list(SHAPES))
def shaped(request):
    return request.param, build_pair(shaped_tiny(*SHAPES[request.param]), make_inputs())


def cache_width(port, shape):
    heads, dim_head, one_kv_head = SHAPES[shape]
    width = head_layout.kernel_head_dim(dim_head)
    layer = next(c for c in port.init_decoder_cache(1, 4) if c is not None)
    assert layer["k"].shape[2] == width * (1 if one_kv_head else heads)
    return width


@pytest.mark.parametrize("chunk_size,cache_dtype", [(16, "float32"), (16, "bfloat16"), (16, "int8"),
                                                    (None, "float32"), (None, "bfloat16")])
def test_greedy_mixedlm_unmask_in_the_padded_layout_matches_jax(kernel_layout, monkeypatch, shaped, chunk_size,
                                                                 cache_dtype):
    shape, (model, variables, port) = shaped
    width = cache_width(port, shape)
    heads, _, one_kv_head = SHAPES[shape]
    launches = []
    attend = tprefix._attend
    monkeypatch.setattr(tprefix, "_attend", lambda q, *a, **kw: launches.append(tuple(q.shape[1:])) or attend(
        q, *a, **kw))
    x = decode_inputs(seed=23)
    want = jax_unmask(
        model, variables, jnp.asarray(x["tokens"]), jnp.asarray(x["masked"]), jax.random.PRNGKey(0),
        style_embeddings=jnp.asarray(x["style"]), context=jnp.asarray(x["context"]),
        valid_len=jnp.asarray(x["valid_len"]), greedy=True, chunk_size=chunk_size,
        cache_dtype=jnp.dtype(cache_dtype), forbid_ids={s: jnp.asarray(v) for s, v in FORBID.items()},
    )
    got = port_unmask(port, x, greedy=True, chunk_size=chunk_size, cache_dtype=getattr(torch, cache_dtype))
    np.testing.assert_array_equal(got, np.asarray(want))
    if chunk_size is None:
        assert not launches
    else:  # one launch a decoder layer a step past the first chunk, padded to 8 heads over one KV head
        assert launches and set(launches) == {(8 if one_kv_head else heads, width)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_greedy_streaming_windows_in_the_padded_layout_match_jax(kernel_layout, tmp_path, shape):
    pair = ts.Pair(str(tmp_path), shaped_tiny(*SHAPES[shape], ts.tiny_cfg()))
    cache_width(pair.port, shape)
    kw = dict(greedy=True, block_size=32, window=0.5)
    want = ts.drive(pair.jgen, windows=8, **kw)
    got = ts.drive(pair.tgen, windows=8, **kw)
    assert max(w[2] for w in want) > 0, "no window shift"
    ts.assert_same_windows(want, got)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_greedy_ar_generate_in_the_padded_layout_matches_jax(kernel_layout, shape):
    heads, dim_head, one_kv_head = SHAPES[shape]
    cfg = tp.performer_config()
    cfg["transformer"]["transformer"].update(heads=heads)
    cfg["transformer"]["transformer"]["attention"].update(dim_head=dim_head, one_kv_head=one_kv_head)
    model, variables, port = tp.build_pair(cfg, tp.tokens())
    cache_width(port, shape)
    for kw in (dict(seq_len=30), dict(seq_len=30, chunk_size=None), dict(seq_len=70)):  # chunked, classic, ring
        prompt = tp.tokens(seed=9, b=3, t=4)
        want_gen, want_n, got_gen, got_n = tp.ar_pair(model, variables, port, prompt, **kw)
        np.testing.assert_array_equal(got_gen, want_gen, err_msg=str(kw))
        np.testing.assert_array_equal(got_n, want_n, err_msg=str(kw))


def test_train_step_at_heads_of_48_matches_jax(kernel_layout, monkeypatch):
    batch = train_batch(b=2, t=20)
    cfg = shaped_config(32, 6, 48, (1, 1, 1))
    inputs = {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")} | {
        "mask": batch["perf_mask"], "masked": batch["masked_perf"]}
    model, variables, port = build_pair(cfg, inputs)
    loss, losses, grads, draws = jax_step(model, variables["params"], batch, monkeypatch)
    widths = []
    fwd = tflash._fwd
    monkeypatch.setattr(tflash, "_fwd", lambda q, *a: widths.append(q.shape[-1]) or fwd(q, *a))
    port.zero_grad()
    out = port(**port_batch(batch), mmd_sampler=replay(draws))
    out.loss.backward()
    assert widths == [64] * 3  # every flash layer ran at the padded width
    np.testing.assert_allclose(out.loss.item(), float(loss), atol=1e-5, rtol=1e-5)
    for key, value in losses.items():
        np.testing.assert_allclose(out.losses[key].item(), float(value), atol=1e-5, rtol=1e-5, err_msg=key)
    params = dict(port.named_parameters(remove_duplicate=False))
    for name, want in state_dict_from_jax(jax.device_get(grads)).items():
        got = params[name.replace("proj|0", "proj")].grad
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **GRAD_TOL)

"""The port's kernel wrappers against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
`chip_smoke.py`. Inputs come from numpy with a fixed seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.ops import flash_attention as jflash
from scoreperformer_tpu.ops import kv_cache as jkv
from scoreperformer_tpu.ops import sampling as jsampling
from scoreperformer_tpu.ops.flash_attention import _flash_forward

from scoreperformer_tpu_torch.ops import flash_attention as tflash
from scoreperformer_tpu_torch.ops import kv_cache as tkv
from scoreperformer_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- write_kv: exact ----


@pytest.mark.parametrize("index", [0, 3, 6, 7, 100, -2, -9, -30], ids=lambda i: f"index{i}")
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_write_kv_matches_jax_dynamic_update_slice(index, cache_dtype):
    """Rows [index, index+n); a negative start counts from the end, then the
    start is clamped to [0, cap-n]. `new` is cast to the cache's type."""
    cache = rand(0, 10, 3, 8)
    new = rand(1, 3, 3, 8)
    want = jkv.write_kv(jnp.asarray(cache, dtype=cache_dtype), jnp.asarray(new), index)
    tcache = torch.from_numpy(cache.copy()).to(getattr(torch, cache_dtype))
    got = tkv.write_kv(tcache, torch.from_numpy(new), torch.tensor([index]))
    assert got is tcache  # in place
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_write_kv_rejects_rows_that_do_not_fit():
    with pytest.raises(ValueError):
        tkv.write_kv(torch.zeros(2, 1, 4), torch.zeros(3, 1, 4), 0)
    with pytest.raises(ValueError):
        tkv.write_kv(torch.zeros(4, 1, 4), torch.zeros(1, 2, 4), 0)


# ---- flash attention forward: atol 1e-5 against the Pallas kernel ----

FLASH_CASES = [
    # b, h, t, d, hk, causal, padded ("empty": batch element 0 has no valid key)
    (2, 4, 37, 16, 1, False, True),
    (2, 4, 37, 16, 1, True, True),
    (1, 2, 130, 8, 2, False, False),
    (2, 2, 130, 8, 2, True, True),
    (3, 3, 9, 32, 1, True, False),
    (2, 2, 37, 16, 1, False, "empty"),
    (2, 2, 300, 8, 1, True, "empty"),
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


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_flash_plain_matches_pallas_kernel(b, h, t, d, hk, causal, padded):
    """The Pallas kernel in interpret mode at "highest" (fp32) precision;
    output and logsumexp, with ragged t, MQA and MHA, key padding, and rows
    whose keys are all masked (v averaged over the wrapper's padded keys)."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    scale = d**-0.5
    want_o, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes),
        jnp.asarray(mask, jnp.float32), causal, scale, 256, 256, True, "highest", return_lse=True,
    )
    got_o, got_lse = tflash.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v, slopes)), mask=torch.from_numpy(mask),
        causal=causal, scale=scale,
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


# ---- flash attention backward: atol/rtol 1e-5 against the Pallas kernels ----


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_flash_backward_matches_pallas_kernels(b, h, t, d, hk, causal, padded):
    """dq, dk, dv and dslopes of the port's autograd Function (plain forward
    and backward on CPU tensors) against `jax.vjp` of the Pallas kernels in
    interpret mode. dout is zero on rows whose keys are all masked, as the
    attention module makes it (it multiplies those rows by 0): with a nonzero
    dout there, JAX's gradient depends on its wrapper's key padding."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
    none_valid = ~mask.any(-1)
    if causal:
        none_valid = ~(np.cumsum(mask, -1) > 0)  # (b, t): no valid key at or before i
        dout[np.broadcast_to(none_valid[:, None], (b, h, t))] = 0
    else:
        dout[none_valid] = 0
    _, vjp = jax.vjp(
        lambda *a: jflash.flash_attention_alibi(*a, mask=jnp.asarray(mask), causal=causal,
                                                interpret=True, precision="highest"),
        *map(jnp.asarray, (q, k, v, slopes)),
    )
    want = vjp(jnp.asarray(dout))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, slopes)]
    out = tflash.flash_attention_alibi(*args, mask=torch.from_numpy(mask), causal=causal)
    out.backward(torch.from_numpy(dout))
    for name, w, g in zip(("dq", "dk", "dv"), want, args):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
    # dslopes sums b*t*t terms dS*|i-j|, each up to t times a dS entry, in
    # another order than the Pallas kernel: fp32 rounding grows with t
    np.testing.assert_allclose(args[3].grad.numpy(), np.asarray(want[3]), atol=1e-5 * t, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES[:5])
def test_flash_backward_plain_matches_autograd(b, h, t, d, hk, causal, padded):
    """The plain backward against torch.autograd through the plain forward
    (dslopes to 1e-5 * t, as above)."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = torch.from_numpy(rand(7, b, h, t, d))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, slopes)]
    tmask = torch.from_numpy(mask)
    out, lse = tflash.flash_attention_plain(*args, mask=tmask, causal=causal, return_lse=True)
    out.backward(dout)
    with torch.no_grad():
        delta = (dout * out).sum(-1)
        got = tflash.flash_attention_bwd_plain(*args, tmask, dout, lse, delta, causal)
    for name, g, a in zip(("dq", "dk", "dv", "dslopes"), got, args):
        atol = 1e-5 * t if name == "dslopes" else 1e-5
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), atol=atol, rtol=1e-5, err_msg=name)


def test_flash_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError):
        tflash.flash_attention_alibi(q, torch.zeros(1, 3, 5, 8), torch.zeros(1, 3, 5, 8), torch.zeros(2))
    with pytest.raises(ValueError):
        tflash.flash_attention_alibi(q, torch.zeros(1, 1, 5, 8), torch.zeros(1, 1, 5, 8), torch.zeros(3))


# ---- sampling ----


@pytest.mark.parametrize("k,thres", [(None, 0.9), (None, 0.5), (3, 0.9), (1, 0.9)])
def test_top_k_mask_matches_jax(k, thres):
    """Every logit at or above the k-th largest is kept, ties included."""
    logits = np.round(rand(7, 4, 33) * 2) / 2  # many ties
    want = jsampling.top_k(jnp.asarray(logits), thres=thres, k=k, method="lax")
    got = tsampling.top_k(torch.from_numpy(logits), thres=thres, k=k)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(np.asarray(want)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_temperature_scalar_and_per_row():
    logits = rand(8, 3, 5)
    temps = np.array([0.5, 1.0, 2.0], np.float32)
    for temp in (1.0, 0.7):
        np.testing.assert_array_equal(
            tsampling.apply_temperature(torch.from_numpy(logits), temp).numpy(),
            np.asarray(jsampling.apply_temperature(jnp.asarray(logits), temp)),
        )
    np.testing.assert_allclose(
        tsampling.apply_temperature(torch.from_numpy(logits), torch.from_numpy(temps)).numpy(),
        np.asarray(jsampling.apply_temperature(jnp.asarray(logits), jnp.asarray(temps))),
        rtol=1e-7,
    )


def test_categorical_follows_the_softmax():
    """Draw frequencies against softmax(logits), filtered entries never drawn."""
    logits = torch.tensor([[1.0, 0.0, -1.0, float("-inf")], [0.0, 0.0, 2.0, float("-inf")]])
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tsampling.categorical(logits, gen) for _ in range(4000)])
    freq = torch.stack([(draws == i).float().mean(0) for i in range(4)], -1)
    probs = torch.softmax(logits, -1)
    assert (freq[:, 3] == 0).all()
    np.testing.assert_allclose(freq.numpy(), probs.numpy(), atol=0.03)

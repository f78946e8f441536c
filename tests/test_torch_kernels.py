"""The port's kernel wrappers against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
`chip_smoke.py`. Inputs come from numpy with a fixed seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
    # b, h, t, d, hk, causal, padded
    (2, 4, 37, 16, 1, False, True),
    (2, 4, 37, 16, 1, True, True),
    (1, 2, 130, 8, 2, False, False),
    (2, 2, 130, 8, 2, True, True),
    (3, 3, 9, 32, 1, True, False),
]


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_flash_plain_matches_pallas_kernel(b, h, t, d, hk, causal, padded):
    """The Pallas kernel in interpret mode at "highest" (fp32) precision;
    output and logsumexp, with ragged t, MQA and MHA, key padding."""
    q, k, v = rand(2, b, h, t, d), rand(3, b, hk, t, d), rand(4, b, hk, t, d)
    slopes = np.abs(rand(5, h)) * 0.5
    mask = np.ones((b, t), bool)
    if padded:
        lengths = np.random.RandomState(6).randint(1, t + 1, b)
        mask = np.arange(t)[None] < lengths[:, None]
    scale = d**-0.5
    want_o, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes),
        jnp.asarray(mask, jnp.float32), causal, scale, 256, 256, True, "highest", return_lse=True,
    )
    got_o, got_lse = tflash.flash_attention_alibi(
        *(torch.from_numpy(a) for a in (q, k, v, slopes)), mask=torch.from_numpy(mask),
        causal=causal, scale=scale, return_lse=True,
    )
    # rows whose keys are all masked (causal row 0 cannot be) hold no information
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


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

"""The port's kernel wrappers against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
`chip_smoke.py`. Inputs come from numpy with a fixed seed.
"""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.models import attention as jattention
from scoreperformer_tpu.ops import flash_attention as jflash
from scoreperformer_tpu.ops import kv_cache as jkv
from scoreperformer_tpu.ops import sampling as jsampling
from scoreperformer_tpu.ops.flash_attention import _flash_forward

from scoreperformer_tpu_torch.models import attention as tattention
from scoreperformer_tpu_torch.models.layers import alibi_slopes
from scoreperformer_tpu_torch.ops import flash_attention as tflash
from scoreperformer_tpu_torch.ops import kv_cache as tkv
from scoreperformer_tpu_torch.ops import prefix_attend as tprefix
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


@pytest.mark.parametrize("index", [0, 3, 6, 7, 100, -2, -9, -30], ids=lambda i: f"index{i}")
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_write_kv_pair_matches_two_jax_writes(index, cache_dtype):
    """A layer's K and V rows at one start: two JAX `write_kv` calls at the
    indices above, both caches written in place."""
    caches, rows = [rand(s, 10, 3, 8) for s in (0, 2)], [rand(s, 3, 3, 8) for s in (1, 3)]
    want = [jkv.write_kv(jnp.asarray(c, dtype=cache_dtype), jnp.asarray(r), index) for c, r in zip(caches, rows)]
    tcaches = [torch.from_numpy(c.copy()).to(getattr(torch, cache_dtype)) for c in caches]
    got = tkv.write_kv_pair(*tcaches, *map(torch.from_numpy, rows), torch.tensor([index]))
    for g, tc, w in zip(got, tcaches, want):
        assert g is tc  # in place
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


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
    # scale_1024's decoder head dim: MQA causal and padded, MHA, an element
    # with no valid key
    (2, 2, 130, 128, 1, True, True),
    (1, 2, 37, 128, 2, False, False),
    (2, 2, 40, 128, 1, False, "empty"),
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
    interpret mode. dout is nonzero everywhere, on rows whose keys are all
    masked too: there JAX's P is 1 on every key its blocks visit, the
    wrapper's padded keys included, and those reach the slope gradient."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
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
        w, g = np.asarray(w), g.grad.numpy()
        if padded == "empty":
            # batch element 0 has no valid key, so P is 1 there, not 1/n: its
            # gradients are unnormalized sums over up to 512 keys (up to ~100
            # here) that each framework rounds in its own order, so that
            # element holds to 1e-5 of its largest value; the others to 1e-5
            atol = 1e-5 * max(1.0, float(np.abs(w[0]).max()))
            np.testing.assert_allclose(g[0], w[0], atol=atol, rtol=1e-5, err_msg=f"{name}, empty element")
            w, g = w[1:], g[1:]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
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


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_flash_plain_keeps_fp64_inputs_in_fp64(b, h, t, d, hk, causal, padded):
    """On fp64 inputs the plain versions compute in fp64 (chip_smoke.py's
    reference for the kernels' slope gradients, whose fp32 sums over t*t
    cancelling terms round by up to 1.6e-3 of their largest at t = 2050), with
    masked scores at the kernels' fp32 -1e30, so that rows with no valid key
    take the fp32 lse and get P = 1 as the kernels do. Forward and backward
    agree with the fp32 versions to fp32 rounding (1e-5 of each tensor's
    largest value, dslopes 1e-5 * t as above)."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
    m = torch.from_numpy(mask)
    f32 = [torch.from_numpy(a) for a in (q, k, v, slopes, dout)]
    f64 = [a.double() for a in f32]
    o32, lse32 = tflash.flash_attention_plain(*f32[:4], mask=m, causal=causal, return_lse=True)
    o64, lse64 = tflash.flash_attention_plain(*f64[:4], mask=m, causal=causal, return_lse=True)
    assert o64.dtype == lse64.dtype == torch.float64
    np.testing.assert_allclose(o64.numpy(), o32.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse64.numpy(), lse32.numpy(), atol=1e-5, rtol=1e-5)
    delta = (f32[4] * o32).sum(-1)
    got32 = tflash.flash_attention_bwd_plain(*f32[:4], m, f32[4], lse32, delta, causal)
    got64 = tflash.flash_attention_bwd_plain(*f64[:4], m, f64[4], lse32.double(), delta.double(), causal)
    for name, x, y in zip(("dq", "dk", "dv", "dslopes"), got64, got32):
        assert x.dtype == torch.float64 and torch.isfinite(x).all(), name
        scale = max(1.0, float(y.abs().max())) * (t if name == "dslopes" else 1)
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5 * scale, rtol=1e-5, err_msg=name)


# ---- the forward kernel's split-TF32 arithmetic, emulated on the CPU ----


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest with ties away from
    zero, as `cvt.rna.tf32.f32` rounds: half of the 13 dropped bits' unit is
    added to the magnitude, then those bits are cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's tensor cores compute it: each operand split into
    hi = tf32(x) and lo = tf32(x - hi), three TF32 products summed in fp32."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def flash_forward_with(matmul, q, k, v, slopes, mask, causal):
    """flash_attention_plain's forward with both of its products taken by
    `matmul`: (o, lse)."""
    b, _, tq, d = q.shape
    tk = k.shape[2]
    s = matmul(q * d**-0.5, k.transpose(-1, -2))
    valid, dist = tflash._valid(b, tq, tk, mask, causal, q.device)
    s = torch.where(valid, s - slopes[None, :, None, None] * dist, tflash.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    none_valid = m == tflash.NEG_INF
    keys = tflash.jax_masked_row_keys(tq, tk, causal)[:, None]
    p = torch.where(none_valid, (torch.arange(tk)[None, :] < keys).float(), p)
    l = torch.where(none_valid, keys.float(), l)
    return matmul(p, v) / l, (m + torch.log(l))[..., 0]


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-11, 3.0, 0.0], dtype=torch.float32)
    np.testing.assert_array_equal(tf32_rna(x).numpy(),
                                  np.float32([1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2 * 2**-10, 3.0, 0.0]))
    y = tf32_rna(torch.from_numpy(rand(0, 1000)))
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("causal,padded", [(False, True), (True, True), (False, "empty"), (True, "empty")],
                         ids=["padded", "causal", "empty", "causal_empty"])
def test_flash_split_tf32_arithmetic_matches_plain(causal, padded):
    """Both products of the forward in split TF32 (three TF32 products per
    fp32 one) stay within 1e-5 of the fp32 plain version on o and lse at the
    encoders' width; one TF32 product a product does not. The slopes are a
    4-head model's ALiBi slopes (1/4 to 1/256): with slopes near 1 the bias
    reaches -400, where fp32's own spacing (3e-5) exceeds the tolerance
    whatever order the sums take."""
    q, k, v, _, mask = map(torch.from_numpy, flash_inputs(2, 4, 384, 64, 1, padded))
    slopes = alibi_slopes(4)
    want_o, want_lse = tflash.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)
    got_o, got_lse = flash_forward_with(split_tf32_matmul, q, k, v, slopes, mask, causal)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=0)
    one_o, one_lse = flash_forward_with(lambda a, b: tf32_rna(a) @ tf32_rna(b), q, k, v, slopes, mask, causal)
    assert max((one_o - want_o).abs().max().item(), (one_lse - want_lse).abs().max().item()) > 1e-5


# ---- the fp32 backward kernels' split-TF32 wgmma arithmetic, emulated ----

CSRC = Path(__file__).resolve().parents[1] / "scoreperformer_tpu_torch" / "csrc"
# csrc/flash_attention_bwd.cu's tiles, by head dim: the query rows of a
# dK/dV item (DkvSmem::Q), the keys of a dQ key tile (DqSmem::kKeys); S and
# dP sum over d one k-step (8) a tile (split_ss_sum)
DKV_ITEM_ROWS = {16: 64, 32: 64, 64: 64, 128: 16}
DQ_KEY_TILE = {16: 64, 32: 64, 64: 64, 128: 32}
K_STEP = 8


def tf32_split(x):
    """x as the kernels split it: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def round_to_zero(x):
    """x (fp64, in fp32's normal range) rounded toward zero to fp32's 24
    bits, as a tensor-core add rounds; kept in fp64."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64)


def tf32_chains(a, b, tile, one=False):
    """a (..., m, n) @ b (..., n, e) as the kernels' wgmma chains take it: n
    in tiles of `tile`, each tile's chain from zero, one wgmma at a time
    (a k-step's lo.hi, hi.lo, hi.hi; only hi.hi when `one`), each adding
    its k-step's exact products and rounding toward zero; the tiles joined
    in order by rounded fp32 adds. Tiles run side by side, about 2**21
    outputs at a time."""
    n = a.shape[-1]
    pad = -n % tile
    tiles = (n + pad) // tile
    a = torch.nn.functional.pad(a, (0, pad)).unflatten(-1, (tiles, tile)).movedim(-2, -3)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).unflatten(-2, (tiles, tile))
    (ah, al), (bh, bl) = (tuple(x.double() for x in tf32_split(y)) for y in (a, b))
    products = [(ah, bh)] if one else [(al, bh), (ah, bl), (ah, bh)]
    outputs = torch.broadcast_shapes(a.shape[:-3], b.shape[:-3]).numel() * a.shape[-2] * b.shape[-1]
    group = max(1, (1 << 21) // outputs)
    total = None
    for first in range(0, tiles, group):
        chain = None
        for k in range(0, tile, K_STEP):
            for x, y in products:
                p = x[..., first:first + group, :, k:k + K_STEP] @ y[..., first:first + group, k:k + K_STEP, :]
                chain = round_to_zero(p if chain is None else chain + p)
        for part in chain.float().unbind(-3):
            total = part if total is None else total + part
    return total


def heads_in_turn(x, rows):
    """x (b, h, r, c) as one KV head's operand summed over the heads' rows in
    turn, (b, 1, h * r', c), each head's r rows padded to r', a multiple of
    `rows`, so that no tile spans two heads."""
    x = torch.nn.functional.pad(x, (0, 0, 0, -x.shape[2] % rows))
    return x.flatten(1, 2)[:, None]


def emulate_fp32_bwd(q, k, v, slopes, mask, dout, lse, delta, causal, one=False):
    """(dq, dk, dv, dslopes) by csrc/flash_attention_bwd.cu's arithmetic:
    every product three TF32 products on split operands, each chain of
    truncating wgmma adds from zero over at most 64 of its summed dimension
    (a k-step of 8 of d for S and dP; an item's DKV_ITEM_ROWS queries for
    dV and dK, with one KV head the heads' items in turn; DQ_KEY_TILE keys
    for dQ), the chains joined by fp32 adds; bias, mask, exp and dS in fp32.
    `one`: one TF32 product a product instead."""
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    scale = d**-0.5
    qs = q * scale
    s = tf32_chains(qs, k.transpose(-1, -2), K_STEP, one)
    dp = tf32_chains(dout, v.transpose(-1, -2), K_STEP, one)
    valid, dist = tflash._valid(b, tq, tk, mask, causal, q.device)
    x = torch.where(valid, s - slopes[None, :, None, None] * dist, torch.tensor(tflash.NEG_INF))
    limit = tflash.jax_masked_row_keys(tq, tk, True) if causal else torch.full((tq,), tk)
    p = torch.where(torch.arange(tk)[None, :] < limit[:, None], torch.exp(x - lse[..., None]), 0.0)
    ds = p * (dp - delta[..., None])
    rows = DKV_ITEM_ROWS[d]

    def dkv(a, c):  # a (b, h, tq, tk) summed over its queries with c (b, h, tq, d)
        if hk == 1:
            a, c = heads_in_turn(a, rows), heads_in_turn(c, rows)
        return tf32_chains(a.transpose(-1, -2), c, rows, one)

    dv = dkv(p, dout)
    dk = dkv(ds, qs)
    dq = tf32_chains(ds, k.expand(b, h, tk, d), DQ_KEY_TILE[d], one) * scale
    dslopes = (ds.double() * -dist.double()).sum(dim=(0, 2, 3)).float()
    padded = tflash.padded_key_dslopes(lse, delta, tq, tk, causal)
    return dq, dk, dv, dslopes if padded is None else dslopes + padded


@pytest.mark.parametrize("causal,padded", [(False, True), (True, True), (False, "empty"), (True, "empty")],
                         ids=["padded", "causal", "empty", "causal_empty"])
@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
def test_flash_backward_split_tf32_arithmetic_matches_plain(d, causal, padded):
    """The fp32 backward kernels' arithmetic (`emulate_fp32_bwd`) stays within
    1e-5 of the fp32 plain version on dq, dk, dv and dslopes, each relative
    to its largest value, at every head dim the kernels take; one TF32
    product a product does not. One KV head; a 4-head model's ALiBi slopes,
    as in the forward's test. t = 384 pads 128 keys past t, so the slope
    gradient takes the JAX wrapper's padded keys too."""
    q, k, v, _, mask = map(torch.from_numpy, flash_inputs(2, 4, 384, d, 1, padded))
    slopes = alibi_slopes(4)
    dout = torch.from_numpy(rand(7, 2, 4, 384, d))
    out, lse = tflash.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)
    delta = (dout * out).sum(-1)
    args = (q, k, v, slopes, mask, dout, lse, delta, causal)
    want = tflash.flash_attention_bwd_plain(*args)

    def errors(one):
        got = emulate_fp32_bwd(*args, one=one)
        return {name: ((g - w).abs().max() / w.abs().max()).item()
                for name, g, w in zip(("dq", "dk", "dv", "dslopes"), got, want)}

    split = errors(False)
    assert max(split.values()) <= 1e-5, split
    one = errors(True)
    assert min(one.values()) > 1e-5, one


@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
def test_flash_backward_logit_chains_do_not_drift_toward_zero(d):
    """S = (q.scale).K^T and dP = dO.V^T by the kernels' chains (each
    k-step's three products from zero, joined by rounded fp32 adds) err
    toward zero by a mean under half of fp32's relative step (2**-23 |x|)
    at every head dim; one chain over all of d, where each of its 3d/8
    wgmmas truncates, drifts toward zero by about d/16 steps. The drift
    adds up coherently in the slope gradient's sum over keys and queries:
    at the test above's random inputs such a chain's gradients stay within
    about 1e-5 of the plain version's, yet on the card it moved a train
    step's slope gradient past chip_smoke.py's card-vs-CPU gate."""
    q, k, v, _, _ = map(torch.from_numpy, flash_inputs(2, 4, 384, d, 1, True))
    dout = torch.from_numpy(rand(7, 2, 4, 384, d))
    for a, b in ((q * d**-0.5, k.transpose(-1, -2)), (dout, v.transpose(-1, -2))):
        exact = a.double() @ b.double()

        def drift(tile):
            err = (tf32_chains(a, b, tile).double() - exact) * exact.sign()
            return (err.mean() / (exact.abs().mean() * 2.0**-23)).item()

        assert abs(drift(K_STEP)) < 0.5
        assert drift(d) < -d / 32


KERNEL_CASES = [c for c in FLASH_CASES if c[3] in tflash.KERNEL_HEAD_DIMS]


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", KERNEL_CASES)
def test_flash_backward_split_tf32_arithmetic_matches_pallas_kernels(b, h, t, d, hk, causal, padded):
    """`emulate_fp32_bwd` against `jax.vjp` of the Pallas kernels in
    interpret mode at "highest", with test_flash_backward_matches_pallas_kernels'
    tolerances, on the kernel forward's plain lse and delta as the autograd
    Function takes them."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
    _, vjp = jax.vjp(
        lambda *a: jflash.flash_attention_alibi(*a, mask=jnp.asarray(mask), causal=causal,
                                                interpret=True, precision="highest"),
        *map(jnp.asarray, (q, k, v, slopes)),
    )
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, ts, to = (torch.from_numpy(a) for a in (q, k, v, slopes, dout))
    tm = torch.from_numpy(mask)
    out, lse = tflash.flash_attention_plain(tq, tk, tv, ts, mask=tm, causal=causal, return_lse=True)
    got = emulate_fp32_bwd(tq, tk, tv, ts, tm, to, lse, (to * out).sum(-1), causal)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        w, g = np.asarray(w), g.numpy()
        if padded == "empty":  # unnormalized sums on element 0, as in the plain version's test
            atol = 1e-5 * max(1.0, float(np.abs(w[0]).max()))
            np.testing.assert_allclose(g[0], w[0], atol=atol, rtol=1e-5, err_msg=f"{name}, empty element")
            w, g = w[1:], g[1:]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5 * t, rtol=1e-5)


def masked_row_keys(qi, tq, tk, causal):
    """wgmma.cuh::masked_row_keys: the end of the keys the JAX wrapper visits
    for query row qi with no valid key, the keys it pads included."""
    bk = max(128, min(256, tk))
    n_kb = -(-tk // bk)
    if not causal:
        return n_kb * bk
    bq = max(8, min(256, tq))
    return min(n_kb, -(-((qi // bq + 1) * bq) // bk)) * bk


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padded_key_dslopes_row_by_row_is_the_wrappers(causal):
    """wgmma.cuh::padded_keys_dslope, the term the dQ kernels add once a row
    (p * delta * the row's distances to the padded keys it visits, the
    distances summed in fp32), summed as `padded_key_dslopes` sums, gives
    its bits for every t from 1 to 300; zero where the wrapper pads no key.
    Element 0 has rows with no valid key (lse = -1e30, so p = 1), the other
    a finite lse (p = 0)."""
    g = np.random.RandomState(3)
    for t in range(1, 301):
        lse = torch.from_numpy(g.randn(2, 2, t).astype(np.float32))
        lse[0, :, ::2] = tflash.NEG_INF
        delta = torch.from_numpy(g.randn(2, 2, t).astype(np.float32))
        p = torch.exp(torch.tensor(tflash.NEG_INF, dtype=torch.float32) - lse)
        dist = torch.tensor([float(np.abs(np.arange(t, masked_row_keys(qi, t, t, causal)) - qi).astype(np.float32)
                                   .sum(dtype=np.float32)) for qi in range(t)], dtype=torch.float32)
        rows = torch.where(p == 0, 0.0, p * delta * dist)
        want = tflash.padded_key_dslopes(lse, delta, t, t, causal)
        if want is None:
            assert not rows.any(), t
        else:
            assert torch.equal(rows.sum(dim=(0, 2)), want), t


def test_fp32_backward_dispatch_cases_and_tiles_are_the_emulations():
    """csrc/flash_attention_bwd.cu dispatches the wrapper's head dims, and
    its tiles (a dK/dV item's query rows, a dQ key tile's keys) are the ones
    `emulate_fp32_bwd` takes."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    switch = re.search(r"switch \(d\) \{(.*?)default:", text, re.S)
    assert switch is not None
    assert tuple(sorted(int(c) for c in re.findall(r"case (\d+):", switch.group(1)))) == tflash.KERNEL_HEAD_DIMS
    item = re.search(r"static constexpr int Q = D == 128 \? (\d+) : (\d+);", text)
    keys = re.search(r"static constexpr int kKeys = D == 128 \? (\d+) : (\d+);", text)
    assert item is not None and keys is not None
    assert DKV_ITEM_ROWS == {d: int(item.group(1 if d == 128 else 2)) for d in tflash.KERNEL_HEAD_DIMS}
    assert DQ_KEY_TILE == {d: int(keys.group(1 if d == 128 else 2)) for d in tflash.KERNEL_HEAD_DIMS}


@pytest.mark.parametrize("b,h,hk,tq,blocks", [
    (128, 4, 1, 258, 17), (128, 4, 1, 257, 17), (2, 4, 4, 130, 3), (3, 1, 1, 65, 2),
    (2, 8, 1, 9, 2), (2, 3, 1, 64, 1), (5, 2, 1, 1, 1), (2, 64, 1, 3, 3),
])
def test_flash_dq_slope_parts_match_the_kernel_grid(b, h, hk, tq, blocks):
    """One slope-gradient part per head a dQ block holds: with one KV head
    and h dividing 64 a block holds the h heads at 64/h positions (the
    forward's blocks), else 64 positions of one head."""
    assert tflash.dq_slope_parts(b, h, hk, tq) == (b, h, blocks)


def test_flash_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError):
        tflash.flash_attention_alibi(q, torch.zeros(1, 3, 5, 8), torch.zeros(1, 3, 5, 8), torch.zeros(2))
    with pytest.raises(ValueError):
        tflash.flash_attention_alibi(q, torch.zeros(1, 1, 5, 8), torch.zeros(1, 1, 5, 8), torch.zeros(3))


# ---- prefix attend: atol/rtol 1e-5 against the Pallas kernel ----


@pytest.fixture(scope="module")
def pallas_decode_attend():
    """scripts/exp_pallas_decode_attend.py loaded by path. Its import points
    jax's compile cache elsewhere and edits sys.path; both are put back."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "exp_pallas_decode_attend.py"
    saved = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs,
             list(sys.path))
    spec = importlib.util.spec_from_file_location("exp_pallas_decode_attend", path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
        sys.path[:] = saved[2]
    return module


def prefix_inputs(b, cap, base, h=4, d=64, seed=11):
    """Scale-folded q, time-major pk/pv (one KV head) and an (h, cap) bias:
    ALiBi up to `base`, -1e9 from there on (every slot stale when base is
    0)."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, d) * d**-0.5).astype(np.float32)
    pk, pv = rng.randn(2, cap, b, d).astype(np.float32)
    slopes = 0.5 ** np.arange(1, h + 1)
    alibi = -np.abs(base + 3 - np.arange(cap))[None] * slopes[:, None]
    bias = np.where(np.arange(cap)[None] < base, alibi, -1e9).astype(np.float32)
    return q, pk, pv, bias


@pytest.mark.parametrize("b,cap,base,h,d", [
    (128, 64, 40, 4, 64), (128, 64, 0, 4, 64), (512, 256, 200, 4, 64), (512, 256, 0, 4, 64),
    # the decoders of recipes/smoke.yaml and recipes/scoreperformer/scale_1024.yaml
    (128, 64, 40, 2, 16), (128, 128, 100, 8, 128),
    # scale_1024's decoder cache with a base that no tile divides
    (128, 1024, 517, 8, 128),
], ids=["b128_cap64", "b128_cap64_all_stale", "b512_cap256", "b512_cap256_all_stale", "b128_cap64_h2_d16",
        "b128_cap128_h8_d128", "b128_cap1024_base517_h8_d128"])
def test_prefix_attend_plain_matches_pallas_kernel(pallas_decode_attend, monkeypatch, b, cap, base, h, d):
    """The Pallas kernel in interpret mode (module globals B, CAP, H and D
    set to the shape, inputs relaid to its (cap, d, b) layout) against the
    plain version on the cache's own layout: o and lse."""
    for name, value in (("B", b), ("CAP", cap), ("H", h), ("D", d)):
        monkeypatch.setattr(pallas_decode_attend, name, value)
    q, pk, pv, bias = prefix_inputs(b, cap, base, h, d)
    want_o, want_lse = pallas_decode_attend.pallas_prefix_attend(
        jnp.asarray(q.transpose(1, 2, 0)), jnp.asarray(pk.transpose(0, 2, 1)),
        jnp.asarray(pv.transpose(0, 2, 1)), jnp.asarray(bias.T),
    )
    got_o, got_lse = tprefix.prefix_attend(*map(torch.from_numpy, (q, pk, pv, bias)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o).transpose(2, 0, 1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).T, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("base", [0, 16, 100])
def test_prefix_attend_skips_stale_slots(base):
    """Reading only the slots before `base` gives the answer of the whole
    biased cache once joined with a fresh half (`combine_lse`): a stale
    slot's weight is exactly 0; with base 0 the prefix's weight is 0."""
    q, pk, pv, bias = map(torch.from_numpy, prefix_inputs(3, 128, base))
    o_f, lse_f = torch.randn(3, 4, 64, generator=torch.Generator().manual_seed(0)), torch.zeros(3, 4)
    whole = tprefix.combine_lse(*tprefix.prefix_attend(q, pk, pv, bias), o_f, lse_f)
    skipped = tprefix.combine_lse(*tprefix.prefix_attend(q, pk, pv, bias, n_valid=base), o_f, lse_f)
    for w, s in zip(whole, skipped):
        np.testing.assert_allclose(s.numpy(), w.numpy(), atol=1e-6, rtol=1e-6)
    if base == 0:
        np.testing.assert_array_equal(skipped[0].numpy(), o_f.numpy())


def test_combine_lse_matches_one_softmax():
    """Two halves joined by logsumexp equal one softmax over all the keys."""
    rng = np.random.RandomState(12)
    s, v = torch.from_numpy(rng.randn(2, 3, 40).astype(np.float32) * 3), torch.from_numpy(rng.randn(2, 40, 8).astype(np.float32))

    def half(sl):
        lse = torch.logsumexp(s[..., sl], -1)
        return torch.softmax(s[..., sl], -1) @ v[:, sl], lse

    o, lse = tprefix.combine_lse(*half(slice(0, 25)), *half(slice(25, 40)))
    np.testing.assert_allclose(o.numpy(), (torch.softmax(s, -1) @ v).numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-6)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 176, 192, 240])
@pytest.mark.parametrize("b", [1, 4, 128, 512])
def test_prefix_attend_split_plan(b, n):
    """The kernel's split of `n` slots of b (batch row, KV head) units in
    tiles of 64 on 132 SMs: tile i goes to split i // per, each slot lies in
    exactly one tile of one split, no split is empty unless there is no
    slot, a cluster holds at most MAX_CLUSTER blocks, and a grid of more
    than one split has at most one block an SM."""
    sms, tile = 132, 64
    splits, per = tprefix.split_plan(b, n, tile, sms)
    assert 1 <= splits <= tprefix.MAX_CLUSTER and per >= 1
    tiles = [[range(t * tile, min(n, (t + 1) * tile)) for t in range(s * per, (s + 1) * per) if t * tile < n]
             for s in range(splits)]
    assert sorted(j for split in tiles for r in split for j in r) == list(range(n))
    if n:
        assert all(split and all(len(r) > 0 for r in split) for split in tiles)
    assert splits == 1 or splits * b <= sms


def emulate_prefix_attend(q, pk, pv, bias, k_s=None, v_s=None, n_valid=None, sms=132):
    """csrc/prefix_attend.cu's order in fp32 on the CPU: for each (batch row,
    KV head), `split_plan`'s splits of whole tiles of `tile_slots` slots; in
    each split's tiles, one max a head, one rescale of (m, l, acc), one
    exponential a (head, slot) and P = p * v_s; the splits merged in order
    from the floor of -1e9."""
    b, h, d = q.shape
    cap, kvh = pk.shape[0], pk.shape[2] // d
    r = h // kvh
    n = cap if n_valid is None else n_valid
    tile = tprefix.tile_slots(d, pk.element_size(), r)
    splits, per = tprefix.split_plan(b * kvh, n, tile, sms)
    n_tiles = -(-n // tile)
    k, v = (x.float().reshape(cap, b, kvh, d) for x in (pk, pv))
    ks = k_s if k_s is not None else torch.ones(cap, b)
    vs = v_s if v_s is not None else torch.ones(cap, b)
    o, lse = torch.zeros(b, h, d), torch.zeros(b, h)
    for g in range(kvh):
        heads = slice(g * r, (g + 1) * r)
        states = []
        for s in range(splits):
            m, l, acc = torch.full((b, r), tprefix.MASK_VALUE), torch.zeros(b, r), torch.zeros(b, r, d)
            for t in range(s * per, min(n_tiles, (s + 1) * per)):
                j = torch.arange(t * tile, min(n, (t + 1) * tile))
                sc = torch.einsum("brd,jbd->brj", q[:, heads], k[j, :, g]) * ks[j].T[:, None] + bias[heads, j][None]
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("brj,jbd->brd", p * vs[j].T[:, None], v[j, :, g])
                m = m_new
            states.append((m, l, acc))
        mx = torch.full((b, r), tprefix.MASK_VALUE)
        for m, _, _ in states:
            mx = torch.maximum(mx, m)
        lsum, a = torch.zeros(b, r), torch.zeros(b, r, d)
        for m, l, acc in states:
            w = torch.exp(m - mx)
            lsum, a = lsum + l * w, a + acc * w[..., None]
        safe = torch.where(lsum == 0, 1.0, lsum)
        o[:, heads], lse[:, heads] = a / safe[..., None], mx + torch.log(safe)
    return o, lse


@pytest.mark.parametrize("b,cap,base,h,d,kvh,dtype,sms", [
    (3, 100, 77, 4, 32, 1, "fp32", 132),  # a base that no tile divides
    (5, 100, 60, 4, 64, 4, "int8", 132),  # one KV head a query head
    (2, 1024, 1024, 8, 128, 1, "int8", 132),  # n_valid = cap, b = 2: many splits
    (16, 384, 192, 4, 64, 1, "bf16", 132),  # the MoE served batch's shape
    (1, 352, 176, 4, 64, 1, "fp32", 132),  # the render's
    (4, 1024, 517, 8, 128, 1, "fp32", 20),  # scale_1024's decoder, uneven splits
    (3, 128, 0, 2, 16, 1, "fp32", 132),  # no slot: o = 0, lse = -1e9
    (2, 384, 5, 2, 16, 1, "bf16", 132),  # a base below one tile
], ids=["d32_base77", "mha_int8", "d128_int8_full", "served_bf16", "render", "d128_base517", "empty", "d16_base5"])
def test_prefix_attend_tile_order_matches_plain(b, cap, base, h, d, kvh, dtype, sms):
    """The kernel's tiles, rescales and split merge (emulated in fp32) give
    the plain version's o and lse within 1e-5 on fp32, bf16 and int8 caches."""
    from scoreperformer_tpu_torch.models.attention import quantize_kv_rows

    rng = np.random.RandomState(21)
    q = torch.from_numpy((rng.randn(b, h, d) * d**-0.5).astype(np.float32))
    pk, pv = (torch.from_numpy(rng.randn(cap, b, kvh * d).astype(np.float32)) for _ in range(2))
    slopes = 0.5 ** np.arange(1, h + 1)
    bias = torch.from_numpy(np.where(np.arange(cap)[None] < base, -np.abs(base - np.arange(cap))[None] * slopes[:, None],
                                     -1e9).astype(np.float32))
    scales = (None, None)
    if dtype == "bf16":
        pk, pv = pk.bfloat16(), pv.bfloat16()
    elif dtype == "int8":
        (pk, k_s), (pv, v_s) = quantize_kv_rows(pk), quantize_kv_rows(pv)
        scales = (k_s.contiguous(), v_s.contiguous())
    got_o, got_lse = emulate_prefix_attend(q, pk, pv, bias, *scales, n_valid=base, sms=sms)
    want_o, want_lse = tprefix.prefix_attend_plain(q, pk, pv, bias, *scales, n_valid=base)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-5)
    if base == 0:
        assert not got_o.any() and (got_lse == tprefix.MASK_VALUE).all()


def test_prefix_attend_tiles_are_the_kernels():
    """ops/prefix_attend.py's tile constants and cluster limit are
    csrc/prefix_attend.cu's, whose tile_slots and grid they set."""
    src = (Path(tprefix.__file__).resolve().parent.parent / "csrc" / "prefix_attend.cu").read_text()

    def constant(name):
        match = re.search(rf"constexpr int {name} = (\d+);", src)
        assert match, name
        return int(match.group(1))

    assert constant("kTileKBytes") == tprefix.TILE_K_BYTES
    assert constant("kMaxPairs") == tprefix.MAX_PAIRS
    assert constant("kMaxCluster") == tprefix.MAX_CLUSTER
    # every tile: 64 to 128 slots, a multiple of 16 (a TMA box), at most
    # MAX_PAIRS pairs
    for d in tprefix.KERNEL_HEAD_DIMS:
        for size in (4, 2, 1):
            for r in tprefix.KERNEL_HEADS:
                tile = tprefix.tile_slots(d, size, r)
                assert 64 <= tile <= 128 and tile % 16 == 0 and r * tile <= tprefix.MAX_PAIRS
    assert tprefix.tile_slots(128, 4, 8) == 64 and tprefix.tile_slots(64, 4, 4) == 64
    assert tprefix.tile_slots(128, 1, 8) == 64 and tprefix.tile_slots(16, 4, 2) == 128


def test_prefix_attend_rejects_bad_inputs():
    q, pk = torch.zeros(2, 4, 8), torch.zeros(5, 2, 8)
    with pytest.raises(ValueError):  # bias of the wrong shape
        tprefix.prefix_attend(q, pk, pk, torch.zeros(4, 4))
    with pytest.raises(ValueError):  # an int8 cache without its row scales
        tprefix.prefix_attend(q, pk.to(torch.int8), pk.to(torch.int8), torch.zeros(4, 5))
    with pytest.raises(ValueError):  # n_valid past the capacity
        tprefix.prefix_attend(q, pk, pk, torch.zeros(4, 5), n_valid=6)


# ---- int8 row quantization: exact ----


def test_quantize_kv_rows_matches_jax():
    """Values and scales equal JAX's, ties (x / scale = k + 0.5) rounded half
    to even, an all-zero row at the eps floor."""
    rng = np.random.RandomState(13)
    rows = rng.randn(3, 5, 16).astype(np.float32) * 3
    rows[0, 0, :5] = [127.0, 2.5, -3.5, 0.5, -1.5]  # scale 1: ties
    rows[0, 0, 5:] = 0.0
    rows[0, 1] = 0.0
    rows[1, 2, :4] = [254.0, 5.0, -7.0, 1.0]  # scale 2: ties again
    want_q, want_s = jattention.quantize_kv_rows(jnp.asarray(rows))
    got_q, got_s = tattention.quantize_kv_rows(torch.from_numpy(rows))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q[0, 0, :5].numpy(), [127, 2, -4, 0, -2])


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

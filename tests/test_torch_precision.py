"""The flash attention's `precision` on the CPU: the port's one-pass route
against the TPU's DEFAULT numerics, and the fp32-accurate route unchanged.

JAX's model calls `flash_attention_alibi` with no precision, so its Pallas
kernels run at "default": on the TPU every dot's operands are rounded to
bf16 and the products summed in fp32. XLA on the CPU computes DEFAULT in
fp32, so the tests write that arithmetic out themselves in `jax.numpy`
(`ref_forward`, `ref_bwd_dkv`, `ref_bwd_dq`): the Pallas kernels' blocks
and steps line by line, each dot's operands cast to bf16 with
`preferred_element_type=float32`. The port's plain versions in the
one-pass mode are held to that reference, and to the JAX package's own
function in interpret mode within the bf16 rounding of the operands.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from scoreperformer_tpu.ops import flash_attention as jflash
from scoreperformer_tpu_torch.models.factory import build_model
from scoreperformer_tpu_torch.ops import flash_attention as tflash

from test_torch_flash_head_dims import shaped_config
from test_torch_train import port_batch, train_batch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG_INF = -1e30
# bf16 keeps 8 significant bits: rounding to nearest moves x by at most
# 2^-8 |x| (half an ulp), and one ulp is at most 2^-7 |x|
BF16_ROUND, BF16_ULP = 2.0**-8, 2.0**-7
# (b, h, t, d, kv heads, causal, padded): MQA and MHA; d 16, 32, 64 and 128
# (32 and 128: a scale that is no power of two, so bf16(q*scale) is not
# bf16(q)*scale); causal; padded tails; an element with no valid key; t 300
# takes two key blocks of the Pallas wrapper (the online softmax's rescale)
CASES = [
    (2, 4, 65, 64, 1, True, True),
    (2, 4, 70, 64, 1, False, "empty"),
    (2, 2, 37, 32, 2, True, False),
    (1, 2, 130, 16, 1, False, True),
    (2, 2, 40, 128, 1, True, "empty"),
    (2, 2, 300, 32, 1, True, "empty"),
]
CASE_IDS = [f"b{b}h{h}t{t}d{d}hk{hk}{'c' if c else ''}{'-' + str(p) if p else ''}" for b, h, t, d, hk, c, p in CASES]


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def inputs(b, h, t, d, hk, padded, dtype):
    """q, k, v, dout (numpy, fp32 values of `dtype`), slopes, mask."""
    q, k, v, dout = rand(2, b, h, t, d), rand(3, b, hk, t, d), rand(4, b, hk, t, d), rand(7, b, h, t, d)
    if dtype == "bf16":
        q, k, v, dout = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v, dout))
    slopes = np.abs(rand(5, h)) * 0.5
    mask = np.ones((b, t), bool)
    if padded:
        lengths = np.random.RandomState(6).randint(1, t + 1, b)
        if padded == "empty":
            lengths[0] = 0
        mask = np.arange(t)[None] < lengths[:, None]
    return q, k, v, dout, slopes, mask


# ---- the TPU's DEFAULT arithmetic, written out in jax.numpy ----


def bdot(spec, a, b):
    """One MXU pass at DEFAULT: the operands rounded to bf16, the products
    summed in fp32."""
    return jnp.einsum(spec, a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), preferred_element_type=jnp.float32)


def blocks(tq, tk, block_q=256, block_k=256):
    """The wrapper's block sizes (`_flash_forward`, `_flash_attention_bwd`)."""
    return max(8, min(block_q, tq)), max(128, min(block_k, tk))


def pad_to(x, axis, mult):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, -x.shape[axis] % mult)
    return jnp.pad(x, pad)


def heads(x, h):
    """K or V (b, hk, t, d) as one slab a query head (the kernels' kv_index)."""
    return jnp.broadcast_to(x, (x.shape[0], h) + x.shape[2:])


def ref_forward(q, k, v, slopes, mask, causal, scale, dtype, key_tile=None):
    """`_flash_forward` and `_flash_kernel` at DEFAULT: (o in `dtype`, lse).
    The kernel rounds P against the running max of its key blocks, so its
    bits depend on the block: the wrapper's (256 keys, or all of them below
    256), or with `key_tile` blocks of that many keys (the port's one-pass
    kernel walks tiles of 64)."""
    cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    b, h, tq, d = q.shape
    tk = k.shape[2]
    bq, bk = blocks(tq, tk)
    bk = key_tile or bk
    q_p = pad_to(jnp.asarray(q, cast), 2, bq)
    k_p, v_p = (heads(pad_to(jnp.asarray(x, cast), 2, bk), h) for x in (k, v))
    mask_p = pad_to(jnp.asarray(mask, jnp.float32), 1, bk) > 0
    slope = jnp.asarray(slopes)[None, :, None, None]
    outs, lses = [], []
    for qb in range(q_p.shape[2] // bq):
        q_start = qb * bq
        qs = q_p[:, :, q_start:q_start + bq].astype(jnp.float32) * scale  # :68
        m_i = jnp.full((b, h, bq, 1), NEG_INF, jnp.float32)
        l_i = jnp.zeros((b, h, bq, 1), jnp.float32)
        acc = jnp.zeros((b, h, bq, d), jnp.float32)
        n_kb = k_p.shape[2] // bk
        last = min(n_kb, -(-(q_start + bq) // bk)) if causal else n_kb
        q_pos = q_start + jnp.arange(bq)[:, None]
        for kb in range(last):
            k_start = kb * bk
            kt = k_p[:, :, k_start:k_start + bk].astype(jnp.float32)
            vt = v_p[:, :, k_start:k_start + bk].astype(jnp.float32)
            s = bdot("bhqd,bhkd->bhqk", qs, kt)  # :86
            k_pos = k_start + jnp.arange(bk)[None, :]
            s = s - slope * jnp.abs(k_pos - q_pos).astype(jnp.float32)
            valid = mask_p[:, None, None, k_start:k_start + bk]
            if causal:
                valid = valid & (k_pos <= q_pos)
            s = jnp.where(valid, s, NEG_INF)
            m_new = jnp.maximum(m_i, s.max(axis=-1, keepdims=True))
            p = jnp.exp(s - m_new)
            alpha = jnp.exp(m_i - m_new)
            l_i = alpha * l_i + p.sum(axis=-1, keepdims=True)
            acc = alpha * acc + bdot("bhqk,bhkd->bhqd", p, vt)  # :102
            m_i = m_new
        outs.append((acc / jnp.maximum(l_i, 1e-30)).astype(cast))
        lses.append((m_i + jnp.log(jnp.maximum(l_i, 1e-30)))[..., 0])
    o = jnp.concatenate(outs, axis=2)[:, :, :tq]
    return np.asarray(o.astype(jnp.float32)), np.asarray(jnp.concatenate(lses, axis=2)[:, :, :tq])


def _bwd_padded(q, k, v, mask, dout, lse, delta, dtype):
    cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    h, tq, tk = q.shape[1], q.shape[2], k.shape[2]
    bq, bk = blocks(tq, tk)
    q_p, do_p = (pad_to(jnp.asarray(x, cast), 2, bq) for x in (q, dout))
    lse_p, delta_p = (pad_to(jnp.asarray(x, jnp.float32), 2, bq) for x in (lse, delta))  # padded lse rows 0
    k_p, v_p = (heads(pad_to(jnp.asarray(x, cast), 2, bk), h) for x in (k, v))
    mask_p = pad_to(jnp.asarray(mask, jnp.float32), 1, bk) > 0
    return q_p, k_p, v_p, mask_p, do_p, lse_p, delta_p, bq, bk


def ref_recompute_p(q, k, slope, q_start, k_start, lse, mask_row, causal, scale):
    """`_recompute_p` at DEFAULT: S = (bf16(q).bf16(k)) * scale."""
    bq, bk = q.shape[2], k.shape[2]
    q_pos = q_start + jnp.arange(bq)[:, None]
    k_pos = k_start + jnp.arange(bk)[None, :]
    dist = jnp.abs(k_pos - q_pos).astype(jnp.float32)
    s = bdot("bhqd,bhkd->bhqk", q, k) * scale  # :125
    s = s - slope * dist
    valid = mask_row
    if causal:
        valid = valid & (k_pos <= q_pos)
    s = jnp.where(valid, s, NEG_INF)
    return jnp.exp(s - lse), dist


def ref_bwd_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale, dtype):
    """The steps both backward kernels share, per (q block, kv block) pair
    that they visit: yields (q_start, k_start, q, k, do, p, ds, dist)."""
    q_p, k_p, v_p, mask_p, do_p, lse_p, delta_p, bq, bk = _bwd_padded(q, k, v, mask, dout, lse, delta, dtype)
    slope = jnp.asarray(slopes)[None, :, None, None]
    for qb in range(q_p.shape[2] // bq):
        for kb in range(k_p.shape[2] // bk):
            q_start, k_start = qb * bq, kb * bk
            if causal and not q_start + bq > k_start:  # :186-187, :244-245
                continue
            qt = q_p[:, :, q_start:q_start + bq].astype(jnp.float32)
            do = do_p[:, :, q_start:q_start + bq].astype(jnp.float32)
            lse_t = lse_p[:, :, q_start:q_start + bq, None]
            delta_t = delta_p[:, :, q_start:q_start + bq, None]
            kt = k_p[:, :, k_start:k_start + bk].astype(jnp.float32)
            vt = v_p[:, :, k_start:k_start + bk].astype(jnp.float32)
            mask_row = mask_p[:, None, None, k_start:k_start + bk]
            p, dist = ref_recompute_p(qt, kt, slope, q_start, k_start, lse_t, mask_row, causal, scale)
            dp = bdot("bhqd,bhkd->bhqk", do, vt)  # :179, :237
            ds = p * (dp - delta_t)
            yield q_start, k_start, qt, kt, do, p, ds, dist


def ref_bwd_dkv(q, k, v, slopes, mask, dout, lse, delta, causal, scale, dtype):
    """`_flash_bwd_dkv_kernel` at DEFAULT, dK and dV summed over the query
    blocks, then over the query heads with one KV head, in `dtype`."""
    b, h, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    bq, bk = blocks(tq, tk)
    n_k = -(-tk // bk) * bk
    dk = jnp.zeros((b, h, n_k, d), jnp.float32)
    dv = jnp.zeros((b, h, n_k, d), jnp.float32)
    for _, k_start, qt, _, do, p, ds, _ in ref_bwd_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale,
                                                         dtype):
        dv = dv.at[:, :, k_start:k_start + bk].add(bdot("bhqk,bhqd->bhkd", p, do))  # :178
        dk = dk.at[:, :, k_start:k_start + bk].add(bdot("bhqk,bhqd->bhkd", ds, qt) * scale)  # :181
    dk, dv = dk[:, :, :tk], dv[:, :, :tk]
    if hk == 1:
        dk, dv = dk.sum(axis=1, keepdims=True), dv.sum(axis=1, keepdims=True)
    cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return tuple(np.asarray(x.astype(cast).astype(jnp.float32)) for x in (dk, dv))


def ref_bwd_dq(q, k, v, slopes, mask, dout, lse, delta, causal, scale, dtype):
    """`_flash_bwd_dq_kernel` at DEFAULT: dQ (in `dtype`) and dslopes, the
    padded keys' part included."""
    b, h, tq, d = q.shape
    bq, _ = blocks(tq, k.shape[2])
    dq = jnp.zeros((b, h, -(-tq // bq) * bq, d), jnp.float32)
    dslopes = jnp.zeros((b, h), jnp.float32)
    for q_start, _, _, kt, _, _, ds, dist in ref_bwd_parts(q, k, v, slopes, mask, dout, lse, delta, causal, scale,
                                                           dtype):
        dq = dq.at[:, :, q_start:q_start + bq].add(bdot("bhqk,bhkd->bhqd", ds, kt) * scale)  # :239
        dslopes = dslopes + jnp.sum(ds * (-dist), axis=(2, 3))  # :242
    cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return np.asarray(dq[:, :, :tq].astype(cast).astype(jnp.float32)), np.asarray(dslopes.sum(axis=0))


# ---- the port's plain versions in the one-pass mode ----


def port_inputs(q, k, v, dout, slopes, mask, dtype):
    cast = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(x).to(cast) for x in (q, k, v, dout)] + [torch.from_numpy(slopes),
                                                                      torch.from_numpy(mask)]


def assert_close_but_flips(got, want, tight, flip, what, max_share=0.01):
    """`got` within `tight` of `want` but for the elements where a bf16
    rounding tie flipped: the two frameworks sum in other orders and take
    other exp approximations, so an fp32 P or dS within a few fp32 ulps of a
    midpoint between two bf16 values rounds up on one side and down on the
    other, which moves the product by one bf16 ulp of that P or dS. Those
    elements (at most `max_share` of them) are held within `flip`, the
    effect of such flips; `tight` and `flip` broadcast to `got`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    over = err > tight
    assert over.mean() <= max_share, f"{what}: {over.mean():.4f} of the elements beyond {np.max(tight):.3g}"
    bound = np.broadcast_to(np.maximum(tight, flip), err.shape)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), f"{what}: error {err[worst]:.3g} over its bound {bound[worst]:.3g} at {worst}"


def tight_tol(want, dtype):
    """fp32 sums in two orders, 1e-5; with bf16 outputs also the output's own
    rounding, one bf16 ulp of it."""
    return 1e-5 + 1e-5 * np.abs(want) + (BF16_ULP * np.abs(want) if dtype == "bf16" else 0.0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES, ids=CASE_IDS)
def test_one_pass_forward_is_the_tpus_default(b, h, t, d, hk, causal, padded, dtype):
    """o and lse of the one-pass plain forward against `ref_forward` in key
    blocks of the kernel's tile (tflash.ONE_PASS_KEY_TILE). lse
    holds to 1e-5 (its S is exact in both: products of bf16 values summed in
    fp32). o holds to `tight_tol`, but where a tie of bf16(P) flips: there
    one flip moves o[i, :] by one bf16 ulp of P[i, j], at most 2^-7 of it,
    times |v[j, :]| over l[i], bounded per row by 2^-7 * max_j (P/l) *
    max|v| (one flip a row). A row with no valid key (element 0 of the
    "empty" cases) averages v over the wrapper's key blocks, not the
    tile's: `test_one_pass_forward_in_the_wrappers_blocks` holds it."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    scale = d**-0.5
    want_o, want_lse = ref_forward(q, k, v, slopes, mask, causal, scale, dtype, key_tile=tflash.ONE_PASS_KEY_TILE)
    tq, tk, tv, _, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    got_o, got_lse = tflash.flash_attention_plain(tq, tk, tv, ts, tm, causal, scale, return_lse=True, one_pass=True)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)
    s, _ = tflash._scores(*(torch.from_numpy(x).double() for x in (q, k, slopes)), torch.from_numpy(mask), causal,
                          scale, one_pass=True)
    p_over_l = np.exp(s.numpy() - want_lse[..., None].astype(np.float64)).max(axis=3, keepdims=True)
    got_o = got_o.float().numpy()
    if padded == "empty":
        got_o, want_o, p_over_l = got_o[1:], want_o[1:], p_over_l[1:]
    tight = tight_tol(want_o, dtype)
    assert_close_but_flips(got_o, want_o, tight, BF16_ULP * p_over_l * np.abs(v).max() + tight, "o")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES, ids=CASE_IDS)
def test_one_pass_forward_in_the_wrappers_blocks(b, h, t, d, hk, causal, padded, dtype):
    """The one-pass plain forward against `ref_forward` in the Pallas
    wrapper's key blocks (up to 256 keys where the port's kernel takes 64):
    each P is rounded against another running max on the two sides, so may
    differ by one bf16 ulp, at most 2^-7 of it: o within 2^-7 * (P.|v|) / l
    of the reference, and `tight_tol`."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    scale = d**-0.5
    want_o, want_lse = ref_forward(q, k, v, slopes, mask, causal, scale, dtype)
    tq, tk, tv, _, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    got_o, got_lse = tflash.flash_attention_plain(tq, tk, tv, ts, tm, causal, scale, return_lse=True, one_pass=True)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)
    magnitude = tflash.flash_attention_plain(tq.double(), tk.double(), tv.double().abs(), ts.double(), tm, causal,
                                             scale).numpy()
    err = np.abs(got_o.float().numpy().astype(np.float64) - want_o)
    np.testing.assert_array_less(err, BF16_ULP * magnitude + tight_tol(want_o, dtype))


def test_one_pass_key_tile_is_the_forward_kernel_s():
    """The plain forward rounds P against the running max of the key tiles
    the bf16 forward kernel walks (its kRows)."""
    source = (Path(tflash.__file__).resolve().parents[1] / "csrc" / "flash_attention_fwd_bf16.cu").read_text()
    assert re.search(r"constexpr int kRows = (\d+);", source).group(1) == str(tflash.ONE_PASS_KEY_TILE)


@pytest.fixture(scope="module")
def bwd_cases():
    """Each case's numpy inputs with the reference forward's lse and delta =
    rowsum(dout * o), fed to both sides."""
    cache = {}

    def get(case, dtype):
        if (case, dtype) not in cache:
            b, h, t, d, hk, causal, padded = case
            q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
            o, lse = ref_forward(q, k, v, slopes, mask, causal, d**-0.5, dtype)
            delta = (dout * o).sum(-1).astype(np.float32)
            cache[case, dtype] = (q, k, v, dout, slopes, mask, lse, delta)
        return cache[case, dtype]

    return get


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES, ids=CASE_IDS)
def test_one_pass_dkv_is_the_tpus_default(bwd_cases, b, h, t, d, hk, causal, padded, dtype):
    """dK and dV of the one-pass plain dK/dV function against
    `ref_bwd_dkv`, to `tight_tol` but where a tie of bf16(P) (dV) or bf16(dS)
    (dK) flips: one flip moves dV[j, :] by one bf16 ulp of P[i, j] (at most
    2^-7 of it) times |dO[i, :]|, dK[j, :] by one of dS[i, j] times
    |q[i, :]| * scale; bounded by 2^-7 * max_i P (or |dS|) * max|dO| (or
    |q| * scale) a flip, two flips a key allowed (its sum runs over h * t
    queries with one KV head)."""
    q, k, v, dout, slopes, mask, lse, delta = bwd_cases((b, h, t, d, hk, causal, padded), dtype)
    scale = d**-0.5
    want_dk, want_dv = ref_bwd_dkv(q, k, v, slopes, mask, dout, lse, delta, causal, scale, dtype)
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    got_dk, got_dv = tflash.flash_attention_bwd_dkv_plain(tq, tk, tv, ts, tm, tdo, torch.from_numpy(lse),
                                                          torch.from_numpy(delta), causal, scale, one_pass=True)
    p, ds = plain_p_ds(q, k, v, dout, slopes, mask, lse, delta, causal, scale)
    for name, got, want, flip in (
        ("dv", got_dv, want_dv, 2 * BF16_ULP * per_key(p, hk) * np.abs(dout).max()),
        ("dk", got_dk, want_dk, 2 * BF16_ULP * per_key(ds, hk) * np.abs(q).max() * scale),
    ):
        tight = tight_tol(want, dtype)
        assert_close_but_flips(got.float().numpy(), want, tight, flip + tight, name)


def per_key(x, hk):
    """(b, hk, tk, 1): the largest |x| (b, h, tq, tk) over the queries, and
    with one KV head over the heads, that reach each key."""
    m = np.abs(x).max(axis=2)
    return (m.max(axis=1, keepdims=True) if hk == 1 else m)[..., None]


def plain_p_ds(q, k, v, dout, slopes, mask, lse, delta, causal, scale):
    """P and dS (b, h, tq, tk) in fp64 from the one-pass recompute, for the
    flip bounds (the JAX keys past t contribute only to dslopes)."""
    args = [torch.from_numpy(x).double() for x in (q, k, v, slopes)]
    p, ds, _ = tflash._bwd_plain_parts(*args, torch.from_numpy(mask), torch.from_numpy(dout).double(),
                                       torch.from_numpy(lse).double(), torch.from_numpy(delta).double(),
                                       causal, scale, True)
    return p.numpy(), ds.numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES, ids=CASE_IDS)
def test_one_pass_dq_is_the_tpus_default(bwd_cases, b, h, t, d, hk, causal, padded, dtype):
    """dQ and dslopes of the one-pass plain dQ/dslope function against
    `ref_bwd_dq`: dQ to `tight_tol` but where a tie of bf16(dS) flips, one
    flip moving dQ[i, :] by one bf16 ulp of dS[i, j] (at most 2^-7 of it)
    times |k[j, :]| * scale, bounded by 2^-7 * max_j |dS| * max|k| * scale
    (one flip a row); dslopes, from the unrounded dS, to 1e-5 * t as the
    fp32-accurate route's (the sum of b*t*t terms dS*|i-j| in another
    order)."""
    q, k, v, dout, slopes, mask, lse, delta = bwd_cases((b, h, t, d, hk, causal, padded), dtype)
    scale = d**-0.5
    want_dq, want_dslopes = ref_bwd_dq(q, k, v, slopes, mask, dout, lse, delta, causal, scale, dtype)
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    got_dq, got_dslopes = tflash.flash_attention_bwd_dq_plain(tq, tk, tv, ts, tm, tdo, torch.from_numpy(lse),
                                                              torch.from_numpy(delta), causal, scale, one_pass=True)
    _, ds = plain_p_ds(q, k, v, dout, slopes, mask, lse, delta, causal, scale)
    tight = tight_tol(want_dq, dtype)
    flip = BF16_ULP * np.abs(ds).max(axis=3)[..., None] * np.abs(k).max() * scale
    assert_close_but_flips(got_dq.float().numpy(), want_dq, tight, flip + tight, "dq")
    np.testing.assert_allclose(got_dslopes.numpy(), want_dslopes, atol=1e-5 * t, rtol=1e-5)


# ---- against the JAX package's function ----


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES[:4], ids=CASE_IDS[:4])
def test_one_pass_is_jax_flash_attention_within_bf16_rounding(b, h, t, d, hk, causal, padded, dtype):
    """The port's autograd Function in the one-pass mode (forward and
    backward) against `jax.vjp` of the JAX package's `flash_attention_alibi`
    at its default precision in interpret mode, which XLA computes in fp32
    on the CPU: they differ by the rounding of every dot's operands to bf16,
    2^-9 of each operand, so 2^-8 of each product. Each rounded product on
    an output's path adds at most one such step of the magnitudes it
    multiplies: o two (S, P.V), each gradient four (S, dP, then P or dS
    into its last product). Every output, with its own bf16 rounding for
    bf16 operands, holds to that many steps of its largest element and, on
    the whole tensor, in relative L2; dslopes, a sum of t*t terms that
    cancel, to four steps of the sum of their magnitudes, sum |dS|*|i-j|."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    want = jax_one_pass_reference(q, k, v, dout, slopes, mask, causal, dtype)
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    args = [x.requires_grad_() for x in (tq, tk, tv, ts)]
    with matmul_precision("medium"):
        o = tflash.flash_attention_alibi(*args, mask=tm, causal=causal)
    o.backward(tdo)
    assert_within_bf16_rounding([o] + [a.grad for a in args], want, args, tm, tdo, causal, padded)


def jax_one_pass_reference(q, k, v, dout, slopes, mask, causal, dtype):
    """[o, dq, dk, dv, dslopes] of `jax.vjp` of the JAX package's
    `flash_attention_alibi` at its default precision in interpret mode."""
    cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out, vjp = jax.vjp(lambda *a: jflash.flash_attention_alibi(*a, mask=jnp.asarray(mask), causal=causal,
                                                               interpret=True),
                       *(jnp.asarray(x, cast) for x in (q, k, v)), jnp.asarray(slopes))
    return [out] + list(vjp(jnp.asarray(dout, cast)))


def assert_within_bf16_rounding(got, want, args, tm, tdo, causal, padded):
    """The port's one-pass [o, dq, dk, dv, dslopes] against JAX's
    (`jax_one_pass_reference`) within the bf16 rounding of every dot's
    operands (test_one_pass_is_jax_flash_attention_within_bf16_rounding);
    `args` the port's q, k, v and slopes, o's forward inputs."""
    o, d = got[0], args[0].shape[-1]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.detach().float().numpy().astype(np.float64), np.asarray(jnp.asarray(w, jnp.float32), np.float64)
        if padded == "empty":
            g, w = g[1:], w[1:]  # the element with no valid key: unnormalized sums (test_torch_kernels)
        steps = 2 if name == "o" else 4
        assert np.abs(g - w).max() <= steps * BF16_ROUND * np.abs(w).max() + 1e-5, (name, np.abs(g - w).max())
        rel_l2 = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel_l2 <= steps * BF16_ROUND, (name, rel_l2)
    lse = tflash.flash_attention_plain(*(x.detach().double() for x in args), tm, causal, return_lse=True)[1]
    delta = (tdo.double() * o.detach().double()).sum(-1)
    _, ds, dist = tflash._bwd_plain_parts(*(x.detach().double() for x in args), tm, tdo.double(), lse, delta,
                                          causal, d**-0.5, True)
    magnitude = (ds.abs() * dist).sum(dim=(0, 2, 3)).numpy()
    np.testing.assert_array_less(np.abs(got[4].numpy() - np.asarray(want[4])), 4 * BF16_ROUND * magnitude + 1e-5)


# ---- what the wrappers hand the kernels ----


class AtenOps(TorchDispatchMode):
    """The names of the aten ops that run inside the block, but for those of
    a spy launcher (`in_launcher`)."""

    launchers = 0  # spy launchers running

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if AtenOps.launchers == 0:
            self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def in_launcher():
    AtenOps.launchers += 1
    try:
        yield
    finally:
        AtenOps.launchers -= 1


@pytest.fixture
def spy_launcher(monkeypatch):
    """The wrappers' kernel route forced on CPU tensors (`kernel_route`),
    with launchers in `_fwd_launch`'s and `_bwd_launch`'s place that record
    what each launch is handed, hold it to the launch's own checks
    (`_fwd_args`, `_bwd_args`) and compute it with the plain version (the
    slope gradient as the first block's part), as `in_launcher`. Returns
    the list of launches, in order."""
    launches = []

    def fwd_launch(q, k, v, slopes, mask, causal, scale, one_pass):
        with in_launcher():
            tflash._fwd_args(q, k, v, slopes, mask)
            launches.append({"name": "flash_attention_fwd", "one_pass": one_pass, "operands": (q, k, v),
                             "scale": scale})
            return tflash.flash_attention_plain(q, k, v, slopes, mask, causal, scale, return_lse=True,
                                                one_pass=one_pass)

    def launch(name, symbol, q, k, v, slopes, mask, dout, lse, delta, causal, scale, outs, one_pass):
        with in_launcher():
            tflash._bwd_args(name, q, k, v, slopes, mask, dout, lse, delta, outs)
            launches.append({"name": name, "one_pass": one_pass, "operands": (q, k, v, dout),
                             "outs": [o.dtype for o in outs]})
            args = (q, k, v, slopes, mask, dout, lse, delta, causal, scale, one_pass)
            if name.endswith("dkv"):
                for o, x in zip(outs, tflash.flash_attention_bwd_dkv_plain(*args)):
                    o.copy_(x)
            else:
                dq, dslopes = tflash.flash_attention_bwd_dq_plain(*args)
                outs[0].copy_(dq)
                outs[1].zero_()
                outs[1][0, :, 0] = dslopes

    monkeypatch.setattr(tflash, "kernel_route", lambda device: True)
    monkeypatch.setattr(tflash, "_fwd_launch", fwd_launch)
    monkeypatch.setattr(tflash, "_bwd_launch", launch)
    return launches


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES[:4], ids=CASE_IDS[:4])
def test_one_pass_backward_hands_the_kernels_its_operands_unrounded(spy_launcher, b, h, t, d, hk, causal, padded,
                                                                    dtype):
    """Through the kernel route, the one-pass backward wrappers launch each
    kernel once, on q, k, v and dO as the autograd Function holds them: fp32
    operands unrounded (the kernels round them, csrc/flash_attention_bwd_bf16.cu),
    with fp32 gradients; bf16 operands as before, with bf16 gradients. Each
    launch counts once in `launches_one_pass`. The gradients the launches
    give (the one-pass plain version standing in for the kernels) hold to
    JAX's `flash_attention_alibi` in interpret mode within the bf16 rounding
    of every dot's operands (`assert_within_bf16_rounding`)."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    want = jax_one_pass_reference(q, k, v, dout, slopes, mask, causal, dtype)
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    args = [x.requires_grad_() for x in (tq, tk, tv, ts)]
    counts = {fn: fn.launches_one_pass for fn in (tflash.flash_attention_bwd_dkv, tflash.flash_attention_bwd_dq)}
    with matmul_precision("medium"):
        o = tflash.flash_attention_alibi(*args, mask=tm, causal=causal)
    o.backward(tdo)
    assert [x["name"] for x in spy_launcher] == ["flash_attention_fwd", "flash_attention_bwd_dkv",
                                                 "flash_attention_bwd_dq"]
    assert {fn: fn.launches_one_pass - n for fn, n in counts.items()} == {fn: 1 for fn in counts}
    cast = torch.bfloat16 if dtype == "bf16" else torch.float32
    for launch in spy_launcher[1:]:
        assert launch["one_pass"]
        assert launch["outs"][0] == cast and (launch["name"].endswith("dq") or launch["outs"][1] == cast)
        for handed, mine in zip(launch["operands"], (tq, tk, tv, tdo)):
            assert handed.dtype == cast and handed.data_ptr() == mine.data_ptr() and torch.equal(handed, mine)
    if dtype == "fp32":
        assert not any(torch.equal(x, x.bfloat16().float()) for x in (tq, tk, tv, tdo))
    assert_within_bf16_rounding([o] + [a.grad for a in args], want, args, tm, tdo, causal, padded)


def test_one_pass_backward_launch_refuses_mixed_dtypes():
    """The launch's checks take fp32 or bf16 operands of one dtype, and
    gradients in it."""
    q, k, v, dout, slopes, mask = inputs(1, 2, 9, 16, 1, False, "fp32")
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, "fp32")
    lse, delta = torch.zeros(1, 2, 9), torch.zeros(1, 2, 9)
    name = "flash_attention_bwd_dkv"
    tflash._bwd_args(name, tq, tk, tv, ts, tm, tdo, lse, delta, (torch.empty_like(tk), torch.empty_like(tv)))
    with pytest.raises(TypeError, match="one dtype"):
        tflash._bwd_args(name, tq, tk.bfloat16(), tv, ts, tm, tdo, lse, delta, (tk, tv))
    with pytest.raises(TypeError, match="gradients"):
        tflash._bwd_args(name, tq, tk, tv, ts, tm, tdo, lse, delta, (tk.bfloat16(), tv))


# (b, h, t, d, kv heads, causal, padded): MQA, MHA, and a head dim the
# kernels are not built for (48, at the built 64)
FWD_HANDED = [(2, 4, 65, 64, 1, True, True), (2, 2, 37, 32, 2, True, False), (2, 4, 40, 48, 1, False, "empty")]
FWD_HANDED_IDS = [f"b{b}h{h}t{t}d{d}hk{hk}{'c' if c else ''}{'-' + str(p) if p else ''}"
                  for b, h, t, d, hk, c, p in FWD_HANDED]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FWD_HANDED, ids=FWD_HANDED_IDS)
def test_one_pass_forward_hands_the_kernel_its_operands_as_received(spy_launcher, monkeypatch, b, h, t, d, hk,
                                                                    causal, padded, dtype):
    """Through the kernel route, the one-pass forward wrapper launches the
    kernel once, counted in `launches_one_pass`, on q, k and v as it
    receives them, fp32 or bf16, with the real scale d**-0.5: the kernel
    scales q and rounds q, k and v itself (csrc/flash_attention_fwd_bf16.cu).
    Outside the launch it runs no aten op at all (no copy, cast or
    multiply); at a head dim the kernels are not built for (d 48, the
    kernels' padded layout forced on the CPU) only `_at_built_width`'s: the
    zero-padded copies of q, k and v at the built width, handed over in
    their dtype, and o cut back. o (the one-pass plain version standing in
    for the kernel) holds to JAX's `flash_attention_alibi` at its default
    precision in interpret mode within the bf16 rounding of the operands."""
    from scoreperformer_tpu_torch.ops import head_layout

    monkeypatch.setattr(head_layout, "kernel_layout", lambda device: True)
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    tq, tk, tv, _, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    count = tflash.flash_attention_fwd.launches_one_pass
    with AtenOps() as recorded:
        o, lse = tflash.flash_attention_fwd(tq, tk, tv, ts, tm, causal, one_pass=True)
    assert [x["name"] for x in spy_launcher] == ["flash_attention_fwd"]
    assert tflash.flash_attention_fwd.launches_one_pass - count == 1
    launch = spy_launcher[0]
    assert launch["one_pass"] and launch["scale"] == d**-0.5
    cast = torch.bfloat16 if dtype == "bf16" else torch.float32
    width = tflash.kernel_head_dim(d)
    for handed, mine in zip(launch["operands"], (tq, tk, tv)):
        assert handed.dtype == cast and handed.shape[-1] == width
        assert torch.equal(handed[..., :d], mine) and not handed[..., d:].any()
        assert (handed.data_ptr() == mine.data_ptr()) == (width == d)
    wide = torch.zeros(b, h, t, width, dtype=cast)
    with AtenOps() as layout:
        tflash._to_built_width(tq, tk, tv, ts, tm)
        tflash._cut(wide, d)
    assert recorded.ops == (layout.ops if width != d else [])
    assert not {"_to_copy", "mul"} & set(recorded.ops)
    assert o.dtype == cast and o.shape == tq.shape and lse.shape == (b, h, t)
    want = jflash.flash_attention_alibi(*(jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
                                          for x in (q, k, v)), jnp.asarray(slopes), mask=jnp.asarray(mask),
                                        causal=causal, interpret=True)
    g, w = o.float().numpy().astype(np.float64), np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    if padded == "empty":
        g, w = g[1:], w[1:]  # the element with no valid key: unnormalized sums (test_torch_kernels)
    assert np.abs(g - w).max() <= 2 * BF16_ROUND * np.abs(w).max() + 1e-5
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2 * BF16_ROUND


def test_one_pass_forward_launch_refuses_mixed_dtypes():
    """The forward launch's checks take fp32 or bf16 q, k and v of one
    dtype."""
    q, k, v, dout, slopes, mask = inputs(1, 2, 9, 16, 1, False, "fp32")
    tq, tk, tv, _, ts, tm = port_inputs(q, k, v, dout, slopes, mask, "fp32")
    tflash._fwd_args(tq, tk, tv, ts, tm)
    tflash._fwd_args(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), ts, tm)
    for args in ((tq, tk.bfloat16(), tv), (tq.bfloat16(), tk, tv), (tq, tk, tv.bfloat16()), (tq.half(), tk, tv)):
        with pytest.raises(TypeError, match="one dtype"):
            tflash._fwd_args(*args, ts, tm)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES, ids=CASE_IDS)
def test_one_pass_forward_is_the_same_on_x_and_its_bf16_rounding(b, h, t, d, hk, causal, padded, dtype):
    """The one-pass plain forward on q, k and v with the scale s equals it,
    bit for bit (o and lse), on bf16(q*s), bf16(k) and bf16(v) (in fp32 for
    fp32 operands) with scale 1: its S takes q scaled, then rounded. The
    card holds the kernel, which scales and rounds in the kernel, to the
    same invariant (chip_smoke.check_flash_one_pass)."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    tq, tk, tv, _, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    scale = d**-0.5
    rounded = [x.to(tq.dtype) for x in ((tq.float() * scale).bfloat16(), tk.bfloat16(), tv.bfloat16())]
    with matmul_precision("medium"):
        on_x = tflash.flash_attention_plain(tq, tk, tv, ts, tm, causal, scale, return_lse=True, one_pass=True)
        on_rounded = tflash.flash_attention_plain(*rounded, ts, tm, causal, 1.0, return_lse=True, one_pass=True)
    if dtype == "fp32":
        assert not torch.equal(tq, tq.bfloat16().float())  # x is not bf16 already
    assert not torch.equal(rounded[0].float(), tq.float())  # the scale moved q
    for name, x, y in zip(("o", "lse"), on_x, on_rounded):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES, ids=CASE_IDS)
def test_one_pass_backward_is_the_same_on_x_and_its_bf16_rounding(b, h, t, d, hk, causal, padded):
    """The one-pass plain backward on fp32 operands x equals it on
    fp32(bf16(x)) bit for bit (dk, dv, dq, dslopes): every use of q, k, v
    and dO rounds them first. The card holds the kernels, which round in
    the kernel, to the same invariant (chip_smoke.check_flash_one_pass)."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, "fp32")
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, "fp32")
    with matmul_precision("medium"):
        o, lse = tflash.flash_attention_plain(tq, tk, tv, ts, tm, causal, return_lse=True, one_pass=True)
        delta = (tdo * o).sum(-1)
        runs = []
        for x in ((tq, tk, tv, tdo), [y.bfloat16().float() for y in (tq, tk, tv, tdo)]):
            args = (*x[:3], ts, tm, x[3], lse, delta, causal)
            runs.append(tflash.flash_attention_bwd_dkv_plain(*args, one_pass=True)
                        + tflash.flash_attention_bwd_dq_plain(*args, one_pass=True))
    assert not torch.equal(tq, tq.bfloat16().float())  # x is not bf16 already
    for name, x, y in zip(("dk", "dv", "dq", "dslopes"), *runs):
        assert torch.equal(x, y), name


# ---- the switch: PyTorch's matmul precision ----


class matmul_precision:
    """torch.set_float32_matmul_precision(`value`) inside the block."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(self.value)

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved)


def attention_and_grads(q, k, v, slopes, mask, dout, causal, **kw):
    args = [x.clone().requires_grad_() for x in (q, k, v, slopes)]
    o = tflash.flash_attention_alibi(*args, mask=mask, causal=causal, **kw)
    o.backward(dout)
    return [o.detach()] + [a.grad for a in args]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", CASES[:3], ids=CASE_IDS[:3])
def test_default_precision_is_today_s_route_bit_for_bit(b, h, t, d, hk, causal, padded, dtype):
    """Under PyTorch's default matmul precision ("highest"), and under "high",
    "default", "high" and "highest" all take the fp32-accurate route: o and
    every gradient equal, bit for bit, the plain functions without the
    one-pass mode (what the port computed before `precision` existed)."""
    q, k, v, dout, slopes, mask = inputs(b, h, t, d, hk, padded, dtype)
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, dtype)
    assert torch.get_float32_matmul_precision() == "highest"
    o, lse = tflash.flash_attention_plain(tq, tk, tv, ts, tm, causal, return_lse=True)
    delta = (tdo * o).sum(-1).float()
    want = [o] + list(tflash.flash_attention_bwd_plain(tq, tk, tv, ts, tm, tdo, lse, delta, causal))
    want = [want[0], want[1], want[2], want[3], want[4]]
    for global_precision in ("highest", "high"):
        with matmul_precision(global_precision):
            for precision in tflash.PRECISIONS:
                got = attention_and_grads(tq, tk, tv, ts, tm, tdo, causal, precision=precision)
                for name, g, w in zip(("o", "dq", "dk", "dv", "dslopes"), got, want):
                    assert torch.equal(g, w), (global_precision, precision, name)


def test_unknown_precision_names_raise_as_jax_s():
    q, k, v, dout, slopes, mask = inputs(1, 2, 9, 16, 1, False, "fp32")
    args = [torch.from_numpy(x) for x in (q, k, v, slopes)]
    for name in ("fastest", "DEFAULT", "bf16_3x"):
        with pytest.raises(KeyError):
            jflash.flash_attention_alibi(*map(jnp.asarray, (q, k, v, slopes)), interpret=True, precision=name)
        with pytest.raises(KeyError):
            tflash.flash_attention_alibi(*args, precision=name)


def test_backward_keeps_the_forward_s_mode():
    """The mode is resolved once, in the forward: a backward run after the
    global precision changed takes the forward's mode, both ways."""
    q, k, v, dout, slopes, mask = inputs(2, 4, 65, 64, 1, True, "fp32")
    tq, tk, tv, tdo, ts, tm = port_inputs(q, k, v, dout, slopes, mask, "fp32")
    with matmul_precision("medium"):
        one_pass = attention_and_grads(tq, tk, tv, ts, tm, tdo, True)
    fp32 = attention_and_grads(tq, tk, tv, ts, tm, tdo, True)
    assert not any(torch.equal(a, b) for a, b in zip(one_pass, fp32))
    for mode, outside, ref in (("medium", "highest", one_pass), ("highest", "medium", fp32)):
        args = [x.clone().requires_grad_() for x in (tq, tk, tv, ts)]
        with matmul_precision(mode):
            o = tflash.flash_attention_alibi(*args, mask=tm, causal=True)
        with matmul_precision(outside):
            o.backward(tdo)
        for name, g, w in zip(("o", "dq", "dk", "dv", "dslopes"), [o.detach()] + [a.grad for a in args], ref):
            assert torch.equal(g, w), (mode, name)


@pytest.mark.parametrize("global_precision", ["medium", "highest"])
def test_a_flagship_shaped_model_takes_the_route_the_precision_names(global_precision, monkeypatch):
    """A tiny model shaped as the flagship (4 heads, one KV head, learned
    ALiBi, `use_flash` in every stack) calls the op with no precision, as
    JAX's module does: under "medium" every flash forward and backward call
    takes the one-pass mode and the loss and gradients differ from the
    fp32-accurate route's; under "highest" none does."""
    batch = train_batch(b=2, t=20)
    cfg = shaped_config(64, 4, 16, (1, 1, 1))
    modes = []
    for name in ("_fwd", "_bwd_dkv", "_bwd_dq"):
        fn = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, lambda *a, _fn=fn, _name=name: modes.append((_name, a[-1])) or _fn(*a))

    def step(precision):
        model, _ = build_model("ScorePerformer", cfg, device="cpu", seed=0)
        model.train()
        gen = torch.Generator().manual_seed(0)
        sampler = lambda d, n: (torch.randn(16, d, generator=gen),  # noqa: E731
                                torch.rand(64, generator=gen) if n > 64 else None)
        with matmul_precision(precision):
            out = model(**port_batch(batch), mmd_sampler=sampler)
            out.loss.backward()
        return out.loss.item(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    loss, grads = step(global_precision)
    assert modes and {name for name, _ in modes} == {"_fwd", "_bwd_dkv", "_bwd_dq"}
    assert all(one_pass == (global_precision == "medium") for _, one_pass in modes), modes
    modes.clear()
    ref_loss, ref_grads = step("highest")
    attention = [n for n in grads if n.endswith(("to_q.weight", "to_k.weight", "learned_logslopes"))]
    assert attention
    if global_precision == "medium":
        assert loss != ref_loss and any(not torch.equal(grads[n], ref_grads[n]) for n in attention)
    else:
        assert loss == ref_loss and all(torch.equal(grads[n], ref_grads[n]) for n in grads)

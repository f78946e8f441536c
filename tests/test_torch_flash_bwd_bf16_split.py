"""The arithmetic of the bf16 flash backward kernels
(csrc/flash_attention_bwd_bf16.cu), emulated in torch on the CPU, against the
JAX package's Pallas kernels.

The kernels take S = q.K^T and dP = dO.V^T as single bf16 `wgmma` products
(exact in fp32), split the fp32 P and dS into three bf16 terms (hi, mid, lo)
for P^T.dO, dS^T.q and dS.K, sum each 64-row tile's products from zero and
join the tiles by rounded fp32 adds. The emulation here does the same on the
same bf16 inputs and is held within one bf16 ulp of `jax.vjp` of the Pallas
kernels in interpret mode at "highest" precision (the gate of
test_torch_bf16.py); the kernels themselves are held to the plain versions
on the card by chip_smoke.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from scoreperformer_tpu.ops import flash_attention as jflash

from scoreperformer_tpu_torch.ops import flash_attention as tflash

from test_torch_bf16 import assert_within_one_ulp, tbf16, ulp_floor
from test_torch_kernels import FLASH_CASES, flash_inputs, rand

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "scoreperformer_tpu_torch" / "csrc"
TILE = 64  # rows of the summed dimension a tile: query rows for dK/dV, keys for dQ
# below this magnitude the third term falls under bf16's smallest subnormal
# (2^-133): the split is exact above it, within 2^-134 below
EXACT_ABOVE = 2.0**-110
# bf16's largest finite value: hi of anything larger rounds to infinity (P is
# at most 1 and dS far below this)
BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def split3(x):
    """fp32 x as the kernels' three bf16 terms, as fp32 values: hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
    nearest even (wgmma.cuh::split3)."""
    hi = x.to(torch.bfloat16).float()
    rest = x - hi
    mid = rest.to(torch.bfloat16).float()
    lo = (rest - mid).to(torch.bfloat16).float()
    return hi, mid, lo


@settings(max_examples=400, deadline=None)
@given(st.floats(-BF16_MAX, BF16_MAX, width=32, allow_subnormal=True))
def test_three_bf16_terms_carry_an_fp32_value(x):
    """hi + mid + lo reconstructs x within 2^-24 of its magnitude (exactly
    where the terms stay above bf16's subnormals), or within half of bf16's
    smallest subnormal for the tiniest values."""
    t = torch.tensor([x], dtype=torch.float32)
    terms = split3(t)
    assert all(p.dtype == torch.float32 and torch.equal(p, p.to(torch.bfloat16).float()) for p in terms)
    got = sum(p.double() for p in terms).item()
    err = abs(got - float(t.item()))
    assert err <= max(2.0**-24 * abs(x), 2.0**-134)
    if abs(x) >= EXACT_ABOVE:
        assert err == 0.0


def test_the_mask_values_p_splits_exactly():
    """P = exp(-1e30 - lse) is 0 on a masked key of a row with a valid key
    and 1 on a row with no valid key (lse = -1e30): both are hi alone."""
    lse = torch.tensor([3.5, tflash.NEG_INF], dtype=torch.float32)
    p = torch.exp(torch.tensor(tflash.NEG_INF, dtype=torch.float32) - lse)
    assert p.tolist() == [0.0, 1.0]
    hi, mid, lo = split3(p)
    assert hi.tolist() == [0.0, 1.0] and mid.tolist() == [0.0, 0.0] and lo.tolist() == [0.0, 0.0]


def tiled_sum(a, b, order):
    """sum_n a[..., m, n] * b[..., n, :] as the kernels take it: a in three
    bf16 terms, each tile of TILE rows of n from zero with exact products
    (rounded to fp32 once), the tiles joined by fp32 adds in order. a:
    (..., m, n) fp32, b: (..., n, d) bf16 values; returns the (..., m, d)
    tile sums stacked on a new dim -3, before `order` joins them."""
    n = a.shape[-1]
    pad = -n % TILE
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    tiles = (n + pad) // TILE
    a = a.unflatten(-1, (tiles, TILE)).movedim(-2, -3)  # (..., tiles, m, TILE)
    b = b.unflatten(-2, (tiles, TILE)).double()  # (..., tiles, TILE, d)
    parts = sum(term.double() @ b for term in split3(a)).float()  # (..., tiles, m, d)
    return order(parts)


def join(parts, dims):
    """fp32 running sum of `parts` over the leading positions of `dims` (a
    tuple of dims of parts, the outer one first), in that order."""
    flat = parts.movedim(dims, tuple(range(len(dims)))).flatten(0, len(dims) - 1)
    acc = torch.zeros_like(flat[0])
    for x in flat:
        acc = acc + x
    return acc


def dkv_split(blocks, h, hk, sms=132):
    """The CTAs of a dK/dV cluster that split a KV head's query heads
    (launch_dkv's rule; 132 SMs, the H100's)."""
    split = 1
    while hk == 1 and split < 8 and h % (2 * split) == 0 and blocks * split < 4 * sms:
        split *= 2
    return split


def join_heads(parts, split):
    """dK/dV's sums of (b, h, tiles, tk, d) tile sums with one KV head:
    each of `split` CTAs joins its heads' tiles in order, then the CTAs' sums
    join in rank order."""
    n = parts.shape[1] // split
    sums = [join(parts[:, c * n:(c + 1) * n], (1, 2)) for c in range(split)]
    acc = sums[0]
    for x in sums[1:]:
        acc = acc + x
    return acc


def emulate_bwd(q, k, v, slopes, mask, dout, lse, delta, causal, scale):
    """(dq, dk, dv, dslopes) by the bf16 kernels' arithmetic, with the
    wrapper's sum of the slope parts and the padded keys' part."""
    b, h, tq, _ = q.shape
    hk, tk = k.shape[1], k.shape[2]
    qf, kf, vf, of = (x.float() for x in (q, k, v, dout))
    # S and dP: exact bf16 products, one fp32 rounding
    s = (qf.double() @ kf.double().transpose(-1, -2)).float() * scale
    dp = (of.double() @ vf.double().transpose(-1, -2)).float()
    valid, dist = tflash._valid(b, tq, tk, mask, causal, q.device)
    x = torch.where(valid, s - slopes.float()[None, :, None, None] * dist, torch.tensor(tflash.NEG_INF))
    limit = tflash.jax_masked_row_keys(tq, tk, causal) if causal else torch.full((tq,), tk)
    p = torch.where(torch.arange(tk)[None, :] < limit[:, None], torch.exp(x - lse[..., None]), 0.0)
    ds = p * (dp - delta[..., None])
    # dV = P^T.dO, dK = scale * dS^T.q: tiles of query rows, the items of a
    # KV head (its query heads, then their tiles) in order, with one KV head
    # split over a cluster's CTAs
    split = dkv_split(-(-tk // TILE) * b * hk, h, hk)
    order = (lambda t: join_heads(t, split)) if hk == 1 else (lambda t: join(t, (2,)))
    dv = tiled_sum(p.transpose(-1, -2), of, order)
    dk = tiled_sum(ds.transpose(-1, -2), qf, order) * scale
    if hk == 1:
        dv, dk = dv[:, None], dk[:, None]
    # dQ = scale * dS.K: tiles of keys in order
    dq = tiled_sum(ds, kf.expand(b, h, tk, -1), lambda t: join(t, (2,))) * scale
    dslopes = (ds.double() * -dist.double()).sum(dim=(0, 2, 3)).float()
    padded = tflash.padded_key_dslopes(lse, delta, tq, tk, causal)
    if padded is not None:
        dslopes = dslopes + padded
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dslopes


KERNEL_CASES = [c for c in FLASH_CASES if c[3] in tflash.KERNEL_HEAD_DIMS]


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", KERNEL_CASES)
def test_kernel_arithmetic_matches_pallas_kernels(b, h, t, d, hk, causal, padded):
    """dq, dk, dv and dslopes by the kernels' arithmetic (exact bf16 S and
    dP, three-term P and dS, per-tile fp32 sums, the MQA head sum over a
    cluster's CTAs) within one bf16 ulp of `jax.vjp` of the Pallas kernels in
    interpret mode at "highest", on the same bf16 q, k, v, slopes and dout,
    with test_torch_bf16.py's `ulp_floor`; lse and delta as the autograd
    Function takes them (the plain forward's lse, delta the bf16 row sum)."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
    _, vjp = jax.vjp(
        lambda *a: jflash.flash_attention_alibi(*a, mask=jnp.asarray(mask), causal=causal,
                                                interpret=True, precision="highest"),
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, slopes)),
    )
    want = vjp(jnp.asarray(dout, jnp.bfloat16))
    tq, tk, tv, ts, to = (tbf16(a) for a in (q, k, v, slopes, dout))
    tm = torch.from_numpy(mask)
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, ts, mask=tm, causal=causal)
    delta = (to * out).sum(-1).float()
    got = emulate_bwd(tq, tk, tv, ts, tm, to, lse, delta, causal, d**-0.5)
    for name, w, g in zip(("dq", "dk", "dv", "dslopes"), want, got[:3] + (got[3].to(torch.bfloat16),)):
        assert_within_one_ulp(g.float().numpy(), np.asarray(w.astype(jnp.float32)), name, ulp_floor(d))


def test_bf16_kernel_head_dims_are_the_cuda_dispatch_cases():
    """The bf16 backward source's head-dim switch has the wrapper's head
    dims as its `case` labels."""
    text = (CSRC / "flash_attention_bwd_bf16.cu").read_text()
    switch = re.search(r"switch \(d\) \{(.*?)default:", text, re.S)
    assert switch is not None
    cases = tuple(sorted(int(c) for c in re.findall(r"case (\d+):", switch.group(1))))
    assert cases == tflash.KERNEL_HEAD_DIMS


def test_backward_probe_variants_apply_to_the_sources():
    """chip_probe_flash_bwd.py builds the fp32 backward's variants by exact
    text edits of csrc/flash_attention_bwd.cu (one TF32 product a product,
    no tile loops, no cluster split): each edit still finds its text."""
    import chip_probe_flash_bwd

    base = (CSRC / "flash_attention_bwd.cu").read_text()
    sources = chip_probe_flash_bwd.variants(base)
    assert sorted(sources) == ["base", "no_cluster", "no_loop", "one_mma"]
    assert sources["base"] == base
    assert all(cu != base for name, cu in sources.items() if name != "base")

"""The arithmetic of the fp32 flash forward kernel
(csrc/flash_attention_fwd.cu), emulated in torch on the CPU, against the
JAX package's Pallas kernel and the port's plain version.

The kernel takes both products on split-TF32 `wgmma`, each k-step from
zero and the k-steps joined in order by rounded fp32 adds: S = (q*scale).K^T
over 8 of d a chain, as the fp32 backward takes S; P.V over 8 keys a chain,
each joined to the running o after o = alpha*o. Inside a chain every wgmma
add rounds toward zero, as the tensor cores round (`tf32_chains`). The
online softmax runs over key tiles of `FWD_KEY_TILE[d]` keys in fp32, exp as
the kernel's `__expf`. A row block may visit key tiles past a
row's keys (causal rows of one CTA, tiles of masked keys): there P is
exactly 0 and alpha exactly 1, or the sums are wiped exactly by alpha = 0
once a valid key arrives, so the emulation walks every tile for every row.
The kernel itself is held to the plain version on the card by
chip_smoke.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scoreperformer_tpu.ops.flash_attention import _flash_forward

from scoreperformer_tpu_torch.models.layers import alibi_slopes
from scoreperformer_tpu_torch.ops import flash_attention as tflash

from test_torch_flash_fwd_bf16_split import fast_exp
from test_torch_kernels import FLASH_CASES, K_STEP, flash_inputs, tf32_chains

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "scoreperformer_tpu_torch" / "csrc"
# csrc/flash_attention_fwd.cu's key tiles by head dim (FwdSmem::kKeys)
FWD_KEY_TILE = {16: 64, 32: 32, 64: 32, 128: 32}

# FLASH_CASES at the kernel's head dims, and d = 64 (the flagship's and
# scale_1024's encoders'): MQA causal and padded, MHA with an element that
# has no valid key
KERNEL_CASES = [c for c in FLASH_CASES if c[3] in tflash.KERNEL_HEAD_DIMS] + [
    (2, 4, 130, 64, 1, True, True),
    (2, 2, 70, 64, 2, False, "empty"),
]
# every FLASH_CASES case at every head dim the kernel takes
ALL_DIM_CASES = sorted({(b, h, t, d, hk, causal, padded) for b, h, t, _, hk, causal, padded in FLASH_CASES
                        for d in tflash.KERNEL_HEAD_DIMS}, key=str)


def emulate_fp32_fwd(q, k, v, slopes, mask, causal, one=False):
    """(o, lse) by csrc/flash_attention_fwd.cu's arithmetic: S by one-k-step
    chains joined by fp32 adds, the masked online softmax over key tiles of
    FWD_KEY_TILE[d] keys (P = 0 at and past a row's key limit, P = 1 below it
    on a row with no valid key), exp as the kernel's `__expf`, o = o * alpha,
    then each of the tile's 8-key P.V chains added in turn; a row with no
    valid key divided by the JAX wrapper's padded key count. `one`: one TF32
    product a product instead of three."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    tile = FWD_KEY_TILE[d]
    s = tf32_chains(q * d**-0.5, k.transpose(-1, -2), K_STEP, one)  # one KV head broadcasts
    valid, dist = tflash._valid(b, tq, tk, mask, causal, q.device)
    x = torch.where(valid, s - slopes[None, :, None, None] * dist, torch.tensor(tflash.NEG_INF))
    limit = tflash.jax_masked_row_keys(tq, tk, True) if causal else torch.full((tq,), tk)
    keys = torch.arange(tk)
    m = torch.full((b, h, tq, 1), tflash.NEG_INF)
    l = torch.zeros(b, h, tq, 1)
    acc = torch.zeros(b, h, tq, d)
    for k0 in range(0, tk, tile):
        xt = x[..., k0:k0 + tile]
        mx = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = fast_exp(m - mx)
        p = torch.where(keys[None, k0:k0 + tile] < limit[:, None], fast_exp(xt - mx), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for c in range(0, p.shape[-1], K_STEP):
            acc = acc + tf32_chains(p[..., c:c + K_STEP], v[..., k0 + c:k0 + c + K_STEP, :], K_STEP, one)
        m = mx
    count = tflash.jax_masked_row_keys(tq, tk, causal)[:, None].float()
    lc = torch.where(m == tflash.NEG_INF, count, l.clamp_min(1e-30))
    return acc / lc, (m + torch.log(lc))[..., 0]


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", KERNEL_CASES)
def test_fp32_forward_arithmetic_matches_pallas_kernel(b, h, t, d, hk, causal, padded):
    """o and lse by the kernel's arithmetic within 1e-5 of the Pallas kernel
    in interpret mode at "highest" (test_flash_plain_matches_pallas_kernel's
    gate), with ragged t, MQA and MHA, key padding and rows whose keys are
    all masked."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    scale = d**-0.5
    want_o, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes),
        jnp.asarray(mask, jnp.float32), causal, scale, 256, 256, True, "highest", return_lse=True,
    )
    got_o, got_lse = emulate_fp32_fwd(*(torch.from_numpy(a) for a in (q, k, v, slopes, mask)), causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", ALL_DIM_CASES)
def test_fp32_forward_arithmetic_matches_plain(b, h, t, d, hk, causal, padded):
    """The emulation and the port's plain version (what chip_smoke.py holds
    the kernel to on the card) agree within 1e-5 on o and lse, on every
    FLASH_CASES case at every head dim the kernel takes."""
    args = [torch.from_numpy(a) for a in flash_inputs(b, h, t, d, hk, padded)]
    want_o, want_lse = tflash.flash_attention_plain(*args[:4], mask=args[4], causal=causal, return_lse=True)
    got_o, got_lse = emulate_fp32_fwd(*args, causal)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,padded", [(False, True), (True, True), (False, "empty"), (True, "empty")],
                         ids=["padded", "causal", "empty", "causal_empty"])
@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
def test_fp32_forward_split_chains_hold_and_one_product_does_not(d, causal, padded):
    """At the encoders' length (t = 384, 4 heads, one KV head, a 4-head
    model's ALiBi slopes, as test_flash_split_tf32_arithmetic_matches_plain)
    the kernel's chains stay within 1e-5 of the fp32 plain version on o and
    lse at every head dim; one TF32 product a product does not."""
    q, k, v, _, mask = map(torch.from_numpy, flash_inputs(2, 4, 384, d, 1, padded))
    slopes = alibi_slopes(4)
    want_o, want_lse = tflash.flash_attention_plain(q, k, v, slopes, mask=mask, causal=causal, return_lse=True)

    def error(one):
        got_o, got_lse = emulate_fp32_fwd(q, k, v, slopes, mask, causal, one=one)
        return max((got_o - want_o).abs().max().item(), (got_lse - want_lse).abs().max().item())

    assert error(False) <= 1e-5
    assert error(True) > 1e-5


@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
def test_fp32_forward_pv_chains_do_not_drift_toward_zero(d):
    """P.V by the kernel's chains (each 8-key k-step's three products from
    zero, joined by rounded fp32 adds) errs toward zero by a mean under half
    of fp32's relative step (2**-23 |x|) at every head dim, on softmax
    weights of a 4-head model's scores over 64 keys; one chain over the 64
    keys, where each of its 24 wgmmas truncates, drifts toward zero by more
    than 3 steps. That drift reaches the backward through o (delta =
    rowsum(dO * o)) and lse: on the card, 64-key chains moved a batch-4
    train step's ALiBi slope gradients at d = 16 to 1.99e-3 of the CPU's,
    past chip_smoke.py's 1e-3 gate; one k-step a chain gave 1.9e-4."""
    q, k, v, _, mask = map(torch.from_numpy, flash_inputs(2, 4, 384, d, 1, True))
    s, _ = tflash._scores(q, k, alibi_slopes(4), mask, False, d**-0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))[..., :64]
    exact = p.double() @ v[..., :64, :].double()

    def drift(tile):
        err = (tf32_chains(p, v[..., :64, :], tile).double() - exact) * exact.sign()
        return (err.mean() / (exact.abs().mean() * 2.0**-23)).item()

    assert abs(drift(K_STEP)) < 0.5
    assert drift(64) < -3


def test_fp32_forward_dispatch_cases_and_tiles_are_the_emulations():
    """csrc/flash_attention_fwd.cu dispatches the wrapper's head dims, its
    key tiles are the ones `emulate_fp32_fwd` takes, and both products take
    one k-step a chain: S sums over d in split_ss_sum's D / 8 k-steps, P.V
    over a tile's keys in split_rs's, each from zero."""
    text = (CSRC / "flash_attention_fwd.cu").read_text()
    switch = re.search(r"switch \(d\) \{(.*?)default:", text, re.S)
    assert switch is not None
    assert tuple(sorted(int(c) for c in re.findall(r"case (\d+):", switch.group(1)))) == tflash.KERNEL_HEAD_DIMS
    keys = re.search(r"static constexpr int kKeys = D == 16 \? (\d+) : (\d+);", text)
    assert keys is not None
    assert FWD_KEY_TILE == {d: int(keys.group(1 if d == 16 else 2)) for d in tflash.KERNEL_HEAD_DIMS}
    assert "split_ss_sum<Kt, QT, KT, D / 8>(s, q_at, k_at);" in text
    assert "split_rs<D, VT>(t[kk & 1], a[kk], v_at, kk);" in text
    assert "wg::tf32_rs<N>(d, a[1], B::desc_k(b, kk), 0);" in text


def test_probe_variants_apply_to_the_source():
    """chip_probe_flash_fwd.py builds the fp32 forward's variants by exact
    text edits of its source: each edit still finds its text."""
    import chip_probe_flash_fwd

    base = (CSRC / "flash_attention_fwd.cu").read_text()
    sources = chip_probe_flash_fwd.variants(base)
    assert sorted(sources) == ["base", "expf", "keys64", "no_loop", "one_group"]
    assert all(text != base for name, text in sources.items() if name != "base")
    assert "__expf(" not in sources["expf"]

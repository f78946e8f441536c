"""The arithmetic of the bf16 flash forward kernel
(csrc/flash_attention_fwd_bf16.cu), emulated in torch on the CPU, against the
JAX package's Pallas kernel.

The kernel takes S = q.K^T as a single bf16 `wgmma` product (exact in fp32)
with the scale applied to S afterwards, where the Pallas kernel scales q
before the dot; it runs the online softmax over tiles of 64 keys in fp32,
splits P into three bf16 terms (hi, mid, lo) for P.V, sums each tile's
products from zero and joins them to the running o by rounded fp32
operations (o * alpha, then + tile); its exp is `__expf`. The emulation
here does the same on the same bf16 inputs and is held within one bf16 ulp
(o) and 1e-5 (lse) of the Pallas kernel in interpret mode at "highest"
precision (the gates of test_torch_bf16.py); the kernel itself is held to
the plain version on the card by chip_smoke.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scoreperformer_tpu.ops.flash_attention import _flash_forward

from scoreperformer_tpu_torch.ops import _build
from scoreperformer_tpu_torch.ops import flash_attention as tflash

from test_torch_bf16 import assert_within_one_ulp, tbf16, ulp_floor
from test_torch_flash_bwd_bf16_split import split3
from test_torch_kernels import FLASH_CASES, flash_inputs

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "scoreperformer_tpu_torch" / "csrc"
TILE = 64  # keys a tile
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def fast_exp(x):
    """The kernel's `__expf`: 2^(x * log2(e)) with the product rounded to
    fp32 (the hardware's ex2 is within 2 ulp of 2^y besides)."""
    return torch.exp2(x * LOG2E)


# FLASH_CASES at the kernel's head dims, and d = 64 (the flagship's and
# scale_1024's encoders'): MQA causal and padded, MHA with an element that
# has no valid key
KERNEL_CASES = [c for c in FLASH_CASES if c[3] in tflash.KERNEL_HEAD_DIMS] + [
    (2, 4, 130, 64, 1, True, True),
    (2, 2, 70, 64, 2, False, "empty"),
]


def emulate_fwd(q, k, v, slopes, mask, causal, scale):
    """(o, lse) by the kernel's arithmetic on bf16 q, k, v: S exact and
    rounded to fp32 once, then scaled; the online softmax over 64-key tiles
    (P = 0 at and past a row's key limit, P = 1 below it on a row with no
    valid key), exp as the kernel's `__expf`; each tile's P.V in three bf16
    terms with exact products, rounded to fp32 once; o = o * alpha, then
    o + tile; a row with no valid key divided by the JAX wrapper's padded
    key count."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    s = (q.double() @ k.double().transpose(-1, -2)).float() * scale  # one KV head broadcasts
    valid, dist = tflash._valid(b, tq, tk, mask, causal, q.device)
    x = torch.where(valid, s - slopes.float()[None, :, None, None] * dist, torch.tensor(tflash.NEG_INF))
    limit = tflash.jax_masked_row_keys(tq, tk, True) if causal else torch.full((tq,), tk)
    keys = torch.arange(tk)
    m = torch.full((b, h, tq, 1), tflash.NEG_INF)
    l = torch.zeros(b, h, tq, 1)
    acc = torch.zeros(b, h, tq, d)
    vd = v.double()
    for k0 in range(0, tk, TILE):
        xt = x[..., k0:k0 + TILE]
        mx = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = fast_exp(m - mx)
        p = torch.where(keys[None, k0:k0 + TILE] < limit[:, None], fast_exp(xt - mx), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        tile = sum(term.double() @ vd[..., k0:k0 + TILE, :] for term in split3(p)).float()
        acc = acc * alpha
        acc = acc + tile
        m = mx
    count = tflash.jax_masked_row_keys(tq, tk, causal)[:, None].float()
    lc = torch.where(m == tflash.NEG_INF, count, l.clamp_min(1e-30))
    return (acc / lc).to(torch.bfloat16), (m + torch.log(lc))[..., 0]


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", KERNEL_CASES)
def test_kernel_arithmetic_matches_pallas_kernel(b, h, t, d, hk, causal, padded):
    """o and lse by the kernel's arithmetic (exact bf16 S scaled after the
    product, per-tile online softmax, three-term P, per-tile fp32 sums)
    within one bf16 ulp (o, with test_torch_bf16.py's `ulp_floor`) and 1e-5
    (lse) of the Pallas kernel in interpret mode at "highest" on the same
    bf16 q, k, v and fp32 slopes: at d = 32 and 128, whose scale is no power
    of two, scaling S after the product in place of q before it stays
    within both gates."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    scale = d**-0.5
    want_o, want_lse = _flash_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(slopes),
        jnp.asarray(mask, jnp.float32), causal, scale, 256, 256, True, "highest", return_lse=True,
    )
    got_o, got_lse = emulate_fwd(tbf16(q), tbf16(k), tbf16(v), torch.from_numpy(slopes),
                                 torch.from_numpy(mask), causal, scale)
    assert got_o.dtype == torch.bfloat16
    assert_within_one_ulp(got_o.float().numpy(), np.asarray(want_o.astype(jnp.float32)), "o", ulp_floor(d))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", KERNEL_CASES[:3])
def test_emulation_is_the_plain_version_within_one_ulp(b, h, t, d, hk, causal, padded):
    """The emulation and the port's plain version (what chip_smoke.py holds
    the kernel to on the card) agree within one bf16 ulp on o and 1e-5 on
    lse."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    args = (tbf16(q), tbf16(k), tbf16(v), torch.from_numpy(slopes), torch.from_numpy(mask))
    want_o, want_lse = tflash.flash_attention_plain(*args, causal, return_lse=True)
    got_o, got_lse = emulate_fwd(*args, causal, d**-0.5)
    assert_within_one_ulp(got_o.float().numpy(), want_o.float().numpy(), "o", ulp_floor(d))
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=1e-5)


def test_bf16_forward_head_dims_are_the_cuda_dispatch_cases():
    """The bf16 forward source's head-dim switch has the wrapper's head dims
    as its `case` labels."""
    text = (CSRC / "flash_attention_fwd_bf16.cu").read_text()
    switch = re.search(r"switch \(d\) \{(.*?)default:", text, re.S)
    assert switch is not None
    cases = tuple(sorted(int(c) for c in re.findall(r"case (\d+):", switch.group(1))))
    assert cases == tflash.KERNEL_HEAD_DIMS


def test_bf16_forward_is_its_own_library():
    """`_build` builds the bf16 forward as a library of its own, exporting
    `sp_flash_attention_fwd_bf16` with the fp32 forward's arguments; the
    fp32 source keeps no bf16 instance, and the wrapper picks the library by
    dtype."""
    entry = _build.ENTRY_POINTS
    assert entry["flash_attention_fwd_bf16"] == {
        "sp_flash_attention_fwd_bf16": entry["flash_attention_fwd"]["sp_flash_attention_fwd"]}
    assert list(entry["flash_attention_fwd"]) == ["sp_flash_attention_fwd"]
    assert 'extern "C" int sp_flash_attention_fwd_bf16(' in (CSRC / "flash_attention_fwd_bf16.cu").read_text()
    fp32 = (CSRC / "flash_attention_fwd.cu").read_text()
    assert "bf16" not in fp32.split("#include")[-1] and "nv_bfloat16" not in fp32
    assert tflash._for_dtype("flash_attention_fwd", torch.bfloat16) == "flash_attention_fwd_bf16"
    assert tflash._for_dtype("flash_attention_fwd", torch.float32) == "flash_attention_fwd"
    assert all((CSRC / f"{name}.cu").exists() for name in entry)


def test_forward_probe_variants_apply_to_the_source():
    """chip_probe_flash_fwd_bf16.py builds the bf16 forward's variants by
    exact text edits of its source: each edit still finds its text."""
    import chip_probe_flash_fwd_bf16

    base = (CSRC / "flash_attention_fwd_bf16.cu").read_text()
    sources = chip_probe_flash_fwd_bf16.variants(base)
    assert sorted(sources) == ["base", "cond_wait", "expf", "turns"]
    assert all(text != base for name, text in sources.items() if name != "base")
    assert "__expf(" not in sources["expf"] and sources["turns"].count("take_turn()") == 1

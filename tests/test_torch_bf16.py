"""`bf16_compute` in the port against the JAX package, on the CPU.

The flash functions take bf16 q, k, v and dout as the Pallas kernels do
(interpret mode, on the same bf16 inputs): o, dq, dk, dv and dslopes within
one bf16 ulp of the Pallas kernels', lse to 1e-5. Each model module, with
bf16 parameters, gives flax's output dtype and values (tolerances below), and
one train step with `bf16_compute` matches `jax.value_and_grad` of the JAX
trainer's bf16 loss on the same weights and MMD samples.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.ops import flash_attention as jflash
from scoreperformer_tpu.ops.flash_attention import _flash_forward
from scoreperformer_tpu.training.trainer import _cast_tree

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.models import attention as tattention
from scoreperformer_tpu_torch.ops import flash_attention as tflash
from scoreperformer_tpu_torch.training import Trainer, TrainerConfig

from test_torch_classifiers import build_classifier_pair, classifier_batch, classifier_config
from test_torch_kernels import FLASH_CASES, flash_inputs, rand
from test_torch_modules import build_pair, make_inputs, t, tiny_config
from test_torch_train import jax_step, port_batch, replay

torch.set_num_threads(1)


def bf16(x):
    """numpy fp32 -> the (fp32) values of its bf16 rounding."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def bf16_ulp(x):
    """The spacing of bf16 at |x| (8 significant bits), at least the smallest
    normal's."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def assert_within_one_ulp(got, want, name, floor=0.0):
    """Each element within one bf16 ulp of max(|got|, |want|); with `floor`,
    an element below that share of want's largest counted at the floor."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    ulp = bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want)), floor * np.abs(want).max()))
    worst = np.unravel_index(np.argmax(err / ulp), err.shape)
    assert (err <= ulp).all(), f"{name}: {got[worst]} vs {want[worst]} at {worst}, {err[worst] / ulp[worst]} ulp"


def tbf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# ---- the flash functions on bf16 operands: one bf16 ulp, lse 1e-5 ----
#
# At d = 128 an element that cancels to near zero (a padded query row's dq:
# 5e-6 against a largest of 2.8) differs between the two fp32 summation
# orders by more than its own ulp, so there an element below 2^-10 of its
# tensor's largest is held at that floor's ulp, as chip_smoke.py's
# BF16_ULP_FLOOR holds the kernels on the card; the other cases keep every
# element's own ulp.


def ulp_floor(d):
    return 2.0**-10 if d == 128 else 0.0


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_flash_bf16_plain_matches_pallas_kernel(b, h, t, d, hk, causal, padded):
    """o in bf16 and lse in fp32 from bf16 q, k, v (fp32 slopes), the Pallas
    kernel in interpret mode at "highest" precision on the same inputs."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    scale = d**-0.5
    want_o, want_lse = _flash_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(slopes),
        jnp.asarray(mask, jnp.float32), causal, scale, 256, 256, True, "highest", return_lse=True,
    )
    got_o, got_lse = tflash.flash_attention_fwd(
        tbf16(q), tbf16(k), tbf16(v), torch.from_numpy(slopes), mask=torch.from_numpy(mask),
        causal=causal, scale=scale,
    )
    assert got_o.dtype == torch.bfloat16 and want_o.dtype == jnp.bfloat16
    assert got_lse.dtype == torch.float32 and want_lse.dtype == jnp.float32
    assert_within_one_ulp(got_o.float().numpy(), np.asarray(want_o.astype(jnp.float32)), "o", ulp_floor(d))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,d,hk,causal,padded", FLASH_CASES)
def test_flash_bf16_backward_matches_pallas_kernels(b, h, t, d, hk, causal, padded):
    """dq, dk, dv (bf16) and dslopes (bf16 slopes) of the port's autograd
    Function against `jax.vjp` of the Pallas kernels in interpret mode, on
    bf16 q, k, v, slopes and dout: delta is the bf16 row sum in both."""
    q, k, v, slopes, mask = flash_inputs(b, h, t, d, hk, padded)
    dout = rand(7, b, h, t, d)
    _, vjp = jax.vjp(
        lambda *a: jflash.flash_attention_alibi(*a, mask=jnp.asarray(mask), causal=causal,
                                                interpret=True, precision="highest"),
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, slopes)),
    )
    want = vjp(jnp.asarray(dout, jnp.bfloat16))
    args = [tbf16(a).requires_grad_() for a in (q, k, v, slopes)]
    out = tflash.flash_attention_alibi(*args, mask=torch.from_numpy(mask), causal=causal)
    assert out.dtype == torch.bfloat16
    out.backward(tbf16(dout))
    for name, w, g in zip(("dq", "dk", "dv", "dslopes"), want, args):
        assert g.grad.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert_within_one_ulp(g.grad.float().numpy(), np.asarray(w.astype(jnp.float32)), name, ulp_floor(d))


def test_flash_bf16_delta_is_the_jax_wrappers():
    """delta = rowsum(dout * out) in bf16, as `_flash_attention_bwd` takes it
    from the bf16 residuals: the same bits."""
    x, y = rand(1, 2, 4, 37, 64), rand(2, 2, 4, 37, 64)
    want = (jnp.asarray(x, jnp.bfloat16) * jnp.asarray(y, jnp.bfloat16)).sum(-1)
    got = (tbf16(x) * tbf16(y)).sum(-1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---- the model modules on bf16 parameters: flax's dtypes and values ----
#
# With bf16 parameters each module computes in the type flax promotes to: a
# bf16 input stays bf16, an fp32 one computes in fp32 (a bf16 kernel on an
# fp32 input is upcast, as flax's Dense promotes). The stream tables mix the
# fp32 token values and padding rows into the bf16 weights, so they, the
# embeddings and every module after them are fp32 in both frameworks: the
# JAX trainer's `bf16_compute` rounds the weights to bf16 and computes in
# fp32 on every ScorePerformer recipe. Tolerances, relative to the largest
# value: bf16 outputs 1.5e-2 (a few bf16 ulps, 2^-8 each, taken in other
# orders; measured up to 7.5e-3), fp32 outputs 1e-5 (measured up to 4.3e-7).

BF16_TOL, FP32_TOL = 1.5e-2, 1e-5


@pytest.fixture(scope="module", params=[False, True], ids=["xla_attention", "flash_attention"])
def bf16_pair(request):
    """The tiny model's JAX variables and port model, both with bf16
    parameters (buffers and constants stay fp32 in both)."""
    x = make_inputs()
    model, variables, port = build_pair(tiny_config(use_flash=request.param), x)
    jv = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"])}
    for p in port.parameters():
        p.data = p.data.to(torch.bfloat16)
    return model, jv, port, x


def _jb(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _tb(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def module_outputs(case, model, jv, port, x):
    """(JAX output, port output) of one module of the tiny model."""
    name, dtype = case.rsplit("/", 1)
    h, h5 = rand(1, 2, 12, 32), rand(5, 2, 3, 32)
    style = rand(3, 2, 12, port.perf_encoder.embedding_dim)
    mask = jnp.asarray(x["mask"])
    run = lambda fn, *a: model.apply(jv, *a, method=fn)  # noqa: E731
    if name == "token_embeddings":
        return (run(lambda m, p, q: m.perf_decoder.token_emb(p, x_extra=[q]), x["perf"], x["masked"]),
                port.decoder.token_emb(t(x["perf"], torch.int64), [t(x["masked"], torch.int64)]))
    if name == "attention":
        want, _ = run(lambda m, h, k: m.score_encoder.transformer.layers[0](h, mask=k), _jb(h, dtype), mask)
        return want, port.score_encoder.transformer.layers[0][1](_tb(h, dtype), mask=t(x["mask"]))
    if name == "feed_forward":
        return (run(lambda m, h: m.score_encoder.transformer.layers[1](h), _jb(h, dtype)),
                port.score_encoder.transformer.layers[1][1](_tb(h, dtype)))
    if name == "layer_norm":
        return (run(lambda m, h: m.score_encoder.transformer.norms[0](h), _jb(h, dtype)),
                port.score_encoder.transformer.layers[0][0][0](_tb(h, dtype)))
    if name == "adaptive_layer_norm":
        return (run(lambda m, h, s: m.perf_decoder.transformer.norms[0](h, condition=s), _jb(h, dtype), _jb(style, dtype)),
                port.decoder.transformer.layers[0][0][0](_tb(h, dtype), _tb(style, dtype)))
    if name == "transformer_stack":
        want, _, _ = run(lambda m, h, k: m.score_encoder.transformer(h, mask=k), _jb(h, dtype), mask)
        return want, port.score_encoder.transformer(_tb(h, dtype), mask=t(x["mask"]))
    if name == "tied_lm_head":
        want = run(lambda m, h: m.perf_decoder.apply_lm_head(h), _jb(h5, dtype))
        got = port.decoder.apply_lm_head(_tb(h5, dtype))
        return want["Velocity"], got["Velocity"]
    if name == "score_encoder":
        return (run(lambda m, s, k: m.score_encoder(s, mask=k, return_embeddings=True).hidden_state, x["score"], mask),
                port.score_encoder(t(x["score"], torch.int64), mask=t(x["mask"])))
    if name == "mmd_style_encoder":
        args = [jnp.asarray(x[k]) for k in ("perf", "mask", "bars", "beats", "onsets")]
        want = run(lambda m, p, k, ba, be, on: m.perf_encoder(p, mask=k, bars=ba, beats=be, onsets=on,
                                                               compute_loss=False), *args)
        got = port.perf_encoder(t(x["perf"], torch.int64), mask=t(x["mask"]), bars=t(x["bars"]),
                                beats=t(x["beats"]), onsets=t(x["onsets"]))
        return want.embeddings, got.embeddings
    raise KeyError(name)


# case -> the dtype both frameworks give: bf16 where a bf16 input meets bf16
# weights alone, fp32 where fp32 values enter (inputs, token values, tables)
MODULE_CASES = {
    "token_embeddings/ids": torch.float32, "attention/bf16": torch.bfloat16, "attention/fp32": torch.float32,
    "feed_forward/bf16": torch.bfloat16, "feed_forward/fp32": torch.float32, "layer_norm/bf16": torch.bfloat16,
    "layer_norm/fp32": torch.float32, "adaptive_layer_norm/bf16": torch.bfloat16,
    "adaptive_layer_norm/fp32": torch.float32, "transformer_stack/bf16": torch.bfloat16,
    "transformer_stack/fp32": torch.float32, "tied_lm_head/bf16": torch.float32, "score_encoder/ids": torch.float32,
    "mmd_style_encoder/ids": torch.float32,
}


@torch.no_grad()
@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_dtype_and_values_match_flax_on_bf16_parameters(bf16_pair, case):
    model, jv, port, x = bf16_pair
    want, got = module_outputs(case, model, jv, port, x)
    want_dtype = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[jnp.asarray(want).dtype.type]
    assert got.dtype == want_dtype == MODULE_CASES[case], (case, got.dtype, jnp.asarray(want).dtype)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - w).max() / np.abs(w).max()
    assert err <= (BF16_TOL if got.dtype == torch.bfloat16 else FP32_TOL), (case, err)


def test_classifiers_on_bf16_parameters_match_flax():
    """The direction heads on bf16 weights: fp32 logits from the fp32 style
    embeddings, as flax's Dense promotes."""
    batch = classifier_batch()
    model, variables, port = build_classifier_pair(classifier_config(), batch)
    jv = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"])}
    for p in port.parameters():
        p.data = p.data.to(torch.bfloat16)
    emb = rand(9, 2, 12, port.perf_encoder.embedding_dim)
    want = model.apply(jv, jnp.asarray(emb), method=lambda m, e: m.classifiers(e))
    with torch.no_grad():
        got = port.classifiers(torch.from_numpy(emb))
    for key, w in want.logits.items():
        assert got.logits[key].dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(got.logits[key].numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=key)


# ---- one train step with bf16_compute against jax.value_and_grad ----


class _CastParams:
    """The JAX trainer's bf16 loss function: `model.apply` on the parameters
    cast to bf16 (`_cast_tree`), so the gradients come back fp32."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, **kwargs):
        return self.model.apply({"params": _cast_tree(variables["params"], jnp.bfloat16)}, **kwargs)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("use_flash", [False, True], ids=["xla_attention", "flash_attention"])
def test_bf16_compute_train_step_matches_jax(use_flash, monkeypatch, tmp_path):
    """The Trainer's `bf16_compute` forward (bf16 copies of the fp32
    parameters, fp32 gradients through the casts) on the tiny model with
    direction classifiers, against `jax.value_and_grad` of the JAX trainer's
    loss on `_cast_tree(params, bf16)`, JAX's MMD samples handed over. Gates
    first set at loss 1e-2 relative and each gradient's relative L2
    difference 5e-2; measured: the loss 2.8e-7 (both frameworks round the
    same weights to bf16 and compute in fp32, see above), the gradients
    1.9e-5 at the median and 2.4e-3 at most (each gradient is the bf16
    cotangent of a bf16 weight, rounded to bf16 in both, so an element may
    differ by one bf16 ulp, 2^-8; the worst are the 2-element ALiBi
    log-slopes). Tightened to 1e-5 (loss and terms) and 5e-3 (gradients)."""
    batch = classifier_batch()
    model, variables, port = build_classifier_pair(classifier_config(use_flash), batch)
    loss, losses, grads, draws = jax_step(_CastParams(model), variables["params"], batch, monkeypatch)
    trainer = Trainer(port, TrainerConfig(output_dir=str(tmp_path), bf16_compute=True, tensorboard=False,
                                          disable_progress=True))
    port.zero_grad()
    out = trainer._apply({**port_batch(batch), "mmd_sampler": replay(draws)}, {})
    assert out.loss.dtype == torch.float32, out.loss.dtype
    assert [n for n, p in port.named_parameters() if p.dtype != torch.float32] == []
    out.loss.backward()
    assert abs(out.loss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    for key, value in losses.items():
        assert abs(out.losses[key].item() - float(value)) <= 1e-5 * max(abs(float(value)), 1e-3), key
    params = dict(port.named_parameters(remove_duplicate=False))
    for name, want in state_dict_from_jax(jax.device_get(grads)).items():
        got = params[name.replace("proj|0", "proj")].grad
        assert got.dtype == torch.float32, name
        assert rel_l2(got.numpy(), want) <= 5e-3, (name, rel_l2(got.numpy(), want))


def test_a_model_held_in_bf16_trains_with_bf16_attention(monkeypatch, tmp_path):
    """The tiny model cast whole to bf16 (parameters and buffers) takes a
    Trainer step: its attention inputs are bf16, so the flash functions run
    on bf16 q, k, v and dout (their bf16 kernel instances on the card), and
    the loss and gradient norm are finite fp32."""
    batch = classifier_batch()
    _, _, port = build_classifier_pair(classifier_config(use_flash=True), batch)
    port.to(torch.bfloat16)
    seen = []
    real = tflash.flash_attention_alibi
    monkeypatch.setattr(tattention, "flash_attention_alibi",
                        lambda q, k, v, *a, **kw: seen.append((q.dtype, k.dtype, v.dtype)) or real(q, k, v, *a, **kw))
    trainer = Trainer(port, TrainerConfig(output_dir=str(tmp_path), tensorboard=False, disable_progress=True))
    trainer._prepare()
    metrics = trainer.train_step(port_batch(batch), 0)
    assert seen and set(seen) == {(torch.bfloat16,) * 3}
    assert metrics["loss"].dtype == torch.float32 and np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["stats/grad_norm"].item())
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())

"""The flash path at the recipes' other head dims against the JAX package, on
the CPU.

recipes/scoreperformer/scale_1024.yaml's decoder attends with 8 heads of 128
and one KV head; recipes/smoke.yaml's stacks with 2 heads of 16. A tiny
model of each shape (few layers, t = 40, `use_flash`, no attention dropout)
goes through both frameworks on the same weights (`convert.state_dict_from_jax`)
and the same numpy inputs: the encoders and the causal decoder stack to 1e-4,
as whole encoders need (tests/test_torch_modules.py), and one train step's
loss (1e-5) and gradients (1e-4) against `jax.value_and_grad`, with JAX's
MMD samples handed to the port (tests/test_torch_train.py). On CPU tensors
the flash wrappers run their kernels' plain versions; the counts below show
that every attention layer took the flash path. The CUDA kernels' head dims
are read from their dispatch switches and held to the wrapper's.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.ops import flash_attention as tflash

from test_torch_modules import MODEL_TOL, build_pair, close, rand, t, tiny_config
from test_torch_train import GRAD_TOL, jax_step, port_batch, replay, train_batch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CSRC = Path(__file__).resolve().parents[1] / "scoreperformer_tpu_torch" / "csrc"
SEQ = 40
# dim, heads, dim_head, (score encoder, performance encoder, decoder) depths
SHAPES = {"scale_1024_d128": (256, 2, 128, (1, 2, 2)), "smoke_d16": (64, 2, 16, (1, 1, 1))}


def shaped_config(dim, heads, dim_head, depths):
    """tiny_config with every stack at `heads` heads of `dim_head`, one KV
    head, learned ALiBi and `use_flash`, without attention dropout."""
    cfg = tiny_config(use_flash=True)
    cfg["dim"] = dim
    attn = {"dim_head": dim_head, "one_kv_head": True, "alibi_pos_bias": True, "alibi_learned": True,
            "use_flash": True, "dropout": 0.0}
    for key, depth in zip(("score_encoder", "perf_encoder", "perf_decoder"), depths):
        cfg[key]["transformer"].update(depth=depth, heads=heads, attention=dict(attn))
    cfg["perf_encoder"].update(mmd_max_num_latents=64, mmd_num_samples=16, deadpan_zero_latent=True)
    return cfg


@pytest.fixture(scope="module", params=list(SHAPES), ids=list(SHAPES))
def shaped(request):
    batch = train_batch(b=2, t=SEQ)
    cfg = shaped_config(*SHAPES[request.param])
    inputs = {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")} | {
        "mask": batch["perf_mask"], "masked": batch["masked_perf"]}
    model, variables, port = build_pair(cfg, inputs)
    return model, variables, port, batch, sum(SHAPES[request.param][3]), cfg["dim"]


class _Calls:
    """Counts the calls of the flash wrappers (the autograd Function calls
    them by their module names)."""

    def __init__(self, monkeypatch):
        self.counts = {}
        for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            fn = getattr(tflash, name)
            self.counts[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(tflash, name, counted)


def test_encoders_and_decoder_stack_match_jax(shaped, monkeypatch):
    model, variables, port, batch, layers, dim = shaped
    calls = _Calls(monkeypatch)
    args = [batch[k] for k in ("perf", "perf_mask", "score", "score_mask", "bars", "beats", "onsets")]
    want_score, want_style, _ = model.apply(variables, *map(jnp.asarray, args), method="encode_embeddings")
    with torch.no_grad():
        got_score, got_style, _ = port.encode_embeddings(
            *(t(a, torch.int64) if a.dtype != bool else t(a) for a in args))
        close(want_score, got_score, MODEL_TOL)
        close(want_style, got_style, MODEL_TOL)
        # the causal stack, conditioned on the style as the decoder is
        h = rand(11, 2, SEQ, dim)
        style = np.asarray(want_style)
        want, _, _ = model.apply(variables, jnp.asarray(h), jnp.asarray(batch["perf_mask"]), jnp.asarray(style),
                                 method=lambda m, h, k, s: m.perf_decoder.transformer(h, mask=k, style_embeddings=s))
        got = port.decoder.transformer(t(h), mask=t(batch["perf_mask"]), style_embeddings=t(style))
        close(want, got, MODEL_TOL)
    assert calls.counts == {"flash_attention_fwd": layers, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}


def test_train_step_loss_and_gradients_match_jax(shaped, monkeypatch):
    model, variables, port, batch, layers, _ = shaped
    loss, losses, grads, draws = jax_step(model, variables["params"], batch, monkeypatch)
    calls = _Calls(monkeypatch)
    port.zero_grad()
    out = port(**port_batch(batch), mmd_sampler=replay(draws))
    out.loss.backward()
    assert calls.counts == {name: layers for name in calls.counts}
    np.testing.assert_allclose(out.loss.item(), float(loss), atol=1e-5, rtol=1e-5)
    assert set(out.losses) == set(losses)
    for key, value in losses.items():
        np.testing.assert_allclose(out.losses[key].item(), float(value), atol=1e-5, rtol=1e-5, err_msg=key)
    params = dict(port.named_parameters(remove_duplicate=False))
    names = state_dict_from_jax(jax.device_get(grads))
    assert len(names) == len({id(p) for p in params.values()})
    for name, want in names.items():
        got = params[name.replace("proj|0", "proj")].grad
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("source", ["flash_attention_fwd.cu", "flash_attention_bwd.cu"])
def test_kernel_head_dims_are_the_cuda_dispatch_cases(source):
    """The head dims the wrapper sends to the kernels are the `case` labels of
    the source's head-dim switch, so neither can change without the other."""
    text = (CSRC / source).read_text()
    switch = re.search(r"switch \(d\) \{(.*?)default:", text, re.S)
    assert switch is not None, source
    cases = tuple(sorted(int(c) for c in re.findall(r"case (\d+):", switch.group(1))))
    assert cases == tflash.KERNEL_HEAD_DIMS

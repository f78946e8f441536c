"""Sequence parallelism on the model axis (the trainer's
`sequence_parallel`, `models/transformer.py`) on the CPU.

- A train step of the tiny model (tests/test_torch_modules.py's sizes) at
  data 2 x model 2 with `sequence_parallel`, 4 gloo ranks started by
  `parallel.launch`, against the JAX trainer's step under its
  sequence-parallel activation sharding on the same mesh (as
  tests/test_parallel.py::test_sequence_parallel_loss_and_grads_match
  builds it), with JAX's MMD samples handed in: loss 1e-5, gradients 1e-4
  (absolute, scaled by a gradient's largest value where that passes 1).
  At 12 notes the encoders' 12 positions split over the model axis and the
  decoder's 11 do not (JAX's no-op rule for an odd length). Each stack's
  decision is logged and checked.
- Stacks the recipes do not reach (post-norm, feed-forward biases, K/V
  split by head, AdaNorm style vectors, cross-attention, dropout on, an odd
  length) on a model axis of 2, with and without sequence parallelism,
  against one process: output and gradients 1e-5.
"""
import numpy as np
import pytest
import torch

import jax

from scoreperformer_tpu.parallel import activation_sharding, make_mesh

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.models.dropout import dropout_generator
from scoreperformer_tpu_torch.models.transformer import (AttentionConfig, FeedForwardConfig, TransformerConfig,
                                                         TransformerStack)
from scoreperformer_tpu_torch.parallel.launch import launch
from scoreperformer_tpu_torch.parallel.workers import train_worker

import test_torch_modules as tm
import test_torch_train as tt
from test_torch_parallel import close, payload
from test_torch_parallel_workers import replay_and_log_sequence_parallel, sequence_parallel_stack_worker

torch.set_num_threads(1)


def test_sequence_parallel_train_step_matches_jax(tmp_path, monkeypatch):
    t = 12
    batch = tt.train_batch(t=t)
    cfg = tt.train_config(False)
    model, variables, port = tm.build_pair(cfg, {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")}
                                           | {"mask": batch["perf_mask"], "masked": batch["masked_perf"]})
    with activation_sharding(make_mesh(2, 2, devices=jax.devices()[:4])):
        loss, losses, grads, draws = tt.jax_step(model, variables["params"], batch, monkeypatch)
    log = tmp_path / "sp.log"
    trainer = {"optimization": {"optimizer": "adamw"}, "mesh_data": 2, "mesh_model": 2, "sequence_parallel": True}
    got = launch(train_worker, 4, (payload(tmp_path, cfg, port.state_dict(), batch, trainer, draws=draws,
                                           sp_log=str(log)), replay_and_log_sequence_parallel), device="cpu")[0]
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(loss), atol=1e-5, rtol=1e-5)
    for key, value in losses.items():
        np.testing.assert_allclose(got["metrics"][0][key], float(value), atol=1e-5, rtol=1e-5, err_msg=key)
    names = state_dict_from_jax(jax.device_get(grads))
    for name, want in names.items():
        close(got["grads"][name.replace("proj|0", "proj")].numpy(), want, 1e-4, name)
    decisions = {tuple(map(int, line.split())) for line in log.read_text().splitlines()}
    assert decisions == {(t, 1), (t - 1, 0)}, decisions


def stack_case(seed, b=2, t=8, style=None, context=False, **kw):
    """A stack config (dim 16, depth 2, 4 heads of 4) and its inputs from `seed`."""
    rng = np.random.RandomState(seed)
    att = kw.pop("attention", {})
    ff = kw.pop("feed_forward", {})
    cfg = TransformerConfig(dim=16, depth=2, heads=4, cross_attend=context,
                            attention=AttentionConfig(dim_head=4, dropout=0.1, **att),
                            feed_forward=FeedForwardConfig(mult=2, dropout=0.1, **ff), **kw)
    mask = np.ones((b, t), bool)
    mask[1, t - 3:] = False
    case = {"seed": seed, "config": cfg, "x": torch.from_numpy(rng.randn(b, t, 16).astype(np.float32)),
            "mask": None if context else torch.from_numpy(mask),  # a cross-attention mask would cover the context
            "weights": torch.from_numpy(rng.randn(b, t, 16).astype(np.float32))}
    if style is not None:
        case["style"] = torch.from_numpy(rng.randn(*((b, t, 6) if style == "rows" else (b, 6))).astype(np.float32))
    if context:
        case["context"] = torch.from_numpy(rng.randn(b, 5, 16).astype(np.float32))
    return case


STACK_CASES = {
    "pre_norm_adanorm_style_rows_ff_bias_causal_alibi_mqa": dict(
        style="rows", use_adanorm=True, style_emb_dim=6, causal=True,
        attention={"one_kv_head": True, "alibi_pos_bias": True, "alibi_learned": True},
        feed_forward={"glu": True, "swish": True, "no_bias": False}),
    "post_norm_kv_heads_split": dict(pre_norm=False, feed_forward={"no_bias": False}),
    "adanorm_style_vector": dict(style="vector", use_adanorm=True, style_emb_dim=6),
    "cross_attention": dict(context=True),
    "odd_length_runs_as_without": dict(t=7),
}


@pytest.fixture(scope="module")
def stack_runs():
    cases = {name: stack_case(i, **dict(kw)) for i, (name, kw) in enumerate(STACK_CASES.items())}
    got = launch(sequence_parallel_stack_worker, 2, (list(cases.values()),), device="cpu")
    return cases, {name: [r[i] for r in got] for i, name in enumerate(cases)}


@pytest.mark.parametrize("name", list(STACK_CASES))
def test_sequence_parallel_stack_equals_one_process(stack_runs, name):
    """Dropout on: the same masks on each rank's slice as unsplit. The
    residual stream splits wherever the length divides the model axis."""
    cases, got = stack_runs
    case = cases[name]
    torch.manual_seed(case["seed"])
    stack = TransformerStack(case["config"]).train()
    x = case["x"].clone().requires_grad_(True)
    style = None if case.get("style") is None else case["style"].clone().requires_grad_(True)
    with dropout_generator(torch.Generator().manual_seed(case["seed"])):
        h = stack(x, mask=case["mask"], context=case.get("context"), style_embeddings=style)
        (h * case["weights"]).sum().backward()
    for rank in got[name]:
        for sp, run in rank.items():
            assert run["engaged"] == (sp and case["x"].shape[1] % 2 == 0)
            close(run["out"].numpy(), h.detach().numpy(), 1e-5, f"out sp={sp}")
            close(run["x_grad"].numpy(), x.grad.numpy(), 1e-5, f"x sp={sp}")
            if style is not None:
                close(run["style_grad"].numpy(), style.grad.numpy(), 1e-5, f"style sp={sp}")
            for k, p in stack.named_parameters():
                close(run["grads"][k].numpy(), p.grad.numpy(), 1e-5, f"{k} sp={sp}")

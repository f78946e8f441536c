"""The port's GPipe over a `pipe` axis (`scoreperformer_tpu_torch.parallel.
pipeline`) against the JAX package's `pipeline_apply`, on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port's
ranks are gloo CPU processes that `parallel.launch` starts, all the cases
of a test in one launch (`parallel.workers.pipeline_runs_worker`).
The trunk is tests/test_parallel.py::TestPipelineParallel's (dim 32, depth
4, 2 causal heads of 16, one KV head, learned ALiBi, GLU-swish; a (8, 12)
input whose last two positions are padding; AdaNorm style rows of 12 in one
case), its weights a JAX `init` crossed over through
`convert.state_dict_from_jax`, its inputs from a seed with numpy. The loss
is JAX's dry run's: the stack's final norm over the trunk's output, then
(h**2).sum(). Tolerances: the forward 1e-5; the gradients of every
parameter (after `unstack_unit_tree`), of x and of the style rows 1e-4,
absolute, scaled by a gradient's largest value where that passes 1; the
composed mesh's loss 1e-5 relative.
"""
import dataclasses
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from scoreperformer_tpu.models.layers import AdaptiveLayerNorm as JAdaptiveLayerNorm
from scoreperformer_tpu.models.transformer import (AttentionConfig as JAttentionConfig,
                                                   FeedForwardConfig as JFeedForwardConfig,
                                                   TransformerConfig as JTransformerConfig,
                                                   TransformerStack as JTransformerStack)
from scoreperformer_tpu.parallel import (make_pipeline_mesh as jax_pipeline_mesh, make_unit_module as jax_unit,
                                         pipeline_apply as jax_pipeline_apply, stack_unit_params as jax_stack,
                                         stacked_params_shardings, unstack_unit_tree as jax_unstack)
from scoreperformer_tpu.parallel.mesh import activation_sharding

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.models.transformer import (AttentionConfig, FeedForwardConfig, TransformerConfig,
                                                         TransformerStack)
from scoreperformer_tpu_torch.parallel.launch import launch
from scoreperformer_tpu_torch.parallel.pipeline import (make_unit_module, stack_unit_params, stage_params,
                                                        unstack_unit_tree)
from scoreperformer_tpu_torch.parallel.workers import pipeline_runs_worker

torch.set_num_threads(1)
B, T, DIM, STYLE = 8, 12, 32, 12
PREFIX = "score_encoder.transformer."


def configs(adanorm=False):
    """The trunk's config in both packages."""
    kw = dict(dim=DIM, depth=4, heads=2, causal=True, use_adanorm=adanorm, style_emb_dim=STYLE if adanorm else None)
    jcfg = JTransformerConfig(attention=JAttentionConfig(dim_head=16, one_kv_head=True, alibi_pos_bias=True,
                                                         alibi_learned=True),
                              feed_forward=JFeedForwardConfig(glu=True, swish=True), **kw)
    tcfg = TransformerConfig(attention=AttentionConfig(dim_head=16, one_kv_head=True, alibi_pos_bias=True,
                                                       alibi_learned=True),
                             feed_forward=FeedForwardConfig(glu=True, swish=True), **kw)
    return jcfg, tcfg


def port_names(tree):
    """A JAX stack's tree as {the port stack's name: numpy array}."""
    return {k[len(PREFIX):].replace("proj|0", "proj"): v
            for k, v in state_dict_from_jax({"score_encoder": {"transformer": jax.device_get(tree)}}).items()}


def trunk(seed, adanorm=False):
    """(JAX config, port config, JAX params, x, mask, style) from `seed`."""
    jcfg, tcfg = configs(adanorm)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, DIM).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[:, 10:] = False
    style = rng.randn(B, T, STYLE).astype(np.float32) if adanorm else None
    kw = {"mask": jnp.asarray(mask)}
    if adanorm:
        kw["style_embeddings"] = jnp.asarray(style)
    params = JTransformerStack(config=jcfg).init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), **kw)["params"]
    return jcfg, tcfg, params, x, mask, style


def jax_run(jcfg, params, x, mask, style, data, pipe, m, model=1):
    """JAX's loss, final-normed output and gradients (port names, and x's
    and style's) through its `pipeline_apply` on a (data, pipe[, model])
    mesh; with a model axis, as test_composed_data_pipe_model_parity runs
    it (the stacked shardings, the sequence-parallel residual stream)."""
    unit = jax_unit(jcfg)
    stacked = jax_stack(params, jcfg.depth)
    mesh = jax_pipeline_mesh(pipe, data=data, model=model, devices=jax.devices()[:data * pipe * model])
    if model > 1:
        stacked = jax.device_put(stacked, stacked_params_shardings(stacked, mesh))
    jmask = jnp.asarray(mask)

    def loss(sp, final, xx, sty):
        h = jax_pipeline_apply(unit, sp, xx, mesh, num_microbatches=m, mask=jmask, style_embeddings=sty)
        if jcfg.use_adanorm:
            h = JAdaptiveLayerNorm(jcfg.dim, jcfg.style_emb_dim).apply({"params": final}, h, condition=sty)
        else:
            h = fnn.LayerNorm(epsilon=1e-5).apply({"params": final}, h)
        return (h ** 2).sum(), h

    with activation_sharding(mesh) if model > 1 else nullcontext():
        (value, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            stacked, params["final_norm"], jnp.asarray(x), None if style is None else jnp.asarray(style))
    tree = {**jax_unstack(grads[0], jcfg.depth), "final_norm": grads[1]}
    return float(value), np.asarray(out), port_names(tree), np.asarray(grads[2]), \
        None if style is None else np.asarray(grads[3])


def payload(tmp_path, name, tcfg, params, x, mask, style, mesh, m, **kw):
    stack = TransformerStack(tcfg)
    stack.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in port_names(params).items()})
    path = tmp_path / f"{name}.pt"
    torch.save({"config": tcfg, "state_dict": stack.state_dict(), "x": torch.from_numpy(x),
                "mask": torch.from_numpy(mask), "style": None if style is None else torch.from_numpy(style),
                "mesh": mesh, "microbatches": m, "inputs_grad": True, "device": "cpu", **kw}, path)
    return str(path)


def close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol, err_msg=name)


# (data, pipe, M, AdaNorm style)
CASES = {"data1_pipe2_m2": (1, 2, 2, False), "data2_pipe2_m2": (2, 2, 2, False),
         "data1_pipe4_m4": (1, 4, 4, False), "data2_pipe2_m2_adanorm_style": (2, 2, 2, True)}


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """Every case through JAX and through the port's ranks (one launch of 4)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    want, paths = {}, []
    for i, (name, (data, pipe, m, adanorm)) in enumerate(CASES.items()):
        jcfg, tcfg, params, x, mask, style = trunk(seed=i, adanorm=adanorm)
        want[name] = jax_run(jcfg, params, x, mask, style, data, pipe, m)
        paths.append(payload(tmp, name, tcfg, params, x, mask, style, {"data": data, "pipe": pipe}, m))
    results = launch(pipeline_runs_worker, 4, (paths,), device="cpu")
    return want, {name: [r[i] for r in results] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_apply_matches_jax(pipeline_runs, case):
    """The forward within 1e-5 and every gradient within 1e-4 of JAX's
    `pipeline_apply` on the same mesh; the ranks sit at JAX's (data, pipe)
    coordinates, every pipe rank returns the whole output, and each stage
    runs its units once a microbatch."""
    want, got = pipeline_runs
    value, out, grads, x_grad, style_grad = want[case]
    data, pipe, m, adanorm = CASES[case]
    ranks = [r for r in got[case] if r is not None]
    assert len(ranks) == data * pipe
    for r in ranks:
        assert r["coords"]["data"] * pipe + r["coords"]["pipe"] == r["rank"]
        assert r["launches"] == [{"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
                                  "flash_attention_bwd_dq": 0}]
    res = ranks[0]
    np.testing.assert_allclose(res["losses"][0], value, rtol=1e-5)
    close(res["out"].numpy(), out, 1e-5, "forward")
    assert set(res["grads"]) == set(grads)
    for name, g in grads.items():
        close(res["grads"][name].numpy(), g, 1e-4, name)
    close(res["x_grad"].numpy(), x_grad, 1e-4, "x")
    if adanorm:
        close(res["style_grad"].numpy(), style_grad, 1e-4, "style")


def test_composed_data_pipe_model_with_sequence_parallelism_matches_jax(tmp_path):
    """(2 data x 2 pipe x 2 model) with sequence parallelism, 8 ranks,
    against JAX's test_composed_data_pipe_model_parity path on the same
    mesh: loss within 1e-5, gradients within 1e-4; the sequence (12)
    splits over the model axis, so the stack runs sequence-parallel."""
    jcfg, tcfg, params, x, mask, _ = trunk(seed=9)
    value, _, grads, x_grad, _ = jax_run(jcfg, params, x, mask, None, 2, 2, 2, model=2)
    path = payload(tmp_path, "composed", tcfg, params, x, mask, None, {"data": 2, "pipe": 2, "model": 2}, 2,
                   sequence_parallel=True)
    res = launch(pipeline_runs_worker, 8, ([path],), device="cpu")[0][0]
    np.testing.assert_allclose(res["losses"][0], value, rtol=1e-5)
    assert set(res["grads"]) == set(grads)
    for name, g in grads.items():
        close(res["grads"][name].numpy(), g, 1e-4, name)
    close(res["x_grad"].numpy(), x_grad, 1e-4, "x")


@pytest.mark.parametrize("data,pipe,model", [(1, 2, 1), (2, 2, 1), (1, 4, 1), (2, 2, 2), (1, 2, 4)])
def test_pipeline_rank_layout_is_jax_s(data, pipe, model):
    """Rank r sits where JAX's `make_pipeline_mesh` puts device r: the
    (data, pipe, model) reshape."""
    from scoreperformer_tpu_torch.parallel.mesh import pipeline_layout

    mesh = jax_pipeline_mesh(pipe, data=data, model=model, devices=jax.devices()[:data * pipe * model])
    ids = np.vectorize(lambda d: d.id)(mesh.devices).reshape(data, pipe, model)
    np.testing.assert_array_equal(pipeline_layout(pipe, data, model), ids)


def test_stack_and_unstack_round_trip_and_stage_blocks():
    """`unstack_unit_tree` gives `stack_unit_params`' input back (the final
    norm aside); unit u's leaf is layers 2u and 2u+1's; stage s of 2 holds
    units 2s and 2s+1; the names are the unit module's."""
    _, tcfg = configs(adanorm=True)
    torch.manual_seed(0)
    stack = TransformerStack(tcfg)
    flat = stack.state_dict()
    stacked = stack_unit_params(flat, tcfg.depth)
    assert set(stacked) == set(make_unit_module(tcfg).state_dict())
    back = unstack_unit_tree(stacked, tcfg.depth)
    assert set(back) == {k for k in flat if not k.startswith("final_norm")}
    for k, v in back.items():
        assert torch.equal(v, flat[k]), k
    assert torch.equal(stacked["layers.0.1.to_q.weight"][3], flat["layers.6.1.to_q.weight"])
    assert torch.equal(stacked["layers.1.0.0.linear.weight"][2], flat["layers.5.0.0.linear.weight"])

    class Mesh:  # stage 1 of a 2-stage pipe
        def size(self, axis):
            return 2 if axis == "pipe" else 1

        def index(self, axis):
            return 1 if axis == "pipe" else 0

    block = stage_params(stacked, Mesh())
    for k, v in block.items():
        assert torch.equal(v, stacked[k][2:4]), k


def test_pipeline_refuses_what_jax_refuses():
    """A cross-attend stack (ValueError: JAX asserts) and an MoE
    feed-forward (NotImplementedError, as JAX) have no depth unit."""
    _, tcfg = configs()
    with pytest.raises(ValueError, match="cross-attend"):
        make_unit_module(dataclasses.replace(tcfg, cross_attend=True))
    with pytest.raises(NotImplementedError, match="MoE"):
        make_unit_module(dataclasses.replace(tcfg, feed_forward=FeedForwardConfig(num_experts=4)))
    unit = make_unit_module(tcfg)
    assert unit.config.depth == 1 and unit.final_norm is None

"""The port's Mixture-of-Experts against the JAX package's, on the CPU.

The layer against flax's `MoEFeedForward` on the same weights (1e-5): with
and without a padding mask, GLU or not, with biases and the router z-loss.
The properties that tests/test_moe.py pins in JAX, held on the port's layer:
capacity overflow, slot-major priority, gate renormalisation, the
load-balance and z-loss hand values, pads taking no capacity, aux over real
tokens only, the dtype kept, the `post_act_ln` raise, a dense stack
reporting nothing, the stride substitution and the cached decode ignoring
the key mask; top-k ties routed as `jax.lax.top_k` routes them. Then a tiny
moe.yaml-shaped ScorePerformer (every 2nd feed-forward of all three stacks
an MoE layer of 4 experts, top-2, capacity factor 1.25, aux weight 0.01):
one train step's loss with the aux (1e-5) and every gradient (1e-4) against
`jax.value_and_grad`, the trainer's `loss/moe_aux` and `stats/moe_drop`,
the weights through `state_dict_from_jax` and back, greedy render tokens and
greedy streaming windows equal to JAX's.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.data.synthetic import synthetic_score as jax_synthetic_score
from scoreperformer_tpu.inference.render import render_performance as jax_render
from scoreperformer_tpu.models.attention import init_kv_cache as jax_init_kv_cache
from scoreperformer_tpu.models import mmd as jmmd
from scoreperformer_tpu.models.moe import MoEFeedForward as JaxMoE
from scoreperformer_tpu.models.transformer import AttentionConfig as JaxAttentionConfig
from scoreperformer_tpu.models.transformer import FeedForwardConfig as JaxFeedForwardConfig
from scoreperformer_tpu.models.transformer import TransformerConfig as JaxTransformerConfig
from scoreperformer_tpu.models.transformer import TransformerStack as JaxStack
from scoreperformer_tpu.tokenizers import SPMupleWindow as JaxTokenizer
from scoreperformer_tpu.tokenizers import TokenizerConfig as JaxTokenizerConfig

from scoreperformer_tpu_torch.convert import jax_param_paths, load_state_dict, state_dict_from_jax
from scoreperformer_tpu_torch.data import synthetic_score
from scoreperformer_tpu_torch.inference import render_performance
from scoreperformer_tpu_torch.models.attention import init_kv_cache
from scoreperformer_tpu_torch.models.factory import build_scoreperformer
from scoreperformer_tpu_torch.models.moe import MoEFeedForward, top_k_lower_first
from scoreperformer_tpu_torch.models.transformer import (
    AttentionConfig,
    FeedForwardConfig,
    TransformerConfig,
    TransformerStack,
)
from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig
from scoreperformer_tpu_torch.training import Trainer, TrainerConfig
from scoreperformer_tpu_torch.training.trainer import step_generators

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_moe_{name}", TESTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tm = _load("test_torch_modules")
tt = _load("test_torch_train")
ts = _load("test_torch_streaming")

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# recipes/scoreperformer/moe.yaml's feed-forward
MOE_FF = dict(num_experts=4, expert_top_k=2, capacity_factor=1.25, moe_stride=2, router_aux_weight=0.01)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def port_layer(params, **kw):
    """The port's layer holding flax's parameters (the same names and layouts)."""
    layer = MoEFeedForward(**kw)
    with torch.no_grad():
        for name, value in params.items():
            getattr(layer, name).copy_(torch.from_numpy(np.array(value)))
    assert {n for n, _ in layer.named_parameters()} == set(params)
    return layer


def jax_layer(seed=0, perturb=True, **kw):
    """flax's layer and parameters (the zero biases moved off zero, so that
    they count), with the port's layer on the same weights."""
    module = JaxMoE(**kw)
    x = jnp.zeros((1, 4, kw["dim"]))
    params = jax.device_get(module.init({"params": jax.random.PRNGKey(seed)}, x)["params"])
    if perturb:
        params = {k: np.asarray(v) + (0.05 * rand(seed + 1, *np.shape(v)) if k in ("bi", "bo") else 0)
                  for k, v in params.items()}
    return module, params, port_layer(params, **kw)


def run_jax(module, params, x, mask=None):
    y, mut = module.apply({"params": params}, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask),
                          mutable=["losses", "metrics"])
    return np.asarray(y), float(mut["losses"]["moe_aux"][0]), float(mut["metrics"]["moe_drop"][0])


def run_port(layer, x, mask=None):
    with torch.no_grad():
        y, aux, drop = layer(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), with_stats=True)
    return y.numpy(), aux.item(), drop.item()


# ---- the layer against flax ----

LAYER_CASES = {
    "plain_gelu": dict(glu=False, swish=False, masked=False),
    "glu_swish_masked": dict(glu=True, swish=True, masked=True),
    "glu_gelu_bias_masked": dict(glu=True, swish=False, no_bias=False, masked=True),
    "plain_swish_bias_z_loss": dict(glu=False, swish=True, no_bias=False, router_z_weight=0.1, masked=True),
    "glu_swish_z_loss_top1": dict(glu=True, swish=True, top_k=1, router_z_weight=0.05, masked=False),
}


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_matches_flax(case):
    """Capacity factor 1.0 at S = 12 puts capacity below the choices, so
    assignments overflow; the second row's tail is padding."""
    kw = dict(LAYER_CASES[case])
    masked = kw.pop("masked")
    kw = dict(dim=16, num_experts=4, mult=2, capacity_factor=1.0, **kw)
    module, params, layer = jax_layer(**kw)
    x = rand(3, 2, 12, 16)
    mask = None
    if masked:
        mask = np.ones((2, 12), bool)
        mask[1, 7:] = False
    want, got = run_jax(module, params, x, mask), run_port(layer, x, mask)
    np.testing.assert_allclose(got[0], want[0], **LAYER_TOL)
    np.testing.assert_allclose(got[1], want[1], **LAYER_TOL)
    assert got[2] == pytest.approx(want[2], abs=1e-7)
    assert 0.0 < got[2] < 1.0, "no assignment overflowed: the case does not reach the capacity"


def test_top_k_ties_route_as_jax_top_k():
    """Equal probabilities (a zero router gives every expert 1/E; rows with
    pairs of equal logits) take the lower expert first, as `jax.lax.top_k`."""
    rng = np.random.RandomState(5)
    x = rng.randn(64, 6).astype(np.float32)
    x[:8] = 0.25  # all equal
    x[8:16, 2] = x[8:16, 4] = 3.0  # a tie for the first place
    x[16:24, 1] = x[16:24, 5] = x[16:24].max(1) + 1  # a tie at the top
    x[24:32, 3] = x[24:32, 0] = x[24:32].max(1) - 0.5 * (x[24:32].max(1) - x[24:32].min(1))
    for k in (1, 2, 3, 6):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k_lower_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    module, params, layer = jax_layer(dim=8, num_experts=4, mult=1, capacity_factor=2.0)
    params["router"] = np.zeros_like(params["router"])
    layer = port_layer(params, dim=8, num_experts=4, mult=1, capacity_factor=2.0)
    x = rand(6, 2, 8, 8)
    want, got = run_jax(module, params, x), run_port(layer, x)
    np.testing.assert_allclose(got[0], want[0], **LAYER_TOL)
    assert got[1] == pytest.approx(want[1], rel=1e-6)


# ---- tests/test_moe.py's properties, on the port's layer ----


def expert_mlp(layer, e, t, glu=False, swish=False):
    """One expert applied to one token (numpy oracle)."""
    act = torch.nn.functional.silu if swish else (lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    with torch.no_grad():
        h = torch.from_numpy(t) @ layer.wi[e]
        if glu:
            h, g = h.chunk(2, dim=-1)
            h = h * act(g)
        else:
            h = act(h)
        return (h @ layer.wo[e]).numpy()


def routing_oracle(layer, x, K, glu=False, swish=False):
    """Token-by-token routing with unlimited capacity."""
    logits = x @ layer.router.detach().numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    y = np.zeros_like(x)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            order = np.argsort(-probs[b, s], kind="stable")[:K]
            gates = probs[b, s][order] / probs[b, s][order].sum()
            for g, e in zip(gates, order):
                y[b, s] += g * expert_mlp(layer, e, x[b, s], glu, swish)
    return y


def moe(router=None, **kw):
    torch.manual_seed(0)
    layer = MoEFeedForward(**kw)
    if router is not None:
        with torch.no_grad():
            layer.router.copy_(torch.as_tensor(router))
    return layer


def test_matches_the_oracle_with_ample_capacity():
    layer = moe(dim=16, num_experts=4, top_k=2, capacity_factor=4.0, mult=2, glu=True, swish=True)
    x = rand(1, 2, 8, 16)
    y, _, drop = run_port(layer, x)
    np.testing.assert_allclose(y, routing_oracle(layer, x, 2, glu=True, swish=True), atol=1e-5, rtol=1e-4)
    assert drop == 0.0


def test_capacity_overflow_drops_late_tokens():
    """A zero router sends every token to expert 0; capacity 1 keeps the
    first token of each row."""
    layer = moe(np.zeros((8, 2)), dim=8, num_experts=2, top_k=1, capacity_factor=0.5, mult=1)
    y, _, drop = run_port(layer, rand(2, 2, 4, 8))
    assert np.abs(y[:, 0]).max() > 1e-4
    np.testing.assert_array_equal(y[:, 1:], 0.0)
    assert drop == pytest.approx(0.75)


def test_slot_major_priority():
    """Every first choice is placed before any second choice: capacity 2 an
    expert holds the two tokens that prefer it, their second choices drop."""
    router = np.zeros((8, 2), np.float32)
    router[0, 0] = router[1, 1] = 4.0
    layer = moe(router, dim=8, num_experts=2, top_k=2, capacity_factor=0.5, mult=1)
    x = np.zeros((1, 4, 8), np.float32)
    x[0, 0, 0] = x[0, 1, 0] = x[0, 2, 1] = x[0, 3, 1] = 1.0
    y, _, drop = run_port(layer, x)
    probs = torch.softmax(torch.from_numpy(x) @ layer.router.detach(), -1).numpy()
    for s, first in [(0, 0), (1, 0), (2, 1), (3, 1)]:
        gates = np.sort(probs[0, s])[::-1]
        np.testing.assert_allclose(y[0, s], gates[0] / gates.sum() * expert_mlp(layer, first, x[0, s]), atol=1e-5)
    assert drop == pytest.approx(0.5)


def test_gate_renormalisation_sums_to_one():
    """Identical experts: the combined output is one expert's, whatever the
    split of the renormalised gates."""
    layer = moe(dim=8, num_experts=4, top_k=2, capacity_factor=4.0, mult=1)
    with torch.no_grad():
        layer.wi.copy_(layer.wi[:1].expand_as(layer.wi))
        layer.wo.copy_(layer.wo[:1].expand_as(layer.wo))
    x = rand(3, 1, 2, 8)
    y, _, _ = run_port(layer, x)
    np.testing.assert_allclose(y[0], np.stack([expert_mlp(layer, 0, x[0, s]) for s in range(2)]), atol=1e-5,
                               rtol=1e-4)


def test_load_balance_hand_value():
    """A zero router: importance 1/E each, all top-1 traffic on expert 0, so
    aux = E * (1/E * 1) * w = w."""
    layer = moe(np.zeros((8, 4)), dim=8, num_experts=4, top_k=2, capacity_factor=2.0, mult=1,
                router_aux_weight=1e-2)
    assert run_port(layer, rand(4, 2, 8, 8))[1] == pytest.approx(1e-2, rel=1e-6)


def test_router_z_loss_hand_value():
    """Zero logits: logsumexp = log(E), z-loss = w_z * log(E)^2."""
    layer = moe(np.zeros((8, 4)), dim=8, num_experts=4, top_k=1, capacity_factor=2.0, mult=1,
                router_aux_weight=0.0, router_z_weight=0.1)
    assert run_port(layer, rand(5, 1, 4, 8))[1] == pytest.approx(0.1 * np.log(4) ** 2, rel=1e-5)


def test_pads_take_no_capacity():
    """Capacity 1, every token to expert 0, token 0 a pad: the slot goes to
    the first real token, and the pad's row is zero."""
    layer = moe(np.zeros((8, 2)), dim=8, num_experts=2, top_k=1, capacity_factor=0.5, mult=1)
    y, _, _ = run_port(layer, rand(6, 2, 4, 8), np.array([[0, 1, 1, 1]] * 2, bool))
    np.testing.assert_array_equal(y[:, 0], 0.0)
    assert np.abs(y[:, 1]).max() > 1e-4
    np.testing.assert_array_equal(y[:, 2:], 0.0)


def test_aux_over_real_tokens_only():
    layer = moe(np.zeros((8, 4)), dim=8, num_experts=4, top_k=1, capacity_factor=4.0, mult=1,
                router_aux_weight=1e-2)
    x = rand(7, 2, 8, 8)
    for n_pad in (0, 3, 6):
        mask = np.ones((2, 8), bool)
        if n_pad:
            mask[:, -n_pad:] = False
        assert run_port(layer, x, mask)[1] == pytest.approx(1e-2, rel=1e-6)


def test_output_keeps_the_input_dtype():
    """bf16 in, bf16 out; dispatch, combine and the experts in fp32 between,
    as jnp promotes the one-hot with the fp32 keep mask."""
    module, params, layer = jax_layer(dim=8, num_experts=2, top_k=1, mult=1, perturb=False)
    x = rand(8, 1, 4, 8)
    want = module.apply({"params": params}, jnp.asarray(x, jnp.bfloat16), mutable=["losses"])[0]
    with torch.no_grad():
        got = layer(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)


def _stack_config(jax_side=False, **ff):
    A, Fc, Tc = ((JaxAttentionConfig, JaxFeedForwardConfig, JaxTransformerConfig) if jax_side
                 else (AttentionConfig, FeedForwardConfig, TransformerConfig))
    ff = {"num_experts": 4, "expert_top_k": 2, "capacity_factor": 2.0, "glu": True, "swish": True, **ff}
    return Tc(dim=16, depth=2, heads=2, causal=True, attention=A(dim_head=8, one_kv_head=True),
              feed_forward=Fc(**ff))


def stack_state(params):
    """A flax TransformerStack's parameters as the port's stack's state dict."""
    sd = state_dict_from_jax({"perf_decoder": {"transformer": params}})
    return {k.replace("perf_decoder.model.transformer.", ""): v for k, v in sd.items()}


def test_post_act_ln_with_moe_raises():
    with pytest.raises(ValueError, match="post_act_ln"):
        TransformerStack(_stack_config(num_experts=2, post_act_ln=True))


def test_a_dense_stack_reports_nothing():
    cfg = _stack_config(num_experts=0)
    stack = TransformerStack(cfg).eval()
    x = torch.from_numpy(rand(9, 2, 8, 16))
    stats = []
    with torch.no_grad():
        out = stack(x, moe_stats=stats)
        assert stats == []
        torch.testing.assert_close(out, stack(x), rtol=0, atol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_stride_substitution_and_aux_match_flax(stride):
    """moe_stride 2 over depth 2: only the second feed-forward is MoE (the
    flax layer names hold a router at layer 3 alone); the stack's output
    and its layers' aux and drop rates equal flax's."""
    jstack = JaxStack(config=_stack_config(True, moe_stride=stride))
    x, mask = rand(10, 2, 8, 16), np.ones((2, 8), bool)
    mask[1, 6:] = False
    params = jax.device_get(jstack.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x),
                                        mask=jnp.asarray(mask))["params"])
    moe_layers = sorted(k for k, v in params.items() if "router" in v)
    assert moe_layers == (["layer_1_ff", "layer_3_ff"] if stride == 1 else ["layer_3_ff"])
    (want, _, _), mut = jstack.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask),
                                     mutable=["losses", "metrics"])
    stack = TransformerStack(_stack_config(moe_stride=stride)).eval()
    load_state_dict(stack, stack_state(params))
    assert [i for i, (_, b) in enumerate(stack.layers) if isinstance(b, MoEFeedForward)] == [
        int(n.split("_")[1]) for n in moe_layers]
    stats = []
    with torch.no_grad():
        got = stack(torch.from_numpy(x), mask=torch.from_numpy(mask), moe_stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    aux = [float(mut["losses"][n]["moe_aux"][0]) for n in moe_layers]
    drop = [float(mut["metrics"][n]["moe_drop"][0]) for n in moe_layers]
    np.testing.assert_allclose([a.item() for a, _ in stats], aux, **LAYER_TOL)
    np.testing.assert_allclose([d.item() for _, d in stats], drop, atol=1e-7)


def test_cached_decode_ignores_the_key_mask():
    """With a KV cache, `mask` covers the cache's keys, not the fresh
    tokens: MoE routing takes no mask there (it would not fit x), as in
    JAX, and gives flax's output."""
    jstack = JaxStack(config=_stack_config(True))
    x = rand(11, 2, 8, 16)
    params = jax.device_get(jstack.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x))["params"])
    key_mask = np.zeros((2, 16), bool)
    key_mask[:, :8] = True
    jcaches = [jax_init_kv_cache(2, 16, 8), None, jax_init_kv_cache(2, 16, 8), None]
    (want, _, _), _ = jstack.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(key_mask), caches=jcaches,
                                   cache_index=jnp.zeros((), jnp.int32), mutable=["losses"])
    stack = TransformerStack(_stack_config()).eval()
    load_state_dict(stack, stack_state(params))
    caches = [init_kv_cache(2, 16, 8), None, init_kv_cache(2, 16, 8), None]
    stats = []
    with torch.no_grad():
        got = stack(torch.from_numpy(x), mask=torch.from_numpy(key_mask), caches=caches,
                    cache_index=torch.zeros(1, dtype=torch.int64), moe_stats=stats)
    assert got.shape == x.shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert len(stats) == 2


# ---- a tiny moe.yaml-shaped ScorePerformer ----


def moe_tiny_config(**kw):
    """tests/test_torch_modules.py's tiny model with moe.yaml's feed-forward
    in all three stacks (base.yaml points both encoders' feed_forward at the
    decoder's) and a score encoder 2 deep, so that each stack holds one MoE
    layer at moe_stride 2."""
    cfg = tm.tiny_config(**kw)
    cfg["score_encoder"]["transformer"]["depth"] = 2
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"]["feed_forward"] = {**cfg[key]["transformer"]["feed_forward"], **MOE_FF}
    return cfg


@pytest.fixture(scope="module")
def step_pair():
    batch = tt.train_batch()
    cfg = moe_tiny_config()
    cfg["perf_encoder"].update(mmd_max_num_latents=100, mmd_num_samples=16, deadpan_zero_latent=True)
    model, variables, port = tm.build_pair(cfg, {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")}
                                           | {"mask": batch["perf_mask"], "masked": batch["masked_perf"]})
    return model, variables, port, batch


def test_weights_convert_both_ways(step_pair):
    """Every MoE parameter of the JAX tree lands on the port's layer of the
    same index, and `jax_param_paths` walks the port's parameters back to
    the JAX tree's paths."""
    model, variables, port, _ = step_pair
    params = jax.device_get(variables["params"])
    sd = state_dict_from_jax(params)
    moe_names = sorted(n for n in sd if n.rsplit(".", 1)[1] in ("router", "wi", "wo"))
    assert moe_names == sorted(f"{p}transformer.layers.{i}.1.{leaf}"
                               for p, i in (("score_encoder.", 3), ("perf_encoder.", 3), ("perf_decoder.model.", 3))
                               for leaf in ("router", "wi", "wo"))
    own = dict(port.named_parameters())
    for name in moe_names:
        np.testing.assert_array_equal(own[name].detach().numpy(), sd[name])
    flat = {tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {path for path, _ in jax_param_paths(port).values()} == flat
    assert sum(isinstance(m, MoEFeedForward) for m in port.modules()) == 3


def jax_moe_step(model, params, batch, monkeypatch):
    """The JAX trainer's forward (training/trainer.py:335-358) under
    `jax.value_and_grad`, deterministic: the sown aux losses added to the
    loss as `loss/moe_aux`, the drop rates' mean as `stats/moe_drop`; the
    MMD draws of every `mmd_loss` call returned."""
    orig = jmmd.mmd_loss

    def loss_fn(p, jbatch):
        calls = []

        def record(rng, latents, mask=None, num_samples=256, max_num_latents=4096):
            d = latents.shape[-1]
            calls.append(tt.jax_mmd_draws_traced(rng, d, latents.size // d, num_samples, max_num_latents))
            return orig(rng, latents, mask, num_samples, max_num_latents)

        monkeypatch.setattr(jmmd, "mmd_loss", record)
        out, mut = model.apply({"params": p}, **jbatch, deterministic=True, rngs={"mmd": jax.random.PRNGKey(5)},
                               mutable=["losses", "metrics"])
        losses = dict(out.losses)
        sown = jax.tree.leaves(mut["losses"])
        aux = sum(v.astype(jnp.float32) for v in sown)
        losses["loss/moe_aux"] = aux
        drops = jax.tree.leaves(mut["metrics"])
        losses["stats/moe_drop"] = sum(drops) / len(drops)
        return out.loss + aux, (losses, calls, len(sown))

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (losses, calls, n_sown)), grads = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert n_sown == 3
    draws = [(np.asarray(z), None if u is None else np.asarray(u)) for z, u in calls]
    return loss, losses, grads, draws


def test_train_step_loss_with_aux_and_gradients_match_jax(step_pair, monkeypatch):
    model, variables, port, batch = step_pair
    loss, losses, grads, draws = jax_moe_step(model, variables["params"], batch, monkeypatch)
    port.zero_grad()
    out = port(**tt.port_batch(batch), mmd_sampler=tt.replay(draws))
    (out.loss + out.moe_aux).backward()
    np.testing.assert_allclose((out.loss + out.moe_aux).item(), float(loss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.moe_aux.item(), float(losses["loss/moe_aux"]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(out.moe_drop.item(), float(losses["stats/moe_drop"]), atol=1e-7)
    assert 0.0 < out.moe_drop.item() < 1.0, "no assignment overflowed"
    for key in out.losses:
        np.testing.assert_allclose(out.losses[key].item(), float(losses[key]), atol=1e-5, rtol=1e-5, err_msg=key)
    params = dict(port.named_parameters(remove_duplicate=False))
    names = state_dict_from_jax(jax.device_get(grads))
    assert sum(n.endswith(".router") for n in names) == 3
    for name, want in names.items():
        got = params[name.replace("proj|0", "proj")].grad
        # 1e-4 absolute, scaled by the gradient's largest value where that
        # passes 1: the stream tables' value layers take gradients of ~3e3
        # whose small elements cancel, and fp32 sums leave them ~4e-7 of the
        # largest apart, in the dense model as in this one
        atol = GRAD_TOL["atol"] * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, atol=atol, rtol=GRAD_TOL["rtol"])


@pytest.mark.parametrize("option", ["plain", "remat", "bf16_compute"])
def test_trainer_logs_moe_aux_and_drop(tmp_path, option):
    """The train step adds the aux to its loss and logs `loss/moe_aux` and
    `stats/moe_drop`, also under `remat` (the checkpointed forward returns
    them; the same loss as without) and `bf16_compute`; eval logs both
    beside a loss without the aux, as the JAX trainer's steps do."""
    batch = tt.port_batch(tt.train_batch())

    def trainer_for(**options):
        port, _ = build_scoreperformer(moe_tiny_config(), device="cpu", seed=0)
        trainer = Trainer(port, TrainerConfig(output_dir=str(tmp_path), tensorboard=False, disable_progress=True,
                                              **options))
        trainer._prepare()
        return port, trainer

    port, trainer = trainer_for(**({} if option == "plain" else {option: True}))
    evals = trainer.eval_step(batch, 0)
    with torch.no_grad():
        out = port.eval()(**batch, generators={"mmd": step_generators(0, 0, "cpu")["mmd"]})
    assert {"loss", "loss/moe_aux", "stats/moe_drop"} <= set(evals)
    assert evals["loss/moe_aux"].item() == pytest.approx(out.moe_aux.item(), rel=1e-2 if option == "bf16_compute" else 1e-6)
    if option != "bf16_compute":
        assert evals["loss"].item() == pytest.approx(out.loss.item(), rel=1e-6)
        assert evals["stats/moe_drop"].item() == pytest.approx(out.moe_drop.item(), abs=1e-7)
    metrics = trainer.train_step(batch, 0)
    assert {"loss/moe_aux", "stats/moe_drop", "loss/lm", "MMD"} <= set(metrics)
    assert metrics["loss"].item() == pytest.approx(
        metrics["loss/lm"].item() + metrics["MMD"].item() + metrics["loss/moe_aux"].item(), rel=1e-5)
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in port.parameters())
    if option == "remat":
        _, plain = trainer_for()
        want = plain.train_step(batch, 0)
        for key in ("loss", "loss/moe_aux", "stats/moe_drop"):
            assert metrics[key].item() == pytest.approx(want[key].item(), rel=1e-6), key


def test_greedy_render_matches_jax(tmp_path):
    """A 4-bar synthetic score through both packages' render with the tiny
    MoE model, greedy: the same notes. The encoders route the whole score,
    every decode step routes one token (capacity 1)."""
    ap = {"max_bar_embedding": 32}
    jtok, ttok = JaxTokenizer(JaxTokenizerConfig(additional_params=ap)), SPMupleWindow(TokenizerConfig(additional_params=ap))
    jscore, tscore = jax_synthetic_score(np.random.RandomState(3), n_bars=4), synthetic_score(np.random.RandomState(3), n_bars=4)
    n_notes = len(ttok.score_midi_to_tokens(tscore).ids)
    token_values = {k: v.tolist() for k, v in ttok.token_values(normalize=True).items()}
    cfg = moe_tiny_config(use_flash=True, num_tokens=ttok.performance_sizes, score_tokens=ttok.score_sizes,
                          token_values=token_values, max_segments=n_notes + 4)
    rng = np.random.RandomState(0)
    inputs = tm.make_inputs()
    inputs["perf"] = np.stack([rng.randint(4, v, (2, 12)) for v in ttok.performance_sizes.values()], -1).astype(np.int32)
    inputs["masked"] = inputs["perf"].copy()
    inputs["score"] = inputs["perf"][..., : len(ttok.score_sizes)].copy()
    model, variables, port = tm.build_pair(cfg, inputs)
    want = jax_render(model, variables, jtok, jscore, rng=jax.random.PRNGKey(0), greedy=True)
    got = render_performance(port, ttok, tscore, greedy=True, device="cpu")
    assert got.num_notes == want.num_notes > 0
    w, g = want.all_notes(), got.all_notes()
    for field in ("pitch", "velocity", "start", "end"):
        np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


TINY_STREAMING_CFG = ts.tiny_cfg


def moe_streaming_cfg():
    """tests/test_torch_streaming.py's model with an MoE layer in place of
    every feed-forward (its stacks are one layer deep): the decoder's
    consume calls route 8-row chunks with their padded tails."""
    cfg = TINY_STREAMING_CFG()
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"] = {**cfg[key]["transformer"],
                                   "feed_forward": {**cfg[key]["transformer"]["feed_forward"], **MOE_FF,
                                                    "moe_stride": 1}}
    return cfg


def test_greedy_streaming_windows_equal_jax(tmp_path, monkeypatch):
    """12 greedy windows of blocks up to JAX's 32 bucket, with window
    shifts and rollbacks: the rows each consume call routes are JAX's, so
    the tokens are JAX's."""
    monkeypatch.setattr(ts, "tiny_cfg", moe_streaming_cfg)
    pair = ts.Pair(str(tmp_path))
    assert sum(isinstance(m, MoEFeedForward) for m in pair.port.modules()) == 3
    consumed = []
    orig = MoEFeedForward.forward

    def spy(layer, x, mask=None, with_stats=False):
        consumed.append(x.shape[1])
        return orig(layer, x, mask, with_stats)

    monkeypatch.setattr(MoEFeedForward, "forward", spy)
    kw = dict(greedy=True, block_size=32, window=0.5)
    want = ts.drive(pair.jgen, **kw)
    got = ts.drive(pair.tgen, **kw)
    assert len(want) >= 10 and max(w[2] for w in want) > 0, "no window shift"
    assert any(c > 1 for c in consumed), "no multi-row consume call"
    ts.assert_same_windows(want, got)


def test_train_entry_point_trains_moe_yaml_and_its_checkpoint_renders(tmp_path):
    """`python -m scoreperformer_tpu_torch.train` on a recipe over the
    repo's moe.yaml (its widths shrunk, each stack 2 deep so that each holds
    one MoE layer; base.yaml's direction classifiers), on the CPU: the steps
    log `loss/moe_aux` and `stats/moe_drop`, and the checkpoint renders."""
    from scoreperformer_tpu_torch import train as ttrain
    from scoreperformer_tpu_torch.data import build_synthetic_dataset
    from scoreperformer_tpu_torch.inference import load_model_from_checkpoint

    root = tmp_path / "data"
    build_synthetic_dataset(str(root), n_scores=2, n_perfs_per_score=2, n_bars=12, seed=3, splits=True)
    lines = [f"base: {TESTS.parent / 'recipes' / 'scoreperformer' / 'moe.yaml'}", "data:", "  dataset:",
             f"    root: {root}", "    max_seq_len: 30", "    bar_sliding_window: 4",
             f"    performance_directions: {root / 'direction_classes.json'}",
             f"    score_directions_dict: {root / 'score_directions.json'}", "model:", "  dim: 32"]
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        lines += [f"  {key}:", "    token_embeddings:", "      emb_dims: 16", "    max_seq_len: 32",
                  "    transformer:", "      depth: 2", "      heads: 2"]
        if key == "perf_encoder":
            lines += ["    max_segments: 40", "    latent_dim: [8, 6, 4, 2]"]
        if key == "perf_decoder":
            lines += ["      attention:", "        dim_head: 8"]
    lines += ["trainer:", f"  output_dir: {tmp_path / 'run'}", "  epochs: 2", "  max_steps: 2", "  batch_size: 4",
              "  eval_batch_size: 4", "  num_workers: 1", "  log_steps: 1", "  save_strategy: 'no'",
              "  eval_strategy: 'no'", "  disable_progress: true", "  tensorboard: false"]
    (tmp_path / "moe_tiny.yaml").write_text("\n".join(lines) + "\n")
    ttrain.main(["-r", str(tmp_path), "-n", "moe_tiny.yaml", "--device", "cpu"])
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [log for log in logs if "train_step/loss" in log]
    assert len(steps) == 2
    for log in steps:
        assert np.isfinite(log["train_step/loss/moe_aux"]) and 0.0 <= log["train_step/stats/moe_drop"] <= 1.0
    model, _ = load_model_from_checkpoint(str(tmp_path / "run" / "checkpoint_last"), device="cpu")
    assert sum(isinstance(m, MoEFeedForward) for m in model.modules()) == 3
    assert model.classifiers is not None
    tok = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))
    perf = render_performance(model, tok, synthetic_score(np.random.RandomState(5), n_bars=2), greedy=True,
                              device="cpu")
    assert np.isfinite(perf.all_notes().start).all()

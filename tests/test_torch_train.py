"""The port's training path against the JAX package's, on the CPU.

Losses, MMD terms and one whole train step's gradients go through both
frameworks on the same weights (a JAX `model.init` carried over by
`scoreperformer_tpu_torch.convert`) and the same numpy inputs. JAX's MMD
samples are caught by wrapping `scoreperformer_tpu.models.mmd.mmd_loss` in the
test and handed to the port. Tolerances: losses 1e-5 (terms 1e-6 where a
single function is compared), gradients atol/rtol 1e-4, as whole encoders
already need (tests/test_torch_modules.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.models import mmd as jmmd
from scoreperformer_tpu.models import scoreperformer as jsp

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.models import mmd as tmmd
from scoreperformer_tpu_torch.models import scoreperformer as tsp

from test_torch_modules import PERF_DIMS, build_pair, make_inputs, tiny_config

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_mmd_draws(rng, d, n_latents, num_samples, max_num_latents):
    """The z and u that `mmd_loss` draws from `rng` (mmd.py:127-137)."""
    rng_z, rng_sub = jax.random.split(rng)
    z = np.asarray(jax.random.normal(rng_z, (num_samples, d)))
    u = np.asarray(jax.random.uniform(rng_sub, (max_num_latents,))) if n_latents > max_num_latents else None
    return z, u


# ---- lm_losses and shift_for_lm: 1e-6 ----


def test_lm_losses_match_jax_with_streams_without_labels():
    rng = np.random.RandomState(0)
    sizes = {"a": 7, "b": 5, "c": 9, "d": 4}
    logits = {k: rand(i, 2, 6, v) * 3 for i, (k, v) in enumerate(sizes.items())}
    labels = np.stack([rng.randint(0, v, (2, 6)) for v in sizes.values()], -1)
    labels[rng.rand(2, 6, 4) < 0.4] = -100
    labels[..., 1] = -100  # stream "b" has no valid label
    want, want_terms = jsp.lm_losses({k: jnp.asarray(v) for k, v in logits.items()}, jnp.asarray(labels))
    got, got_terms = tsp.lm_losses({k: torch.from_numpy(v) for k, v in logits.items()}, torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    for k in sizes:
        np.testing.assert_allclose(got_terms[k].numpy(), np.asarray(want_terms[k]), atol=1e-6, rtol=1e-6)
    all_ignored = np.full_like(labels, -100)
    got, _ = tsp.lm_losses({k: torch.from_numpy(v) for k, v in logits.items()}, torch.from_numpy(all_ignored))
    assert got.item() == 0.0


@pytest.mark.parametrize("mode,context_is_cat", [("mixlm", True), ("clm", False), ("mlm", True)])
def test_shift_for_lm_matches_jax(mode, context_is_cat):
    x = {k: rand(i, 2, 5, 3) for i, k in enumerate(("perf", "labels", "masked", "context", "style"))}
    mask = np.ones((2, 5), bool)
    want = jsp.shift_for_lm(mode, *(jnp.asarray(v) for v in x.values()), jnp.asarray(mask), context_is_cat)
    got = tsp.shift_for_lm(mode, *(torch.from_numpy(v) for v in x.values()), torch.from_numpy(mask), context_is_cat)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the MMD loss: 1e-6, with JAX's own samples ----


@pytest.mark.parametrize("n,max_num_latents", [(40, 4096), (40, 16)], ids=["exact", "subsample"])
def test_mmd_loss_matches_jax(n, max_num_latents):
    latents = rand(1, 4, n // 4, 6) * 0.7
    mask = np.random.RandomState(2).rand(4, n // 4) < 0.7
    latents = latents * mask[..., None]
    rng = jax.random.PRNGKey(7)
    want = jmmd.mmd_loss(rng, jnp.asarray(latents), jnp.asarray(mask), num_samples=32,
                         max_num_latents=max_num_latents)
    z, u = jax_mmd_draws(rng, 6, n, 32, max_num_latents)
    got = tmmd.mmd_loss(torch.from_numpy(latents), torch.from_numpy(mask), torch.from_numpy(z),
                        None if u is None else torch.from_numpy(u), max_num_latents=max_num_latents)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_gaussian_kernel_matches_jax():
    x, y = rand(3, 7, 5), rand(4, 9, 5)
    np.testing.assert_allclose(tmmd.gaussian_kernel(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jmmd.gaussian_kernel(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-6, rtol=1e-6)


# ---- one whole train step against jax.value_and_grad ----


def train_batch(seed=0, b=2, t=12):
    x = make_inputs(seed, b, t)
    labels = np.full(x["perf"].shape, -100, np.int32)
    labels[..., PERF_DIMS] = x["perf"][..., PERF_DIMS]
    labels[~x["mask"]] = -100
    labels[..., PERF_DIMS[-1]] = -100  # a stream with no valid label
    return {
        "perf": x["perf"], "perf_mask": x["mask"], "score": x["score"], "score_mask": x["mask"],
        "masked_perf": x["masked"], "labels": labels, "bars": x["bars"], "beats": x["beats"],
        "onsets": x["onsets"], "deadpan_mask": np.array([True, False])[:b],
    }


def train_config(use_flash):
    cfg = tiny_config(use_flash=use_flash)
    # small enough that the bar/beat/onset levels (2 x 64 latents) take the subsample path
    cfg["perf_encoder"].update(mmd_max_num_latents=100, mmd_num_samples=16, deadpan_zero_latent=True)
    return cfg


def jax_mmd_draws_traced(rng, d, n_latents, num_samples, max_num_latents):
    rng_z, rng_sub = jax.random.split(rng)
    z = jax.random.normal(rng_z, (num_samples, d))
    return z, jax.random.uniform(rng_sub, (max_num_latents,)) if n_latents > max_num_latents else None


def jax_step(model, params, batch, monkeypatch):
    """loss, losses, grads of model.apply(deterministic=True) under jit, and
    the MMD draws of every `mmd_loss` call in order (returned as outputs)."""
    orig = jmmd.mmd_loss

    def loss_fn(p, jbatch):
        calls = []

        def record(rng, latents, mask=None, num_samples=256, max_num_latents=4096):
            d = latents.shape[-1]
            calls.append(jax_mmd_draws_traced(rng, d, latents.size // d, num_samples, max_num_latents))
            return orig(rng, latents, mask, num_samples, max_num_latents)

        monkeypatch.setattr(jmmd, "mmd_loss", record)
        out = model.apply({"params": p}, **jbatch, deterministic=True, rngs={"mmd": jax.random.PRNGKey(5)})
        return out.loss, (out.losses, calls)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (losses, calls)), grads = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
    draws = [(np.asarray(z), None if u is None else np.asarray(u)) for z, u in calls]
    return loss, losses, grads, draws


def replay(draws):
    draws = list(draws)

    def sample(d, n_latents):
        z, u = draws.pop(0)
        assert z.shape[1] == d
        return torch.from_numpy(z), None if u is None else torch.from_numpy(u)

    return sample


def port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["xla_attention", "flash_attention"])
def step_pair(request):
    batch = train_batch()
    cfg = train_config(request.param)
    model, variables, port = build_pair(cfg, {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")}
                                        | {"mask": batch["perf_mask"], "masked": batch["masked_perf"]})
    return model, variables, port, batch


def test_train_step_loss_and_gradients_match_jax(step_pair, monkeypatch):
    model, variables, port, batch = step_pair
    loss, losses, grads, draws = jax_step(model, variables["params"], batch, monkeypatch)
    assert any(u is not None for _, u in draws) and any(u is None for _, u in draws)
    port.zero_grad()
    out = port(**port_batch(batch), mmd_sampler=replay(draws))
    out.loss.backward()
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


def test_latent_drop_mask_matches_jax():
    """Latent dropout in training, made deterministic with rates 0 and 1: the
    bar level drops every valid segment, the levels below drop with it
    (inclusive propagation), deadpan sequences and padding never drop."""
    cfg = tiny_config()
    cfg["perf_encoder"]["latent_dropout"] = [0.0, 1.0, 0.0, 0.0]
    x = make_inputs()
    model, variables, port = build_pair(cfg, x)
    deadpan = np.array([False, True])
    args = [x[k] for k in ("perf", "mask", "bars", "beats", "onsets")] + [deadpan]
    want = jax.jit(lambda v, *a: model.apply(
        v, *a, rngs={"latent_dropout": jax.random.PRNGKey(3)},
        method=lambda m, p, k, ba, be, on, dp: m.perf_encoder(
            p, mask=k, bars=ba, beats=be, onsets=on, deadpan_mask=dp, deterministic=False, compute_loss=False),
    ))(variables, *map(jnp.asarray, args))
    enc = port.perf_encoder.train()
    with torch.no_grad():
        got = enc(torch.from_numpy(x["perf"]).long(), mask=torch.from_numpy(x["mask"]),
                  bars=torch.from_numpy(x["bars"]).long(), beats=torch.from_numpy(x["beats"]).long(),
                  onsets=torch.from_numpy(x["onsets"]).long(), deadpan_mask=torch.from_numpy(deadpan))
    np.testing.assert_array_equal(got.dropout_mask.numpy(), np.asarray(want.dropout_mask))
    assert got.dropout_mask[0].any() and not got.dropout_mask[1].any()
    np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.full_embeddings.numpy(), np.asarray(want.full_embeddings), atol=1e-4, rtol=1e-4)

"""The port's multi-device training (`scoreperformer_tpu_torch.parallel`)
against the JAX package, on the CPU over gloo.

Multi-rank cases spawn 2 or 4 processes through the port's launcher
(`parallel.launch`), each joining a group from a `file://` store of its own,
and train a tiny model (tests/test_torch_modules.py's sizes, GLU and learned
ALiBi on) through the `Trainer` on the mesh they ask for. Tolerances:
- against `jax.value_and_grad`'s single-device step, with JAX's MMD samples
  handed in: loss 1e-5, gradients 1e-4 (absolute, scaled by a gradient's
  largest value where that passes 1, as tests/test_torch_moe.py states it for
  the stream tables' value layers), `loss/moe_aux` and `stats/moe_drop` 1e-6;
- against the port's own one-process step (dropout on): loss 1e-6,
  gradients and the parameters after 2 steps 1e-5 (scaled likewise);
- ZeRO against optax: 1e-6, as tests/test_torch_optimizers.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scoreperformer_tpu.parallel.mesh import _zero_spec
from scoreperformer_tpu.training import optimizers as joptim
from scoreperformer_tpu.training.trainer import TrainerConfig as JTrainerConfig

from scoreperformer_tpu_torch.convert import state_dict_from_jax
from scoreperformer_tpu_torch.parallel import mesh_layout, zero_split_dim
from scoreperformer_tpu_torch.parallel.launch import launch
from scoreperformer_tpu_torch.parallel.workers import run_one_process, train_worker
from scoreperformer_tpu_torch.training import Trainer, TrainerConfig

import test_torch_modules as tm
import test_torch_moe as tmoe
import test_torch_train as tt
from test_torch_parallel_workers import autograd_pairs_worker, optimizer_worker, replay_first_step

torch.set_num_threads(1)


def close(got, want, tol, name=""):
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=tol, err_msg=name)


def payload(tmp_path, cfg, state_dict, batch, trainer, steps=1, **kw):
    path = tmp_path / "payload.pt"
    torch.save({"model_name": "ScorePerformer", "model_config": cfg, "state_dict": state_dict, "batch": batch,
                "steps": steps, "trainer": trainer, "output_dir": str(tmp_path / "run"), "device": "cpu", **kw}, path)
    return str(path)


# ---- the layout and the ZeRO rule ----


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (1, 2, 2), (2, 2, 2)])
def test_rank_layout_is_the_numpy_reshape(shape):
    np.testing.assert_array_equal(mesh_layout(*shape), np.arange(np.prod(shape)).reshape(shape))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(), (7,), (8,), (3, 4), (4, 4), (6, 8), (256, 1024), (5, 3), (2, 12, 8), (1,)])
def test_zero_split_dim_is_jax_zero_spec(shape, n):
    class Mesh:
        pass

    mesh = Mesh()
    mesh.shape = {"data": n}
    leaf = np.zeros(shape, np.float32)
    spec = tuple(_zero_spec(leaf, mesh))
    want = spec.index("data") if "data" in spec else None
    assert zero_split_dim(shape, n) == want


def test_trainer_config_defaults_are_jax_s():
    """Every field of JAX's TrainerConfig is in the port's with the same
    default, the multihost fields included. The exception: `do_train`,
    which the JAX trainer never reads (the CLI's --eval-only decides)."""
    exceptions = {"do_train": "never read by the JAX trainer"}
    ours = {f.name: f for f in dataclasses.fields(TrainerConfig)}
    for f in dataclasses.fields(JTrainerConfig):
        if f.name in exceptions:
            assert f.name not in ours, f.name
            continue
        assert f.name in ours, f.name
        if f.name == "optimization":
            continue  # the optimizer's own config, held by tests/test_torch_optimizers.py
        jdefault = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        tdefault = ours[f.name].default_factory() if ours[f.name].default_factory is not dataclasses.MISSING \
            else ours[f.name].default
        assert tdefault == jdefault, f.name
    for name in ("coordinator_address", "num_processes", "process_id"):
        assert ours[name].default is None


def test_what_is_not_ported_raises(tmp_path):
    """Every option of the JAX trainer is ported: sequence parallelism on a
    model axis is refused only for want of ranks (its values:
    tests/test_torch_sequence_parallel.py). What JAX refuses is refused: an
    MoE trunk has no pipeline depth unit (NotImplementedError, as JAX)."""
    from scoreperformer_tpu_torch.models.transformer import FeedForwardConfig, TransformerConfig
    from scoreperformer_tpu_torch.parallel.pipeline import make_unit_module

    with pytest.raises(ValueError, match="needs 2 ranks"):
        Trainer(torch.nn.Linear(1, 1), TrainerConfig(output_dir=str(tmp_path), mesh_model=2, sequence_parallel=True))
    with pytest.raises(NotImplementedError, match="MoE"):
        make_unit_module(TransformerConfig(feed_forward=FeedForwardConfig(num_experts=4)))


def test_launch_and_the_workers_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(autograd_pairs_worker, 2)
    path = tmp_path / "payload.pt"
    torch.save({"trainer": {}}, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_worker(0, 1, str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_one_process({"trainer": {}})


def test_autograd_pairs_sum_over_the_axis_from_another_thread():
    """copy-to-group sums the gradient over the ranks, reduce-from-group
    passes it through, gather-rows sums the gathered gradient and keeps the
    rank's rows, also when the backward runs where the mesh is not active
    (autograd's device thread on the card)."""
    got = launch(autograd_pairs_worker, 2, (), device="cpu")
    for rank, res in enumerate(got):
        # y = x (or the sum, or the rows of both ranks); loss = sum(y * w * (rank + 1))
        assert res["copy_to_group"] == [1 * 1 + 1 * 2, 2 * 1 + 2 * 2]
        assert res["reduce_from_group"] == [1.0 * (rank + 1), 2.0 * (rank + 1)]
        rows = [2 * rank + 1, 2 * rank + 2]
        assert res["gather_rows"] == [r * 1 + r * 2 for r in rows]


# ---- the mesh axes against JAX's single-device step ----

DENSE_MESHES = {"data2": {"mesh_data": 2}, "model2": {"mesh_model": 2},
                "data2_model2": {"mesh_data": 2, "mesh_model": 2}}


@pytest.fixture(scope="module")
def dense_pair():
    batch = tt.train_batch()
    cfg = tt.train_config(False)
    model, variables, port = tm.build_pair(cfg, {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")}
                                           | {"mask": batch["perf_mask"], "masked": batch["masked_perf"]})
    return cfg, model, variables, port, batch


@pytest.mark.parametrize("mesh", list(DENSE_MESHES))
def test_mesh_step_matches_jax(dense_pair, mesh, tmp_path, monkeypatch):
    cfg, model, variables, port, batch = dense_pair
    loss, losses, grads, draws = tt.jax_step(model, variables["params"], batch, monkeypatch)
    axes = DENSE_MESHES[mesh]
    n = int(np.prod(list(axes.values())))
    results = launch(train_worker, n, (payload(tmp_path, cfg, port.state_dict(), batch,
                                               {"optimization": {"optimizer": "adamw"}, **axes}, draws=draws),
                                       replay_first_step), device="cpu")
    got = results[0]
    layout = mesh_layout(axes.get("mesh_data", 1), axes.get("mesh_model", 1), 1)
    for r in results:  # rank r at the numpy reshape's coordinate
        assert layout[r["coords"]["data"], r["coords"]["model"], r["coords"]["expert"]] == r["rank"]
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(loss), atol=1e-5, rtol=1e-5)
    for key, value in losses.items():
        np.testing.assert_allclose(got["metrics"][0][key], float(value), atol=1e-5, rtol=1e-5, err_msg=key)
    names = state_dict_from_jax(jax.device_get(grads))
    for name, want in names.items():
        close(got["grads"][name.replace("proj|0", "proj")].numpy(), want, 1e-4, name)


def test_expert_axis_step_matches_jax(tmp_path, monkeypatch):
    """moe.yaml's feed-forward (4 experts, top-2) at expert = 2: 2 experts a
    rank, the loss with the aux, `loss/moe_aux` and `stats/moe_drop`."""
    batch = tt.train_batch()
    cfg = tmoe.moe_tiny_config()
    cfg["perf_encoder"].update(mmd_max_num_latents=100, mmd_num_samples=16, deadpan_zero_latent=True)
    model, variables, port = tm.build_pair(cfg, {k: batch[k] for k in ("perf", "score", "bars", "beats", "onsets")}
                                           | {"mask": batch["perf_mask"], "masked": batch["masked_perf"]})
    loss, losses, grads, draws = tmoe.jax_moe_step(model, variables["params"], batch, monkeypatch)
    results = launch(train_worker, 2, (payload(tmp_path, cfg, port.state_dict(), batch,
                                               {"optimization": {"optimizer": "adamw"}, "mesh_expert": 2},
                                               draws=draws), replay_first_step), device="cpu")
    got = results[0]
    assert [r["coords"]["expert"] for r in results] == [0, 1]
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(loss), atol=1e-5, rtol=1e-5)
    for key in ("loss/moe_aux", "stats/moe_drop"):
        np.testing.assert_allclose(got["metrics"][0][key], float(losses[key]), atol=1e-6, err_msg=key)
    names = state_dict_from_jax(jax.device_get(grads))
    assert sum(n.endswith(".wi") for n in names) == 3
    for name, want in names.items():
        close(got["grads"][name.replace("proj|0", "proj")].numpy(), want, 1e-4, name)


# ---- a step does not depend on the number of ranks, dropout on ----


def dropout_config():
    cfg = tmoe.moe_tiny_config()
    cfg["perf_encoder"].update(mmd_max_num_latents=100, mmd_num_samples=16, deadpan_zero_latent=True,
                               latent_dropout=[0.0, 0.3, 0.3, 0.3])
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["emb_dropout"] = 0.1
        tr = cfg[key]["transformer"]
        tr["attention"] = {**tr["attention"], "dropout": 0.1}
        tr["feed_forward"] = {**tr["feed_forward"], "dropout": 0.1}
    return cfg


@pytest.mark.parametrize("mesh", [{"mesh_data": 2, "mesh_model": 2}, {"mesh_data": 2, "mesh_expert": 2}],
                         ids=["data2_model2", "data2_expert2"])
def test_step_does_not_depend_on_the_world_size_dropout_on(mesh, tmp_path):
    """Attention, feed-forward, expert, embedding and latent dropout on, the
    MMD samples from the step's generator: 2 steps with ZeRO (adamw) on 4
    ranks equal the port's one-process steps (with `remat` at expert = 2)."""
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer

    cfg = dropout_config()
    model, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    batch = tt.train_batch(b=4)
    batch["deadpan_mask"] = np.array([True, False, False, True])
    trainer = {"optimization": {"optimizer": "adamw", "lr": 1e-3}, "zero_sharding": True, "seed": 5, **mesh}
    if "mesh_expert" in mesh:  # the recompute of the backward runs on the mesh too
        trainer["remat"] = True
    path = payload(tmp_path, cfg, model.state_dict(), batch, trainer, steps=2)
    ref = run_one_process(torch.load(path, weights_only=False), device="cpu")
    got = launch(train_worker, 4, (path,), device="cpu")[0]
    for step in range(2):
        for key, value in ref["metrics"][step].items():
            np.testing.assert_allclose(got["metrics"][step][key], value, atol=1e-6, rtol=1e-5, err_msg=key)
    for name, want in ref["grads"].items():
        close(got["grads"][name].numpy(), want.numpy(), 1e-5, name)
    for name, want in ref["params"].items():
        close(got["params"][name].numpy(), want.numpy(), 1e-5, name)


# ---- ZeRO against optax ----

ZERO_OPTIMIZERS = {
    "adamw": dict(optimizer="adamw", lr=0.05, optimizer_params={"weight_decay": 1e-2}, grad_clip=1.0),
    "lamb": dict(optimizer="lamb", lr=0.05, optimizer_params={"weight_decay": 1e-2}),
    "lion": dict(optimizer="lion", lr=0.01),
    "adafactor": dict(optimizer="adafactor", lr=0.05, optimizer_params={"min_dim_size_to_factor": 6}),
}
ZERO_SHAPES = {"w": (8, 6), "b": (4,), "v": (5, 3), "e": (6, 12), "s": (3,)}


def zero_tree():
    params = {k: np.random.RandomState(i).randn(*s).astype(np.float32) for i, (k, s) in enumerate(ZERO_SHAPES.items())}
    grads = [{k: np.random.RandomState(10 + 7 * t + i).randn(*s).astype(np.float32)
              for i, (k, s) in enumerate(ZERO_SHAPES.items())} for t in range(2)]
    return params, grads


def test_zero_optimizers_match_optax_and_keep_their_slice():
    """adamw, lamb, lion and adafactor with ZeRO over a data axis of 2: two
    updates equal optax's on the same gradients; each rank's moments hold
    its slice only (adafactor's factored moments whole, on purpose)."""
    params, grads = zero_tree()
    results = launch(optimizer_worker, 2, (ZERO_OPTIMIZERS, params, grads), device="cpu")
    for name, cfg in ZERO_OPTIMIZERS.items():
        tx = joptim.build_optimizer(joptim.OptimizerConfig.from_dict(cfg))
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)
        for g in grads:
            u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, u)
        for rank, res in enumerate(results):
            got = res[name]
            for k in ZERO_SHAPES:
                np.testing.assert_allclose(got["params"][k], np.asarray(jp[k]), atol=1e-6, rtol=1e-6,
                                           err_msg=f"{name} {k} rank {rank}")
            for k, shape in ZERO_SHAPES.items():
                dim = zero_split_dim(shape, 2)
                held = got["state_shapes"][k]
                factored = name == "adafactor" and got["factored"][k]
                if dim is None or factored:
                    assert held == shape, (name, k)
                else:
                    want = list(shape)
                    want[dim] //= 2
                    assert held == tuple(want), (name, k)
        assert any(results[0]["adafactor"]["factored"].values())


# ---- the model axis's table: the deliberate deviations from JAX's layout ----


@pytest.mark.parametrize("index", [0, 1])
def test_model_axis_keeps_one_kv_head_whole_and_splits_both_glu_halves(index):
    """At model = 2, rank `index` holds its query head's rows of `to_q` and
    columns of `to_out`, `to_k`/`to_v` whole (one KV head, fewer than the
    ranks; JAX splits `to_k` by columns), and its slice of the value half
    and of the gate half of the GLU projection (GSPMD splits the fused
    kernel); joining the ranks' blocks gives the whole tensors back."""
    from types import SimpleNamespace

    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.parallel.shard import shard_model

    cfg = tt.train_config(False)
    whole_model, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    model, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    mesh = SimpleNamespace(size=lambda axis: 2 if axis == "model" else 1, index=lambda axis: index)
    specs = shard_model(model, mesh)
    full = dict(whole_model.named_parameters())
    part = dict(model.named_parameters())
    attn = "perf_decoder.model.transformer.layers.0.1"
    ff = "perf_decoder.model.transformer.layers.1.1.ff.0.proj"
    d = 8  # dim_head
    assert torch.equal(part[f"{attn}.to_q.weight"], full[f"{attn}.to_q.weight"][index * d:(index + 1) * d])
    assert torch.equal(part[f"{attn}.to_out.weight"], full[f"{attn}.to_out.weight"][:, index * d:(index + 1) * d])
    for kv in ("to_k", "to_v"):
        assert f"{attn}.{kv}.weight" not in specs
        assert torch.equal(part[f"{attn}.{kv}.weight"], full[f"{attn}.{kv}.weight"])
    value, gate = full[f"{ff}.weight"].chunk(2)
    half = value.shape[0] // 2
    assert torch.equal(part[f"{ff}.weight"], torch.cat([value[index * half:(index + 1) * half],
                                                        gate[index * half:(index + 1) * half]]))
    for name, spec in specs.items():
        blocks = [spec.take(full[name].detach(), 2, i) for i in range(2)]
        assert torch.equal(blocks[index], part[name].detach()) and torch.equal(spec.join(blocks), full[name])

"""The port's trainer options against the JAX trainer's, on the CPU.

`remat` gives the loss and gradients of the plain step (1e-6) with dropout
on; `finetune_layers` freezes the parameters JAX's `freeze_mask` freezes for
the same regexes, and adamw's weight decay still moves them; `warm_start`
loads what JAX's `warm_start_params` loads, with `ignore_layers` and a
mis-shaped entry; `debug_nans` raises FloatingPointError in the forward and
the backward; `profile_dir` writes a trace of the configured steps; the
plateau schedule steps once an epoch and its state survives a resume;
`zero_sharding` and `sequence_parallel` train on one device, the multi-device
options raise; recipes/scoreperformer/scale_1024.yaml builds and trains a
step on tiny data at reduced depth.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from scoreperformer_tpu.training import checkpoint as jckpt

from scoreperformer_tpu_torch import train as ttrain
from scoreperformer_tpu_torch.configs import load_experiment_config
from scoreperformer_tpu_torch.convert import _flatten, jax_param_paths, load_state_dict, state_dict_from_jax
from scoreperformer_tpu_torch.models.factory import build_scoreperformer
from scoreperformer_tpu_torch.training import ExperimentComponents, Trainer, TrainerConfig, save_checkpoint
from scoreperformer_tpu_torch.training.optimizers import OptimizerConfig

from test_torch_classifiers import build_classifier_pair, classifier_batch, classifier_config
from test_torch_modules import tiny_config
from test_torch_train import port_batch
from test_torch_training_loop import data_root, write_recipe  # noqa: F401 (data_root is a fixture)

torch.set_num_threads(1)


def trainer_for(model, tmp_path, **config):
    config = {"output_dir": str(tmp_path / "out"), "tensorboard": False, "disable_progress": True, **config}
    trainer = Trainer(model, TrainerConfig.from_dict(config))
    trainer._prepare()
    return trainer


@pytest.fixture(scope="module")
def classifier_model():
    """The tiny model with direction classifiers (JAX model, JAX variables,
    port model) and its batch."""
    batch = classifier_batch()
    model, variables, port = build_classifier_pair(classifier_config(), batch)
    return model, variables, port, batch


# ---- remat: the same loss and gradients, dropout on ----


def test_remat_gives_the_gradients_of_the_plain_step(tmp_path):
    """Attention, feed-forward, embedding and latent dropout all on: the
    recompute under torch.utils.checkpoint draws the same masks and MMD
    samples from the step's generators, made inside the checkpointed
    function, so loss and gradients equal the plain step's (1e-6)."""
    cfg = tiny_config()
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        cfg[key]["transformer"]["attention"] = {**cfg[key]["transformer"]["attention"], "dropout": 0.2}
        cfg[key]["transformer"]["feed_forward"] = {**cfg[key]["transformer"]["feed_forward"], "dropout": 0.2}
        cfg[key]["emb_dropout"] = 0.2
    cfg["perf_encoder"]["latent_dropout"] = [0.0, 0.5, 0.5, 0.5]
    model, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    batch = port_batch(classifier_batch())
    batch.pop("directions")
    grads, losses = {}, {}
    for remat in (False, True):
        trainer = trainer_for(model, tmp_path / str(remat), remat=remat)
        model.train()
        model.zero_grad()
        loss, terms = trainer.loss_fn(batch, step=3)
        loss.backward()
        losses[remat] = (loss.item(), {k: v.item() for k, v in terms.items()})
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    assert losses[True] == losses[False]
    assert set(grads[True]) == set(grads[False]) and len(grads[True]) > 100
    for name, want in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), want.numpy(), atol=1e-6, rtol=1e-6, err_msg=name)
    model.zero_grad()  # another step draws other masks: the gradients differ
    trainer.loss_fn(batch, step=4)[0].backward()
    assert any(not torch.allclose(p.grad, grads[True][n]) for n, p in model.named_parameters() if n in grads[True])


# ---- finetune_layers: JAX's mask; frozen weights move by weight decay only ----


FINETUNE = [r"^perf_decoder/transformer/layer_[01]_", r"classifiers/head_dynamics", r"shared_emb_Velocity/"]


def test_finetune_layers_freeze_what_jax_freezes(classifier_model, tmp_path):
    """The port's frozen set is JAX's `freeze_mask` for the same regexes over
    the flax paths (`convert.jax_param_paths`, the reverse of the port's
    name mapping, every parameter once); one adamw step moves a frozen
    parameter by the weight decay alone, p (1 - lr wd), and leaves it out of
    the gradient norm."""
    model, variables, port, batch = classifier_model
    params = jax.device_get(variables["params"])
    mask = _flatten(jckpt.freeze_mask(params, FINETUNE))
    paths = jax_param_paths(port)
    assert {p for p, _ in paths.values()} == set(mask)
    lr, wd = 1e-2, 0.1
    trainer = trainer_for(port, tmp_path, finetune_layers=FINETUNE, optimization=OptimizerConfig(
        optimizer="adamw", lr=lr, optimizer_params={"weight_decay": wd}))
    frozen = {id(p) for p in trainer._frozen}
    named = dict(port.named_parameters())
    assert {n for n in named if id(named[n]) in frozen} == {n for n, (p, _) in paths.items() if not mask[p]}
    assert 0 < len(frozen) < len(named) and any(mask.values())
    before = {n: p.detach().clone() for n, p in named.items()}
    port.train()
    port.zero_grad()
    trainer.loss_fn(port_batch(batch), 0)[0].backward()
    norm = torch.sqrt(sum((p.grad ** 2).sum() for p in named.values() if id(p) not in frozen and p.grad is not None))
    metrics = trainer.train_step(port_batch(batch), 0)
    np.testing.assert_allclose(metrics["stats/grad_norm"].item(), norm.item(), rtol=1e-5)
    for name, p in named.items():
        if id(p) in frozen:
            np.testing.assert_allclose(p.detach().numpy(), (before[name] * (1 - lr * wd)).numpy(),
                                       atol=1e-7, rtol=1e-6, err_msg=name)
    moved = [n for n, p in named.items() if id(p) not in frozen and not torch.allclose(p, before[n] * (1 - lr * wd))]
    assert len(moved) > 10
    load_state_dict(port, before)
    port.eval()


# ---- warm_start: JAX's warm_start_params by flax path ----


def test_warm_start_loads_what_jax_loads(classifier_model, tmp_path, capsys):
    """A checkpoint of other weights with one entry of another shape: with
    `ignore_layers` and `ignore_mismatched_keys` the port loads exactly the
    entries JAX's `warm_start_params` takes from the same trees, keeps the
    rest, and names the skipped keys as JAX does; from the checkpoint
    directory and from its single-file `.pt` alike."""
    model, variables, port, batch = classifier_model
    own = {n: p.detach().clone() for n, p in port.named_parameters()}
    other, _ = build_scoreperformer(classifier_config(), device="cpu", seed=7)
    other_sd = {k: v.clone() for k, v in other.state_dict().items()}
    bad = "perf_encoder.vae_head.bar_mean.linear.weight"
    other_sd[bad] = torch.zeros(3, 5)
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), other)
    saved = torch.load(ckpt / "params.pt", weights_only=False)
    saved["model"]["state_dict"] = other_sd
    torch.save(saved, ckpt / "params.pt")
    ignore = [r"perf_decoder/transformer/layer_0_", r"classifiers/"]

    def jax_tree(sd):  # a port state dict as the JAX tree of the same paths
        return {"/".join(path): (sd[name].numpy().T if t else sd[name].numpy())
                for name, (path, t) in jax_param_paths(port).items()}

    want_tree = jckpt.warm_start_params(_unflatten(jax_tree(own)), _unflatten(jax_tree(other_sd)),
                                        ignore_layers=ignore, ignore_mismatched=True)
    want_out = capsys.readouterr().out
    trainer_for(port, tmp_path, warm_start=True, resume_from_checkpoint=str(ckpt), ignore_layers=ignore)
    got_out = capsys.readouterr().out
    assert got_out == want_out and "skipped" in got_out
    want = state_dict_from_jax(want_tree)
    named = dict(port.named_parameters(remove_duplicate=False))
    for name, value in want.items():
        np.testing.assert_array_equal(named[name.replace("proj|0", "proj")].detach().numpy(), value, err_msg=name)
    assert torch.equal(named[bad], own[bad])  # the mis-shaped entry is skipped
    assert not torch.equal(named["perf_decoder.model.transformer.layers.2.1.to_q.weight"],
                           own["perf_decoder.model.transformer.layers.2.1.to_q.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        trainer_for(port, tmp_path, warm_start=True, resume_from_checkpoint=str(ckpt), ignore_mismatched_keys=False)
    # a reference single-file .pt warm-starts the same way
    load_state_dict(port, own)
    trainer_for(port, tmp_path, warm_start=True, resume_from_checkpoint=str(ckpt / "params.pt"), ignore_layers=ignore)
    assert capsys.readouterr().out == want_out
    for name, value in want.items():
        np.testing.assert_array_equal(named[name.replace("proj|0", "proj")].detach().numpy(), value, err_msg=name)
    load_state_dict(port, own)


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


# ---- debug_nans ----


class _SqrtModel(torch.nn.Module):
    """A finite forward whose backward is NaN where x = 0 (0 * 1/(2 sqrt(0)))."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([0.0, 1.0]))
        self.inner = torch.nn.Linear(2, 2)

    def forward(self, x, generators=None):
        h = self.inner(x)
        loss = (torch.sqrt(self.w * self.w) * h.sum()).sum()
        return SimpleNamespace(loss=loss, losses={})


def test_debug_nans_raises_in_the_forward_and_the_backward(tmp_path):
    model = _SqrtModel()
    trainer = trainer_for(model, tmp_path, debug_nans=True)
    assert len(trainer._hooks) == 2
    with pytest.raises(FloatingPointError, match="nan values"):  # the backward's op
        trainer.train_step({"x": torch.ones(3, 2)}, 0)
    with pytest.raises(FloatingPointError, match="output of inner"):  # the module that made it
        trainer.train_step({"x": torch.tensor([[1.0, float("nan")]])}, 0)
    off = trainer_for(_SqrtModel(), tmp_path / "off")
    assert off._hooks == []
    off.train_step({"x": torch.ones(3, 2)}, 0)  # NaN gradients pass silently when off


# ---- the trainer end to end: profile, plateau, ZeRO, options that raise ----


def test_profile_dir_writes_a_trace_of_the_configured_steps(data_root, tmp_path):  # noqa: F811
    write_recipe(tmp_path / "tiny.yaml", data_root, tmp_path / "run", max_steps=4,
                 profile_dir=str(tmp_path / "prof"), profile_start_step=1, profile_num_steps=2)
    ttrain.main(["-r", str(tmp_path), "-n", "tiny.yaml", "--device", "cpu"])
    traces = sorted((tmp_path / "prof").glob("*.json"))
    assert [p.name for p in traces] == ["trace_1-2.json"]
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"train/1", "train/2"} <= names and not {"train/0", "train/3"} & names
    # training that ends inside the window stops the trace there
    write_recipe(tmp_path / "short.yaml", data_root, tmp_path / "run2", max_steps=2,
                 profile_dir=str(tmp_path / "prof2"), profile_start_step=1, profile_num_steps=5)
    ttrain.main(["-r", str(tmp_path), "-n", "short.yaml", "--device", "cpu"])
    assert [p.name for p in (tmp_path / "prof2").glob("*.json")] == ["trace_1-1.json"]


def test_plateau_schedule_steps_each_epoch_and_resumes(data_root, tmp_path):  # noqa: F811
    """lr_scheduler: plateau with patience 0 and threshold 0.99: every epoch
    after the first is a bad one, so the scale halves each epoch; the logged
    lr carries it, the checkpoint's trainer state holds the controller, and
    a resumed run carries on from it."""
    opt = {"lr": 1e-3, "optimizer": "adamw", "lr_scheduler": "plateau",
           "lr_scheduler_params": {"factor": 0.5, "patience": 0, "threshold": 0.99}}
    write_recipe(tmp_path / "tiny.yaml", data_root, tmp_path / "run", epochs=3, optimization=json.dumps(opt),
                 log_strategy="epoch",
                 save_optimizer=True)
    config = load_experiment_config(tmp_path, "tiny.yaml")
    comp = ExperimentComponents(config, device="cpu").init_components()
    comp.trainer.train()
    epochs = [log for log in comp.trainer.state.log_history if "train/lr" in log]
    assert [log["train/lr"] for log in epochs] == [1e-3, 5e-4, 2.5e-4]
    assert comp.trainer.optimizer.plateau_scale == 0.25
    state = json.loads((tmp_path / "run" / "checkpoint_last" / "meta.json").read_text())["trainer_state"]
    assert state["plateau"]["scale"] == 0.25 and state["plateau"]["num_bad_epochs"] == 0
    resumed = ExperimentComponents({**config, "trainer": {**config["trainer"], "epochs": 4, "resume_from_checkpoint":
                                                          str(tmp_path / "run" / "checkpoint_last")}},
                                   device="cpu").init_components()
    resumed.trainer._prepare()
    assert resumed.trainer._plateau.state_dict() == state["plateau"]
    assert resumed.trainer.optimizer.plateau_scale == 0.25


def test_one_device_options_train_and_multi_device_ones_raise(data_root, tmp_path):  # noqa: F811
    write_recipe(tmp_path / "zero.yaml", data_root, tmp_path / "run", max_steps=2, zero_sharding=True,
                 sequence_parallel=True, mesh_data=1, bf16_compute=True, remat=True)
    ttrain.main(["-r", str(tmp_path), "-n", "zero.yaml", "--device", "cpu"])
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [np.isfinite(log["train_step/loss"]) for log in logs if "train_step/loss" in log] == [True, True]
    model = torch.nn.Linear(1, 1)
    # a mesh axis of 2 needs a second process (tests/test_torch_parallel.py
    # trains on several), sequence parallelism on a model axis too
    # (tests/test_torch_sequence_parallel.py)
    for option in ("mesh_data", "mesh_model", "mesh_expert"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            Trainer(model, TrainerConfig(output_dir=str(tmp_path / "x"), **{option: 2}))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        Trainer(model, TrainerConfig(output_dir=str(tmp_path / "x"), mesh_model=2, sequence_parallel=True))


def test_scale_1024_recipe_trains_a_step_on_the_cpu(data_root, tmp_path):  # noqa: F811
    """recipes/scoreperformer/scale_1024.yaml (dim 1024, decoder head dim
    128, zero_sharding, softmax_bf16, base.yaml's classifiers) at depth 1 on
    tiny data: `python -m scoreperformer_tpu_torch.train` takes one step."""
    from test_torch_training_loop import REPO

    lines = [f"base: {REPO / 'recipes/scoreperformer/scale_1024.yaml'}", "data:", "  dataset:",
             f"    root: {data_root}", "    max_seq_len: 30", "    bar_sliding_window: 4",
             f"    performance_directions: {data_root / 'direction_classes.json'}",
             f"    score_directions_dict: {data_root / 'score_directions.json'}", "model:"]
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        lines += [f"  {key}:", "    transformer:", "      depth: 1"]
    trainer = {"output_dir": str(tmp_path / "run"), "max_steps": 1, "batch_size": 2, "num_workers": 1,
               "log_steps": 1, "save_strategy": "no", "eval_strategy": "no", "disable_progress": True,
               "tensorboard": False}
    lines += ["trainer:"] + [f"  {k}: {v}" for k, v in trainer.items()]
    (tmp_path / "scale.yaml").write_text("\n".join(lines) + "\n")
    config = load_experiment_config(tmp_path, "scale.yaml")
    assert config["trainer"]["zero_sharding"] is True and config["model"]["dim"] == 1024
    ttrain.main(["-r", str(tmp_path), "-n", "scale.yaml", "--device", "cpu"])
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [log for log in logs if "train_step/loss" in log]
    assert len(steps) == 1 and np.isfinite(steps[0]["train_step/loss"]) and np.isfinite(steps[0]["train_step/clf"])

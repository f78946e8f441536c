"""The port's optimizer, data path and trainer, on the CPU.

The optimizer is held to optax's chain (`scoreperformer_tpu.training.
build_optimizer`) to 1e-6 on identical gradients; the port's batches must
equal the JAX trainer's exactly; the trainer runs a tiny recipe end to end
through `python -m scoreperformer_tpu_torch.train`'s `main`, resumes from a
checkpoint to the same next step, and applies dropout only in train mode.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scoreperformer_tpu.data import COLLATORS as JCOLLATORS
from scoreperformer_tpu.data import DATASETS as JDATASETS
from scoreperformer_tpu.training import optimizers as joptim
from scoreperformer_tpu.training.trainer import Trainer as JTrainer
from scoreperformer_tpu.training.trainer import TrainerConfig as JTrainerConfig

from scoreperformer_tpu_torch import train as ttrain
from scoreperformer_tpu_torch.convert import optimizer_state_from_jax, state_dict_from_jax
from scoreperformer_tpu_torch.data import COLLATORS, DATASETS, build_synthetic_dataset
from scoreperformer_tpu_torch.models import attention as tattention
from scoreperformer_tpu_torch.training import ExperimentComponents, Trainer, TrainerConfig, load_checkpoint
from scoreperformer_tpu_torch.training import optimizers as toptim

from test_torch_modules import build_pair, make_inputs, tiny_config

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# ---- the optimizer against optax: 1e-6 ----

SHAPES = {"w": (3, 4), "b": (4,), "emb": (5, 2)}
OPT_CASES = {
    "adamw_clip_exponential": dict(optimizer="adamw", lr=0.1, optimizer_params={"weight_decay": 1e-2},
                                   lr_scheduler="exponential", lr_scheduler_params={"gamma": 0.5}, grad_clip=2.0),
    "adamw_defaults_nan_skipped": dict(optimizer="adamw", lr=0.05, lr_scheduler="exponential",
                                       lr_scheduler_params={"gamma": 0.5}, grad_clip=1.0),
    "adam_accumulate_2": dict(optimizer="adam", lr=0.1, optimizer_params={"betas": [0.8, 0.99]},
                              grad_clip=1.5, grad_accum_steps=2, lr_scheduler="cosine",
                              lr_scheduler_params={"decay_steps": 3}),
    "sgd_momentum": dict(optimizer="sgd", lr=0.1, optimizer_params={"momentum": 0.9}),
    "sgd_nesterov": dict(optimizer="sgd", lr=0.1, optimizer_params={"momentum": 0.9, "nesterov": True}),
    # one finite entry of 2e19 whose square overflows fp32 (the global norm
    # is inf): optax applies the step, clipped to 0 by 2/inf, or raw
    "adamw_clip_overflowing_square": dict(optimizer="adamw", lr=0.1, optimizer_params={"weight_decay": 1e-2},
                                          grad_clip=2.0),
    "adamw_overflowing_square": dict(optimizer="adamw", lr=0.1, optimizer_params={"weight_decay": 1e-2}),
}


def grads_for(step, case):
    g = {k: np.random.RandomState(10 + step).randn(*s).astype(np.float32) * 3 for k, s in SHAPES.items()}
    if case == "adamw_defaults_nan_skipped" and step == 1:
        g["b"][2] = np.nan
    if case.endswith("overflowing_square") and step == 1:
        g["w"][1, 2] = 2e19
    return g


def adam_count(state):
    """The count of the ScaleByAdamState inside an optax state."""
    if hasattr(state, "mu") and hasattr(state, "count"):
        return int(state.count)
    children = state if isinstance(state, (tuple, list)) else [getattr(state, f) for f in getattr(state, "_fields", ())]
    counts = [c for c in (adam_count(x) for x in children) if c is not None]
    return counts[0] if counts else None


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    cfg = OPT_CASES[case]
    init = {k: np.random.RandomState(i).randn(*s).astype(np.float32) for i, (k, s) in enumerate(SHAPES.items())}
    steps_per_epoch = 2
    tx = joptim.build_optimizer(joptim.OptimizerConfig.from_dict(cfg), steps_per_epoch)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = toptim.Optimizer(tparams.items(), toptim.OptimizerConfig.from_dict(cfg), steps_per_epoch)
    n_steps = 6 if cfg.get("grad_accum_steps") else 4
    for step in range(n_steps):
        g = grads_for(step, case)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in SHAPES:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]), atol=1e-6, rtol=1e-6,
                                       err_msg=f"{k} after step {step}")
    if case == "adamw_defaults_nan_skipped":
        assert opt.skipped == 1 and opt.count == n_steps - 1
    if case.endswith("overflowing_square"):
        assert opt.skipped == 0 and opt.count == adam_count(state) == n_steps


def test_optimizer_refuses_what_is_not_ported():
    """Every optax optimizer the JAX package names is ported, with its dtype
    and mask-tree options (held to optax in tests/test_torch_optimizers.py);
    what optax would refuse is refused: a dtype that is not a floating one,
    a mask tree that misses a parameter's key or goes deeper than the
    parameter, a mask tree over `flat_updates`' one vector, an unknown
    optimizer or parameter."""
    params = [("w", torch.nn.Parameter(torch.zeros(2)))]
    for name, option, value, error in (("adamw", "mu_dtype", "int8", ValueError),
                                       ("lion", "mu_dtype", "half precision", ValueError),
                                       ("sgd", "accumulator_dtype", "bool", ValueError),
                                       ("adafactor", "dtype_momentum", "int32", ValueError),
                                       ("lamb", "mask", {"v": True}, KeyError),
                                       ("adafactor", "weight_decay_mask", {"w": {"x": True}}, ValueError)):
        with pytest.raises(error):
            toptim.Optimizer(params, toptim.OptimizerConfig(optimizer=name, optimizer_params={option: value}))
    with pytest.raises(ValueError, match="flat_updates"):
        toptim.Optimizer(params, toptim.OptimizerConfig(optimizer="adamw", optimizer_params={"mask": {"w": True}},
                                                        flat_updates=True))
    with pytest.raises(ValueError):
        toptim.Optimizer(params, toptim.OptimizerConfig(optimizer="adagrad"))
    with pytest.raises(TypeError):
        toptim.Optimizer(params, toptim.OptimizerConfig(optimizer="lion", optimizer_params={"eps": 1e-8}))
    assert toptim.build_lr_schedule(toptim.OptimizerConfig(lr=0.3, lr_scheduler="plateau"))(7) == 0.3


def test_adam_state_from_optax_gives_optax_next_step():
    """An optax adamw state one step in, carried into the port's optimizer:
    the next update agrees with optax's to 1e-6 for every parameter."""
    model, variables, port = build_pair(tiny_config(), make_inputs())
    params = jax.device_get(variables["params"])
    cfg = dict(optimizer="adamw", lr=1e-2, grad_clip=1.0)
    tx = joptim.build_optimizer(joptim.OptimizerConfig.from_dict(cfg))
    state = tx.init(params)
    leaves, treedef = jax.tree.flatten(params)
    grads = [jax.tree.unflatten(treedef, [np.random.RandomState(100 * s + i).randn(*np.shape(x)).astype(np.float32)
                                          for i, x in enumerate(leaves)]) for s in range(2)]
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(*tx.update(g, s, p)))
    params, state = update(grads[0], state, params)
    from scoreperformer_tpu_torch.convert import load_state_dict

    load_state_dict(port, state_dict_from_jax(params))
    adam = state.inner_state[1][0]  # apply_if_finite -> chain(clip, adamw) -> scale_by_adam
    opt = toptim.Optimizer(port.named_parameters(), toptim.OptimizerConfig.from_dict(cfg))
    opt.load_state_dict(optimizer_state_from_jax(port, adam.mu, adam.nu, int(adam.count)))
    params, state = update(grads[1], state, params)
    own = dict(port.named_parameters(remove_duplicate=False))
    for name, g in state_dict_from_jax(grads[1]).items():
        own[name.replace("proj|0", "proj")].grad = torch.from_numpy(np.array(g))
    opt.step()
    for name, want in state_dict_from_jax(jax.device_get(params)).items():
        got = own[name.replace("proj|0", "proj")].detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=name)


# ---- data: the port's batches are the JAX trainer's ----


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "synthetic"
    build_synthetic_dataset(str(root), n_scores=3, n_perfs_per_score=2, n_bars=10, seed=3, splits=True)
    return root


DATASET_CFG = dict(
    use_alignments=False, auxiliary_data_keys=["bars", "initial_tempos"], max_seq_len=30, max_bar=256,
    bar_sliding_window=4, sample_bars=True, sample_note_shift=0.5, force_max_seq_len=0.5,
    fit_to_max_bar=False, fit_to_zero_bar=True, sample_bar_offset=False, add_sos_eos=True, sample=True,
    seed=23, augment_performance=True, pitch_shift_range=[-3, 3], velocity_shift_range=[-12, 12],
    tempo_shift_range=[0, 0], noisy_performance=False, deadpan_performance=0.25,
    zero_out_silent_durations=True, delete_silent_notes=True, preload=True, cache=True,
)
COLLATOR_CFG = dict(mask_ignore_token_ids=[0, 1, 2, 3], mask_ignore_token_dims=[0, 1, 2, 4, 6, 7, 8, 9],
                    fixed_seq_len=32)


def test_synthetic_dataset_copy_writes_the_same_files(data_root, tmp_path):
    from scoreperformer_tpu.data.synthetic import build_synthetic_dataset as jbuild

    jbuild(str(tmp_path), n_scores=3, n_perfs_per_score=2, n_bars=10, seed=3, splits=True)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(p.name for p in data_root.iterdir())
    for name in names:
        assert (tmp_path / name).read_bytes() == (data_root / name).read_bytes(), name


def test_iter_batches_match_the_jax_trainer(data_root, tmp_path):
    jds = JDATASETS.get("LocalScorePerformanceDataset")(root=str(data_root), split="train", **DATASET_CFG)
    tds = DATASETS.get("LocalScorePerformanceDataset")(root=str(data_root), split="train", **DATASET_CFG)
    jcoll = JCOLLATORS.get("MixedLMScorePerformanceCollator")(**COLLATOR_CFG)
    tcoll = COLLATORS.get("MixedLMScorePerformanceCollator")(**COLLATOR_CFG)
    common = dict(batch_size=4, num_workers=2, seed=5)
    jtr = JTrainer(None, JTrainerConfig(output_dir=str(tmp_path / "j"), tensorboard=False, **common),
                   train_dataset=jds, collator=jcoll)
    ttr = Trainer(torch.nn.Linear(1, 1), TrainerConfig(output_dir=str(tmp_path / "t"), **common),
                  train_dataset=tds, collator=tcoll)
    for epoch in (0, 1):
        want = list(jtr._iter_batches(jds, 4, True, epoch))
        got = list(ttr._iter_batches(tds, 4, True, epoch))
        assert len(want) == len(got) > 0
        for w, g in zip(want, got):
            assert sorted(w) == sorted(g)
            for key in w:
                np.testing.assert_array_equal(g[key], np.asarray(w[key]), err_msg=key)


# ---- the trainer end to end ----


def write_recipe(path: Path, data_root: Path, out: Path, base="no_classifiers.yaml", **trainer):
    """A tiny recipe on `base` (a recipe of recipes/scoreperformer/); on
    base.yaml, with its direction classifiers, the labels are the dataset's
    `direction_classes.json` and `score_directions.json`."""
    trainer = {"output_dir": str(out), "epochs": 2, "batch_size": 4, "eval_batch_size": 4, "num_workers": 2,
               "log_steps": 1, "save_strategy": "no", "eval_strategy": "no", "disable_progress": True, **trainer}
    lines = [f"base: {REPO / 'recipes/scoreperformer' / base}",
             "data:", "  dataset:", f"    root: {data_root}", "    max_seq_len: 30", "    bar_sliding_window: 4"]
    if base == "base.yaml":
        lines += [f"    performance_directions: {data_root / 'direction_classes.json'}",
                  f"    score_directions_dict: {data_root / 'score_directions.json'}"]
    lines += ["model:", "  dim: 32"]
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        lines += [f"  {key}:", "    token_embeddings:", "      emb_dims: 16", "    max_seq_len: 32",
                  "    transformer:", "      depth: 1", "      heads: 2"]
        if key == "perf_encoder":
            lines += ["    max_segments: 40", "    latent_dim: [8, 6, 4, 2]"]
        if key == "perf_decoder":  # flash attention (no attention dropout), feed-forward dropout 0.1
            lines += ["      attention:", "        dim_head: 8", "        dropout: 0.0", "        use_flash: true"]
    lines += ["trainer:"] + [f"  {k}: {v}" for k, v in trainer.items()]
    path.write_text("\n".join(lines) + "\n")
    return path


def test_train_entry_point_on_the_cpu(data_root, tmp_path):
    import json

    write_recipe(tmp_path / "tiny.yaml", data_root, tmp_path / "run", max_steps=3)
    ttrain.main(["-r", str(tmp_path), "-n", "tiny.yaml", "--device", "cpu"])
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [log["train_step/loss"] for log in logs if "train_step/loss" in log]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(np.isfinite(log["train_step/stats/grad_norm"]) for log in logs if "train_step/loss" in log)
    ckpt = load_checkpoint(str(tmp_path / "run" / "checkpoint_last"))
    assert ckpt["trainer_state"]["global_step"] == 3


@pytest.fixture(scope="module")
def components(data_root, tmp_path_factory):
    from scoreperformer_tpu_torch.configs import load_experiment_config

    tmp = tmp_path_factory.mktemp("recipe")
    write_recipe(tmp / "tiny.yaml", data_root, tmp / "run")
    return load_experiment_config(tmp, "tiny.yaml"), tmp


def build(config, **trainer):
    config = {**config, "trainer": {**config["trainer"], **trainer}}
    return ExperimentComponents(config, device="cpu").init_components()


def test_loss_falls_on_a_repeated_batch(components):
    config, _ = components
    comp = build(config)
    trainer = comp.trainer
    trainer._prepare()
    batch = trainer._put_batch(next(trainer._iter_batches(comp.train_dataset, 4, True, 0)))
    losses = [trainer.train_step(batch, step)["loss"].item() for step in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.9 * losses[0], losses


def test_resume_from_checkpoint_gives_the_same_next_step(components):
    config, tmp = components
    first = build(config, output_dir=str(tmp / "a"), max_steps=3, save_optimizer=True)
    first.trainer.train()
    resumed = build(config, output_dir=str(tmp / "b"), max_steps=4,
                    resume_from_checkpoint=str(tmp / "a" / "checkpoint_last"))
    resumed.trainer.train()
    straight = build(config, output_dir=str(tmp / "c"), max_steps=4)
    straight.trainer.train()
    assert resumed.trainer.state.global_step == straight.trainer.state.global_step == 4
    got = dict(resumed.model.named_parameters())
    for name, want in straight.model.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), want.detach().numpy(), atol=1e-7, rtol=0, err_msg=name)


def test_dropout_in_train_mode_only(monkeypatch):
    """Attention, feed-forward and embedding dropout draw from the step's
    generator in train(); eval() is deterministic and takes the flash path."""
    from scoreperformer_tpu_torch.models.factory import build_scoreperformer
    from scoreperformer_tpu_torch.training import step_generators

    cfg = tiny_config(use_flash=True)
    cfg["perf_decoder"]["transformer"]["attention"] = {**cfg["perf_decoder"]["transformer"]["attention"],
                                                      "dropout": 0.3}
    cfg["perf_decoder"]["transformer"]["feed_forward"] = {**cfg["perf_decoder"]["transformer"]["feed_forward"],
                                                         "dropout": 0.3}
    cfg["perf_decoder"]["emb_dropout"] = 0.3
    model, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    x = make_inputs()
    batch = {"perf": torch.from_numpy(x["perf"]).long(), "perf_mask": torch.from_numpy(x["mask"]),
             "score": torch.from_numpy(x["score"]).long(), "score_mask": torch.from_numpy(x["mask"]),
             "masked_perf": torch.from_numpy(x["masked"]).long(), "bars": torch.from_numpy(x["bars"]).long(),
             "beats": torch.from_numpy(x["beats"]).long(), "onsets": torch.from_numpy(x["onsets"]).long()}
    flash_calls = []
    real = tattention.flash_attention_alibi
    monkeypatch.setattr(tattention, "flash_attention_alibi", lambda *a, **k: flash_calls.append(1) or real(*a, **k))

    def logits(step):
        out = model(**batch, compute_loss=False, generators=step_generators(1, step, "cpu"))
        return out.logits["Velocity"].detach()

    model.train()
    a, a2, b = logits(0), logits(0), logits(1)
    assert torch.equal(a, a2) and not torch.allclose(a, b)
    n_train_flash = len(flash_calls)
    model.eval()
    c, d = logits(0), logits(1)
    assert torch.equal(c, d) and not torch.allclose(a, c)
    # per forward: 3 encoder layers take flash always, the 2 decoder layers
    # (attention dropout 0.3) only in eval()
    assert n_train_flash == 3 * 3 and len(flash_calls) - n_train_flash == 2 * 5


# ---- the paper's recipe: direction classifiers from the dataset's labels ----


def paper_recipe(data_root, tmp_path, **trainer):
    from scoreperformer_tpu_torch.configs import load_experiment_config

    write_recipe(tmp_path / "paper.yaml", data_root, tmp_path / "run", base="base.yaml", **trainer)
    return load_experiment_config(tmp_path, "paper.yaml")


def test_components_inject_the_jax_direction_classes(data_root, tmp_path):
    """base.yaml's classifiers on a dataset with direction labels: the port
    injects JAX's `num_classes` and `class_samples`, in the same order, builds
    a head per group, and its eval loop reports the classifier losses."""
    from scoreperformer_tpu.training.components import inject_data_config as jinject

    config = paper_recipe(data_root, tmp_path, eval_batches=1)
    comp = ExperimentComponents(config, device="cpu").init_components()
    ds_cfg = {k: v for k, v in config["data"]["dataset"].items() if k not in ("_name_", "_splits_")}
    jds = JDATASETS.get("LocalScorePerformanceDataset")(**{**ds_cfg, "split": "train"})
    want = jinject({k: v for k, v in config["model"].items() if not k.startswith("_")}, jds)["classifiers"]
    got = comp.model_config["classifiers"]
    assert list(got["num_classes"].items()) == list(want["num_classes"].items())
    assert list(got["class_samples"]) == list(want["class_samples"]) == list(want["num_classes"])
    for group, samples in want["class_samples"].items():
        np.testing.assert_array_equal(got["class_samples"][group], samples, err_msg=group)
    assert list(comp.model.classifiers.heads) == list(want["num_classes"])
    metrics = comp.trainer.evaluate()
    for key in ["eval/clf"] + [f"eval/clf/{group}" for group in want["num_classes"]]:
        assert np.isfinite(metrics[key]), key


def test_train_entry_point_trains_the_paper_recipe_on_the_cpu(data_root, tmp_path):
    """`python -m scoreperformer_tpu_torch.train` on a base.yaml-derived
    recipe: two steps that log the classifier losses, and a TensorBoard
    event file by default, as the JAX trainer writes one."""
    import json

    from scoreperformer_tpu_torch.training.tensorboard import read_events

    paper_recipe(data_root, tmp_path, max_steps=2)
    ttrain.main(["-r", str(tmp_path), "-n", "paper.yaml", "--device", "cpu"])
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [log for log in logs if "train_step/loss" in log]
    groups = json.loads((data_root / "direction_classes.json").read_text())
    assert len(steps) == 2
    for log in steps:
        for key in ["train_step/clf"] + [f"train_step/clf/{group}" for group in groups]:
            assert np.isfinite(log[key]), key
    events = sorted((tmp_path / "run" / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1
    tags = {v["tag"] for e in read_events(str(events[0])) for v in e.get("summary", [])}
    assert {"config/trainer", "train_step/loss", "train_step/clf"} <= tags


# ---- TensorBoard: the JAX default and the JAX writer's bytes ----


def test_tensorboard_is_on_by_default_in_both_trainers():
    assert TrainerConfig().tensorboard is True
    assert TrainerConfig().tensorboard == JTrainerConfig().tensorboard


def test_tensorboard_writer_writes_the_jax_bytes(tmp_path, monkeypatch):
    import scoreperformer_tpu.training.tensorboard as jtb
    import scoreperformer_tpu_torch.training.tensorboard as ttb

    paths = []
    for module, out in ((jtb, tmp_path / "j"), (ttb, tmp_path / "t")):
        clock = iter(1_700_000_000.0 + 0.25 * i for i in range(100))
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
        monkeypatch.setattr(module.socket, "gethostname", lambda: "host")
        writer = module.TensorBoardWriter(str(out))
        writer.add_text("config/trainer", '{"epochs": 3, "name": "été"}', step=0)
        for step, value in enumerate((2.5, 1.25, float("nan"), -3e-7, 7e30)):
            writer.add_scalar("train_step/loss", value, step)
            writer.add_scalar("train_step/clf/dynamics", value / 3, step)
        writer.add_scalar("big/step", 1.0, 2**40)
        writer.close()
        paths.append(Path(writer.path))
    assert paths[0].name == paths[1].name == "events.out.tfevents.1700000000.host"
    assert paths[0].read_bytes() == paths[1].read_bytes()
    events = ttb.read_events(str(paths[1]))
    assert events[0]["file_version"] == "brain.Event:2" and len(events) == 13

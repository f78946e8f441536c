"""Checkpoints of the port's multi-device training and its process starts,
on the CPU over gloo (`scoreperformer_tpu_torch.training.checkpoint`,
`parallel.launch`).

A tiny model (tests/test_torch_modules.py's sizes) trains 2 steps with ZeRO
at data = 2 x model = 2 and saves three checkpoints: sharded (every rank its
blocks), asynchronous, and gathered by rank 0 into the one-device layout.
Each restores to exactly what was saved, in one process and on another mesh
(model = 2); the gathered one loads with `load_model_from_checkpoint`. Two
processes started by torchrun's environment through the CLI, and two
started from `coordinator_address`, `num_processes` and `process_id`, train
on one data axis and report equal losses, as tests/test_multiprocess.py does
for JAX; their rendezvous store is held by the test, as torchrun's agent
holds it. One name saved twice, sharded and asynchronous, waits for every
rank's writes before its directory is removed, and `dump_json` replaces a
file whole. Tensors compare exactly.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from scoreperformer_tpu_torch.data import build_synthetic_dataset
from scoreperformer_tpu_torch.inference import load_model_from_checkpoint
from scoreperformer_tpu_torch.models.factory import build_scoreperformer
from scoreperformer_tpu_torch.parallel.launch import coordinator, launch
from scoreperformer_tpu_torch.parallel.workers import run_one_process, train_worker
from scoreperformer_tpu_torch.training import load_checkpoint, save_checkpoint
from scoreperformer_tpu_torch.training.checkpoint import wait_for_async_saves

import test_torch_train as tt
from test_torch_parallel_workers import cli_worker, log_checkpoint_writes, multihost_worker
from test_torch_training_loop import write_recipe

torch.set_num_threads(1)
SAVES = [{"name": "sharded", "sharded": True}, {"name": "async", "async": True}, {"name": "gathered"}]


def same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            same(got[k], want[k], f"{what}/{k}")
        elif isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), f"{what}/{k}"
        else:
            assert got[k] == want[k], f"{what}/{k}"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("saved")
    cfg = tt.train_config(False)
    model, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    batch = tt.train_batch(b=4)
    batch["deadpan_mask"] = np.array([True, False, False, True])
    body = {"model_name": "ScorePerformer", "model_config": cfg, "state_dict": model.state_dict(), "batch": batch,
            "device": "cpu",
            "trainer": {"optimization": {"optimizer": "adamw", "lr": 1e-3}, "zero_sharding": True, "seed": 5}}
    path = tmp / "payload.pt"
    torch.save({**body, "steps": 2, "output_dir": str(tmp / "run"), "checkpoints": SAVES,
                "trainer": {**body["trainer"], "mesh_data": 2, "mesh_model": 2}}, path)
    got = launch(train_worker, 4, (str(path),), device="cpu")[0]
    return tmp, body, got


@pytest.mark.parametrize("name", [s["name"] for s in SAVES])
def test_checkpoint_of_four_ranks_restores_what_was_saved(saved, name):
    tmp, _, got = saved
    path = got["checkpoints"][name]
    if name == "sharded":
        assert len(list(Path(path, "shards").glob("rank_*.pt"))) == 4 and not Path(path, "params.pt").exists()
    else:
        assert not Path(path, "shards").exists()
    loaded = load_checkpoint(path)
    same(loaded["params"], got["params"], "params")
    same(loaded["opt_state"], got["opt_state"], "opt_state")
    assert loaded["trainer_state"]["global_step"] == 2
    assert json.loads(Path(path, "trainer_state.json").read_text())["global_step"] == 2


def test_sharded_checkpoint_restores_on_another_mesh(saved):
    """Saved at data = 2 x model = 2 with ZeRO; restored at model = 2 (each
    rank its heads' blocks) and in one process, every tensor as saved."""
    tmp, body, got = saved
    path = tmp / "restore.pt"
    torch.save({**body, "steps": 0, "output_dir": str(tmp / "restored"), "restore": got["checkpoints"]["sharded"],
                "trainer": {**body["trainer"], "mesh_model": 2}}, path)
    on_model_axis = launch(train_worker, 2, (str(path),), device="cpu")[0]
    one = run_one_process(torch.load(path, weights_only=False), device="cpu")
    for restored in (on_model_axis, one):
        same(restored["params"], got["params"], "params")
        for key in ("mu", "nu"):
            same(restored["opt_state"][key], got["opt_state"][key], key)
        assert restored["opt_state"]["count"] == got["opt_state"]["count"] == 2


def test_checkpoint_gathered_from_four_ranks_loads_for_rendering(saved):
    _, _, got = saved
    model, cfg = load_model_from_checkpoint(str(Path(got["checkpoints"]["gathered"], "params.pt")), device="cpu")
    same({k: v for k, v in model.state_dict().items()}, got["params"], "params")


def test_async_save_is_complete_after_wait(tmp_path):
    model, _ = build_scoreperformer(tt.train_config(False), device="cpu", seed=1)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    path = save_checkpoint(str(tmp_path / "ckpt"), model, use_async=True, trainer_state={"global_step": 7})
    with torch.no_grad():  # the save holds its host copy: later updates do not reach it
        for p in model.parameters():
            p.add_(1.0)
    wait_for_async_saves()
    assert Path(path, "params.pt").exists()
    loaded = load_checkpoint(path)
    same(loaded["params"], want, "params")
    assert loaded["trainer_state"]["global_step"] == 7


def test_sharded_async_save_of_one_name_twice_waits_for_every_rank(saved, tmp_path):
    """One name saved twice, sharded and asynchronous, on 2 ranks whose rank
    1 writes half a second late: rank 0 removes the first save's directory
    only after every rank's write of it is on disk, and the second save
    restores to what was saved."""
    _, body, _ = saved
    events = tmp_path / "events"
    again = {"name": "again", "sharded": True, "async": True}
    path = tmp_path / "payload.pt"
    torch.save({**body, "steps": 1, "output_dir": str(tmp_path / "run"), "checkpoints": [again, again],
                "events": str(events), "trainer": {**body["trainer"], "mesh_data": 2}}, path)
    got = launch(train_worker, 2, (str(path), log_checkpoint_writes), device="cpu")[0]
    lines = [line.split() for line in events.read_text().splitlines()]
    removed = [float(t) for kind, rank, t in lines if kind == "rmtree"]
    late = sorted(float(t) for kind, rank, t in lines if kind == "write" and rank == "1")
    assert len(removed) == 1 and len(late) == 2
    assert late[0] < removed[0]
    loaded = load_checkpoint(got["checkpoints"]["again"])
    same(loaded["params"], got["params"], "params")
    same(loaded["opt_state"], got["opt_state"], "opt_state")


def test_dump_json_replaces_the_file_whole(tmp_path, monkeypatch):
    """While a JSON file is rewritten, a reader sees the old file whole:
    ranks that build one dataset side by side write its auxiliary files
    while the others read them."""
    from scoreperformer_tpu_torch.utils import io

    path = tmp_path / "bars.json"
    io.dump_json({"old": 1}, path)
    dump, seen = io.json.dump, []

    def dump_and_read(obj, f, **kwargs):
        dump(obj, f, **kwargs)
        f.flush()
        seen.append(io.load_json(path))

    monkeypatch.setattr(io.json, "dump", dump_and_read)
    io.dump_json({"new": 2}, path)
    assert seen == [{"old": 1}] and io.load_json(path) == {"new": 2}
    assert list(tmp_path.iterdir()) == [path]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "synthetic"
    build_synthetic_dataset(str(root), n_scores=3, n_perfs_per_score=2, n_bars=10, seed=3, splits=True)
    return root


def test_torchrun_environment_trains_on_two_processes(data_root, tmp_path):
    """`python -m scoreperformer_tpu_torch.train ... --device cpu` as
    torchrun starts it on 2 processes: the data axis takes both, the ranks
    log the same global train and eval metrics as one process does
    (feed-forward dropout on; the evaluator's accuracies over the gathered
    logits), and rank 0 alone writes the logs and the checkpoint."""
    from scoreperformer_tpu_torch import train as ttrain

    for run in ("run", "one"):
        write_recipe(tmp_path / f"{run}.yaml", data_root, tmp_path / run, max_steps=2, tensorboard=False,
                     eval_strategy="steps", eval_steps=2, eval_batches=1)
    with coordinator() as (_, env):  # the store torchrun's agent would hold
        logs = launch(cli_worker, 2, (["-r", str(tmp_path), "-n", "run.yaml", "--device", "cpu"],), device="cpu",
                      init=False, env=env)
    one = ttrain.main(["-r", str(tmp_path), "-n", "one.yaml", "--device", "cpu"]).trainer.state.log_history
    merged = [{k: v for h in history for log in h for k, v in log.items() if "time" not in k and "per_sec" not in k}
              for history in ([logs[0]], [logs[1]], [one])]
    assert merged[0] == merged[1]
    keys = [k for k in merged[2] if k.startswith(("train_step/loss", "eval/"))]
    assert any(k.startswith("eval/accuracy") for k in keys) and "train_step/loss" in keys
    for k in keys:
        np.testing.assert_allclose(merged[0][k], merged[2][k], atol=1e-5, rtol=1e-5, err_msg=k)
    losses = [log["train_step/loss"] for log in logs[0] if "train_step/loss" in log]
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(losses) == 2
    assert [json.loads(line)["train_step/loss"] for line in lines if "train_step/loss" in line] == losses
    assert load_checkpoint(str(tmp_path / "run" / "checkpoint_last"))["trainer_state"]["global_step"] == 2


def test_multihost_start_from_the_coordinator_fields(data_root, tmp_path):
    from scoreperformer_tpu_torch.configs import load_experiment_config

    with coordinator() as (port, env):
        write_recipe(tmp_path / "tiny.yaml", data_root, tmp_path / "run", max_steps=2, tensorboard=False,
                     coordinator_address=f"127.0.0.1:{port}")
        config = load_experiment_config(str(tmp_path), "tiny.yaml")
        logs = launch(multihost_worker, 2, (config,), device="cpu", init=False, env=env)
    losses = [[log["train_step/loss"] for log in h if "train_step/loss" in log] for h in logs]
    assert len(losses[0]) == 2 and losses[0] == losses[1] and np.isfinite(losses[0]).all()


def test_a_rank_past_the_mesh_sits_out_and_the_mesh_saves(data_root, tmp_path):
    """Three processes on a mesh of data = 2: rank 2 sits out; ranks 0 and 1
    train, and their sharded asynchronous checkpoint waits for the mesh's
    ranks alone."""
    from scoreperformer_tpu_torch.configs import load_experiment_config

    with coordinator() as (port, env):
        write_recipe(tmp_path / "tiny.yaml", data_root, tmp_path / "run", max_steps=2, tensorboard=False,
                     coordinator_address=f"127.0.0.1:{port}", mesh_data=2, sharded_checkpoint=True,
                     async_checkpoint=True)
        config = load_experiment_config(str(tmp_path), "tiny.yaml")
        logs = launch(multihost_worker, 3, (config,), device="cpu", init=False, env=env)
    losses = [[log["train_step/loss"] for log in h if "train_step/loss" in log] for h in logs]
    assert logs[2] == [] and len(losses[0]) == 2 and losses[0] == losses[1]
    path = tmp_path / "run" / "checkpoint_last"
    assert len(list((path / "shards").glob("rank_*.pt"))) == 2
    assert load_checkpoint(str(path))["trainer_state"]["global_step"] == 2

"""The port's serving layer on the CPU: RenderServer against the JAX package's,
and the port's serve/render entry points alone.

The JAX server and the port's load the same weights (a JAX `model.init`, as
a reference `.pt` for the JAX server and as a port checkpoint directory made
through `convert.state_dict_from_jax` for the port's); greedy requests must
give IDENTICAL tokens. Sampling cannot share JAX's random stream and is
checked by its own properties.
"""
import base64
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from scoreperformer_tpu.inference.server import RenderServer as JaxRenderServer
from scoreperformer_tpu.training.torch_convert import export_reference_state_dict

from scoreperformer_tpu_torch import render as render_cli
from scoreperformer_tpu_torch import serve as serve_cli
from scoreperformer_tpu_torch.data import synthetic_score
from scoreperformer_tpu_torch.inference import RenderServer, load_model_from_checkpoint
from scoreperformer_tpu_torch.inference.server import fold_seeds
from scoreperformer_tpu_torch.midi import read_midi, write_midi
from scoreperformer_tpu_torch.midi.containers import MidiScore, TempoMap
from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig
from scoreperformer_tpu_torch.training import save_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_port_modules", REPO / "tests" / "test_torch_modules.py")
tm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tm)

STYLE_DIM = 20  # the tiny model's latents: 8 + 6 + 4 + 2


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(port checkpoint directory, reference .pt for the JAX server, tokenizer
    path): the same tiny model's weights."""
    tmp = tmp_path_factory.mktemp("serve")
    tokenizer = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 32}))
    token_values = {k: v.tolist() for k, v in tokenizer.token_values(normalize=True).items()}
    cfg = tm.tiny_config(use_flash=True, num_tokens=tokenizer.performance_sizes,
                         score_tokens=tokenizer.score_sizes, token_values=token_values, max_segments=80)
    rng = np.random.RandomState(0)
    inputs = tm.make_inputs()
    inputs["perf"] = np.stack([rng.randint(4, v, (2, 12)) for v in tokenizer.performance_sizes.values()], -1)
    inputs["perf"] = inputs["perf"].astype(np.int32)
    inputs["masked"] = inputs["perf"].copy()
    inputs["score"] = inputs["perf"][..., : len(tokenizer.score_sizes)].copy()
    _, variables, port = tm.build_pair(cfg, inputs)
    model_config = {"_name_": "ScorePerformer", **cfg}

    port_dir = save_checkpoint(str(tmp / "checkpoint_last"), port, model_config=model_config)
    tokenizer.save(os.path.join(port_dir, "tokenizer.json"))
    reference = tmp / "reference.pt"
    sd = export_reference_state_dict(jax.device_get(variables["params"]))
    torch.save({"model": {"config": model_config,
                          "state_dict": {k: torch.tensor(np.array(v)) for k, v in sd.items()}}}, reference)
    return port_dir, str(reference), os.path.join(port_dir, "tokenizer.json")


@pytest.fixture(scope="module")
def server(checkpoints):
    return RenderServer(checkpoints[0], bucket=64, max_len=512, device="cpu")


def score(seed, n_bars=4):
    return synthetic_score(np.random.RandomState(seed), n_bars=n_bars)


def midi_file(tmp_path, seed, n_bars=4, name=None):
    path = str(tmp_path / (name or f"score{seed}.mid"))
    write_midi(score(seed, n_bars), path)
    return path


def test_greedy_batch_matches_the_jax_server(checkpoints):
    """Three coalesced greedy requests of different lengths through both
    servers, same weights: identical tokens for every request."""
    port_dir, reference, tok = checkpoints
    jserver = JaxRenderServer(reference, tokenizer_path=tok, bucket=64, max_len=512)
    jax_tokens = []
    detok = jserver.tokenizer.performance_tokens_to_midi

    def recording(seq, **kw):
        jax_tokens.append(np.asarray(seq.ids))
        return detok(seq, **kw)

    jserver.tokenizer.performance_tokens_to_midi = recording
    requests = [dict(score_midi=score(s, n), greedy=True) for s, n in ((3, 6), (4, 4), (5, 5))]
    jserver.render_batch(requests)
    got = RenderServer(port_dir, bucket=64, max_len=512, device="cpu").render_batch(requests)
    assert len({len(t) for t in jax_tokens}) == 3
    padded = 64 * -(-max(len(t) for t in jax_tokens) // 64)
    for want, result in zip(jax_tokens, got):
        np.testing.assert_array_equal(result["tokens"], want)
        assert result["batched"] == 4 and result["padded_to"] == padded


def test_buckets_ping_and_errors(server, tmp_path):
    assert [server._bucketed_len(t) for t in (1, 64, 65, 200)] == [64, 64, 128, 256]
    assert [server._bucketed_batch(b) for b in (1, 2, 3, 5, 128)] == [1, 2, 4, 8, 128]
    with pytest.raises(ValueError, match="max_len"):
        server._bucketed_len(513)
    before = server.stats["requests"]
    pong = server.handle_request({"id": 0, "cmd": "ping"})
    assert pong == {"id": 0, "ok": True, "pong": True, "requests": before}
    path = midi_file(tmp_path, 2)
    out = str(tmp_path / "perf.mid")
    resps = server.handle_batch([
        {"id": 1, "score": path, "greedy": True, "out": out},
        {"id": 2, "score": "/nonexistent.mid"},
        {"id": 3},
        {"id": 4, "score_b64": base64.b64encode(open(path, "rb").read()).decode(), "seed": 4},
        {"id": 5, "cmd": "ping"},
    ])
    assert [r["id"] for r in resps] == [1, 2, 3, 4, 5]
    assert resps[0]["ok"] and resps[0]["out"] == out and os.path.getsize(out) > 0
    assert resps[0]["padded_to"] % 64 == 0 and resps[0]["batched"] == 1
    assert resps[1]["ok"] is False and resps[2]["ok"] is False and "error" in resps[2]
    assert resps[3]["ok"] and len(base64.b64decode(resps[3]["midi_b64"])) > 0
    assert resps[4]["pong"]
    assert server.stats["requests"] == before + 2 and server.stats["errors"] >= 2


def test_render_batch_rejects_mixed_greedy(server):
    with pytest.raises(ValueError, match="greedy"):
        server.render_batch([dict(score_midi=score(1), greedy=True), dict(score_midi=score(1), greedy=False)])


def test_style_delta_validated_and_steers(server):
    sc = score(9)
    base = server.render(sc, greedy=True)
    zero = server.render(sc, greedy=True, style_delta=[0.0] * STYLE_DIM)
    big = server.render(sc, greedy=True, style_delta=[5.0] * STYLE_DIM)
    np.testing.assert_array_equal(base["tokens"], zero["tokens"])  # a zero delta is a no-op
    assert (base["tokens"] != big["tokens"]).any()  # steering changes the rendition
    with pytest.raises(ValueError, match="style_delta"):
        server.render(sc, style_delta=[1.0, 2.0])


def test_per_row_temperature_and_seeded_determinism(server):
    """A near-zero temperature row decodes greedily beside a hot sampled one;
    the same batch and seeds reproduce exactly; the seeds fold in order."""
    scores = [score(7), score(8)]
    greedy = server.render(scores[0], greedy=True)["tokens"]
    batch = [dict(score_midi=scores[0], temperature=1e-7, seed=1),
             dict(score_midi=scores[1], temperature=5.0, seed=2, style_delta=[0.5] * STYLE_DIM)]
    first, again = server.render_batch(batch), server.render_batch(batch)
    np.testing.assert_array_equal(first[0]["tokens"], greedy)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert fold_seeds([1, 2]) != fold_seeds([2, 1]) and fold_seeds([5]) == 5


def test_greedy_is_batch_invariant(server):
    scores = [score(s, n) for s, n in ((3, 6), (4, 4), (5, 5))]
    batched = server.render_batch([dict(score_midi=sc, greedy=True) for sc in scores])
    for sc, bat in zip(scores, batched):
        np.testing.assert_array_equal(server.render(sc, greedy=True)["tokens"], bat["tokens"])


@pytest.mark.parametrize("cache_dtype", ["auto", "bf16", "int8"])
def test_cache_dtypes(checkpoints, cache_dtype):
    """"auto" resolves to fp32 at the tiny model's dim; bf16 and int8 caches
    render whole performances."""
    srv = RenderServer(checkpoints[0], bucket=64, cache_dtype=cache_dtype, chunk_size=8, device="cpu")
    assert srv.cache_dtype == ("fp32" if cache_dtype == "auto" else cache_dtype)
    r = srv.render(score(11, 3), greedy=True)
    assert r["notes"] > 0 and r["perf"].num_notes == r["notes"]


def test_warmup_runs_each_bucket(checkpoints):
    srv = RenderServer(checkpoints[0], bucket=64, max_len=512, device="cpu")
    srv.warmup([60, 130], greedy_variants=(False, True), batch_sizes=(1, 3))
    assert srv.stats["buckets"] == {64, 192} and set(srv.stats["batches"]) == {1, 4}
    assert srv.stats["requests"] == 0


def test_tcp_coalescer_batches_concurrent_requests(server, tmp_path):
    path = midi_file(tmp_path, 6)
    srv, coalescer = serve_cli.make_tcp_server(server, "127.0.0.1", 0, max_batch=2, window_ms=5000)
    port = srv.server_address[1]
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    loop.start()
    before = server.stats["batches"].get(2, 0)
    results = [None, None]

    def client(i):
        with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
            sock.sendall((json.dumps({"id": i, "score": path, "greedy": True}) + "\n").encode())
            results[i] = json.loads(sock.makefile().readline())

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    srv.shutdown()
    srv.server_close()
    coalescer.stop()
    assert all(r is not None and r["ok"] and r["batched"] == 2 for r in results), results
    assert server.stats["batches"][2] == before + 1


def test_midi_writer_clamps_tempos_to_the_tempo_event():
    """A sampled rendition can reach tempos below the ~3.58 BPM that the
    24-bit tempo event holds; the wire layer's MIDI writer writes them at
    that limit instead of failing the response."""
    perf = MidiScore(ticks_per_beat=480)
    perf.tempos = TempoMap(np.array([0, 480]), np.array([1.0, 120.0]))
    np.testing.assert_allclose(read_midi(write_midi(perf)).tempos.tempo, [60e6 / 0xFFFFFF, 120.0], rtol=1e-6)


def test_serve_stdio_protocol(checkpoints, tmp_path):
    """`python -m scoreperformer_tpu_torch.serve --device cpu` through its
    stdin and stdout."""
    score_path = midi_file(tmp_path, 3)
    out_path = str(tmp_path / "perf.mid")
    requests = "\n".join(json.dumps(r) for r in (
        {"id": 1, "cmd": "ping"},
        {"id": 2, "score": score_path, "out": out_path, "greedy": True},
        {"id": 3, "cmd": "shutdown"},
    )) + "\n"
    proc = subprocess.run(
        [sys.executable, "-m", "scoreperformer_tpu_torch.serve", "--checkpoint", checkpoints[0],
         "--bucket", "64", "--device", "cpu"],
        input=requests, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert lines[0] == {"id": 1, "ok": True, "pong": True, "requests": 0}
    assert lines[1]["ok"] is True and lines[1]["out"] == out_path and os.path.exists(out_path)
    assert lines[2] == {"id": 3, "ok": True, "bye": True}


def test_render_cli_one_and_many_scores(checkpoints, tmp_path):
    scores = tmp_path / "scores"
    scores.mkdir()
    for i in range(2):
        midi_file(scores, 20 + i, name=f"s{i}.mid")
    outdir = tmp_path / "perfs"
    render_cli.main(["--checkpoint", checkpoints[0], "--score", str(scores), "--out", str(outdir),
                     "--greedy", "--bucket", "64", "--device", "cpu"])
    assert sorted(os.listdir(outdir)) == ["s0.perf.mid", "s1.perf.mid"]
    single = tmp_path / "one.mid"
    render_cli.main(["--checkpoint", checkpoints[0], "--score", str(scores / "s0.mid"), "--out", str(single),
                     "--greedy", "--device", "cpu"])
    assert single.read_bytes() == (outdir / "s0.perf.mid").read_bytes()


def test_load_model_from_port_checkpoint_directory(checkpoints):
    """The trainer's checkpoint directory (params.pt + meta.json) and the
    reference file give the same weights."""
    port_dir, reference, _ = checkpoints
    from_dir, cfg = load_model_from_checkpoint(port_dir, device="cpu")
    from_file, _ = load_model_from_checkpoint(reference, device="cpu")
    assert cfg.dim == 32
    want, got = from_file.state_dict(), from_dir.state_dict()
    assert list(want) == list(got)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)

"""The port's dataset preparation against the JAX package's, on the CPU.

The port's `prepare_dataset` (serial, and over a spawn pool of workers) on
tests/test_prepare.py's inputs, with a MusicXML score a piece, writes the
same bytes as the JAX package's in every file; the MusicXML reader and
direction parser, the pitch names, and the CLI's `discover_pairs` equal the
JAX package's and the root script's; `python -m
scoreperformer_tpu_torch.prepare_dataset` imports nothing of the JAX package
and writes a dataset whose windows carry direction labels.
"""
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from scoreperformer_tpu.data import music_constants as jmc
from scoreperformer_tpu.data import musicxml_directions as jmx
from scoreperformer_tpu.data.prepare import prepare_dataset as jprepare_dataset
from scoreperformer_tpu.data.synthetic import synthetic_performance, synthetic_score
from scoreperformer_tpu.midi import write_midi

from scoreperformer_tpu_torch.data import LocalScorePerformanceDataset
from scoreperformer_tpu_torch.data import music_constants as tmc
from scoreperformer_tpu_torch.data import musicxml_directions as tmx
from scoreperformer_tpu_torch.data.prepare import prepare_dataset

from test_musicxml import MUSICXML

ROOT = Path(__file__).resolve().parents[1]


def load_root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def chip_smoke():
    return load_root_module("chip_smoke")


@pytest.fixture(scope="module")
def raw_pairs(tmp_path_factory, chip_smoke):
    """tests/test_prepare.py::test_end_to_end's pieces (2 scores of 8 bars,
    2 performances each, notes dropped from one), each with chip_smoke.py's
    MusicXML score beside it."""
    raw = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(7)
    pairs, directions = [], {}
    for si in range(2):
        piece = raw / f"piece{si}"
        piece.mkdir(parents=True)
        score = synthetic_score(rng, n_bars=8, base_pitch=46 + 2 * si)
        write_midi(score, str(piece / "score.mid"))
        perfs = []
        for pi in range(2):
            perf = synthetic_performance(score, rng, tempo_base=100 + 10 * pi)
            if pi == 1:
                notes = perf.tracks[0].notes
                perf.tracks[0].notes = notes[np.arange(len(notes)) % 17 != 3]
            path = str(piece / f"perf{pi}.mid")
            write_midi(perf, path)
            perfs.append(path)
        (piece / "score.musicxml").write_text(chip_smoke.score_musicxml(8))
        pairs.append((f"piece{si}", str(piece / "score.mid"), perfs))
        directions[f"piece{si}"] = str(piece / "score.musicxml")
    return raw, pairs, directions


def same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


@pytest.mark.parametrize("workers,splits", [(0, None), (2, {"train": 0.5, "eval": 0.5})],
                         ids=["serial", "workers2_splits"])
def test_prepare_writes_the_jax_bytes(raw_pairs, tmp_path, workers, splits):
    _, pairs, directions = raw_pairs
    jprepare_dataset(pairs, str(tmp_path / "jax"), directions=directions, splits=splits)
    prepare_dataset(pairs, str(tmp_path / "port"), directions=directions, splits=splits, workers=workers)
    names = same_files(tmp_path / "jax", tmp_path / "port")
    assert "score_directions.json" in names and "piece1_perf_1.json" in names
    parsed = json.loads((tmp_path / "port" / "score_directions.json").read_text())
    types = {d["type"] for d in parsed["piece0"]}
    assert {"dynamic/p", "dynamic/crescendo", "tempo/allegro", "articulation/staccato"} <= types


@pytest.mark.parametrize("doc", ["test_musicxml", "chip_smoke_64_bars"])
def test_musicxml_reader_and_direction_parser_match_jax(doc, chip_smoke):
    text = MUSICXML if doc == "test_musicxml" else chip_smoke.score_musicxml(64)
    jparts, tparts = jmx.read_musicxml(text), tmx.read_musicxml(text)
    assert [dataclasses.asdict(p) for p in tparts] == [dataclasses.asdict(p) for p in jparts]
    for kwargs in ({}, {"delete_unmatched": True, "delete_duplicates": True, "ticks_scale": 0.5}):
        assert tmx.parse_directions(text, **kwargs) == jmx.parse_directions(text, **kwargs)
    for word in (" Allegro,\nMolto ", "poco a poco cresc", "decresc.", "dim.", None):
        assert tmx.word_regularization(word) == jmx.word_regularization(word)
        assert tmx.hairpin_word_regularization(word) == jmx.hairpin_word_regularization(word)


def test_pitch_names_match_jax():
    names = [tmc.pitch_to_sitch(p) for p in range(128)]
    assert names == [jmc.pitch_to_sitch(p) for p in range(128)]
    assert [tmc.sitch_to_pitch(n) for n in names + ["Db4", "Bb-1"]] == [
        jmc.sitch_to_pitch(n) for n in names + ["Db4", "Bb-1"]]


def test_discover_pairs_matches_the_root_script(tmp_path):
    from scoreperformer_tpu_torch import prepare_dataset as cli

    for piece, files in {"a": ["score.mid", "perf1.mid", "perf0.mid", "score.xml"],
                         "b": ["score.mid", "take.mid", "score.musicxml", "score.mxl", "notes.txt"],
                         "c": ["score.mid"], "d": ["perf0.mid"], "e": ["score.mid", "p.mid", "score.mxl"]}.items():
        (tmp_path / piece).mkdir()
        for name in files:
            (tmp_path / piece / name).write_bytes(b"")
    (tmp_path / "flat.mid").write_bytes(b"")
    want = load_root_module("prepare_dataset").discover_pairs(str(tmp_path))
    assert cli.discover_pairs(str(tmp_path)) == want
    assert [p[0] for p in want[0]] == ["a", "b", "e"] and sorted(want[1]) == ["a", "b", "e"]


def test_cli_prepares_a_labelled_dataset_without_the_jax_package(raw_pairs, tmp_path, chip_smoke):
    """The entry point in a fresh interpreter, with a spawn pool: no module of
    jax, flax or the JAX package is loaded, and the windows of the dataset
    it writes carry labels of every direction group."""
    raw, _, _ = raw_pairs
    out = tmp_path / "dataset"
    code = ("import runpy, sys\n"
            f"sys.argv = ['prepare_dataset', '--input', {str(raw)!r}, '--output', {str(out)!r}, '--workers', '2',"
            " '--splits', 'train=0.5,eval=0.5']\n"
            "runpy.run_module('scoreperformer_tpu_torch.prepare_dataset', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'scoreperformer_tpu'))\n"
            "assert not bad, bad\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "found 2 pieces, 4 performances" in done.stdout
    (out / "direction_classes.json").write_text(json.dumps(chip_smoke.PAPER_GROUPS))
    dataset = LocalScorePerformanceDataset(
        root=str(out), split="train", max_seq_len=64, bar_sliding_window=4, fit_to_zero_bar=True, add_sos_eos=True,
        auxiliary_data_keys=["bars", "initial_tempos"], performance_directions=str(out / "direction_classes.json"),
        score_directions_dict=str(out / "score_directions.json"), preload=True)
    assert dataset.performance_direction_sizes == {g: len(n) + 1 for g, n in chip_smoke.PAPER_GROUPS.items()}
    labelled = {g: 0 for g in chip_smoke.PAPER_GROUPS}
    for i in range(len(dataset)):
        for group, maps in dataset[i].directions.items():
            labelled[group] += int(sum(m.sum() for m in maps.values()))
    assert all(n > 0 for n in labelled.values()), labelled

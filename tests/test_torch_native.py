"""The port's native (C++) builds against the port's own Python paths, on
the CPU: the SMF parser (`midi/native.py`, `midi/_native/smf.cpp`) against
`midi/smf.py::read_midi_py`, and the SPMuple2 tempo scan
(`tokenizers/native.py`, `tokenizers/_native/spm2_scan.cpp`) against the
tokenizer's Python scan, as tests/test_native_smf.py, test_smf_fuzz.py and
test_native_scan.py hold the JAX package's copies. Each test skips only
where the host has no C++ compiler (g++), which both builds need; a build
that fails with one fails the test.
"""
import os
import shutil

import numpy as np
import pytest

from scoreperformer_tpu_torch.data import synthetic_score
from scoreperformer_tpu_torch.midi import native as smf_native
from scoreperformer_tpu_torch.midi.smf import read_midi_py, write_midi
from scoreperformer_tpu_torch.tokenizers import TokenizerConfig
from scoreperformer_tpu_torch.tokenizers import native as scan_native
from scoreperformer_tpu_torch.tokenizers.presets import SPMupleWindow, SPMupleWindowRecompute

from test_native_scan import synthetic_scan_inputs
from test_native_smf import assert_scores_equal
from test_smf_fuzz import _corpus


@pytest.fixture
def compiler():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++) on this host: the native builds cannot be made")


@pytest.fixture
def python_scan(monkeypatch):
    """Runs `fn` with the tokenizer's Python scan (SP_NATIVE_SCAN=0)."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setenv("SP_NATIVE_SCAN", "0")
            return fn()
    return run


def tokenizer(cls=SPMupleWindow, **extra):
    return cls(config=TokenizerConfig(additional_params={"max_bar_embedding": 256, **extra}))


@pytest.mark.parametrize("seed,n_bars", [(1, 6), (5, 40), (9, 120)])
def test_native_smf_parser_matches_the_python_parser(compiler, seed, n_bars):
    assert smf_native.native_available(), smf_native._LIB_ERR
    blob = write_midi(synthetic_score(np.random.RandomState(seed), n_bars=n_bars), None)
    assert_scores_equal(read_midi_py(blob), smf_native.read_midi_native(blob))


def test_native_smf_parser_matches_on_mutated_bytes(compiler):
    """test_smf_fuzz.py's corpus of mutated and random MIDI bytes: both
    parsers reject a blob with ValueError, or both give the same score."""
    assert smf_native.native_available(), smf_native._LIB_ERR
    outcomes = {True: 0, False: 0}
    for i, blob in enumerate(_corpus()):
        got = []
        for parse in (read_midi_py, smf_native.read_midi_native):
            try:
                got.append(parse(blob))
            except ValueError:
                got.append(None)
        assert (got[0] is None) == (got[1] is None), f"case {i}: python {got[0] is not None}, native {got[1] is not None}"
        if got[0] is not None:
            assert_scores_equal(*got)
        outcomes[got[0] is not None] += 1
    assert min(outcomes.values()) > 20, outcomes


@pytest.mark.parametrize("onset_tempos", [False, True])
@pytest.mark.parametrize("seed,K", [(0, 5), (1, 60), (2, 300), (3, 80)])
def test_native_tempo_scan_matches_the_python_scan(compiler, python_scan, seed, K, onset_tempos):
    assert scan_native.native_available(), scan_native._LIB_ERR
    tok = tokenizer(**({"onset_tempos": True} if onset_tempos else {}))
    pairs, grouped = synthetic_scan_inputs(np.random.RandomState(seed), K, clustered=seed % 2 == 0)
    pairs_py = pairs.copy()
    want = python_scan(lambda: tok._tempo_clamp_scan(pairs_py, grouped, 110.0, 60.0 / 384))
    got = tok._tempo_clamp_scan(pairs, grouped, 110.0, 60.0 / 384)
    for g, w in zip(got + (pairs,), want + (pairs_py,)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cls", [SPMupleWindow, SPMupleWindowRecompute])
def test_performance_encode_is_the_same_with_the_native_scan(compiler, python_scan, cls):
    """A performance's tokens with and without the native scan, the only
    part it replaces."""
    assert scan_native.native_available(), scan_native._LIB_ERR
    assert os.environ.get("SP_NATIVE_SCAN") != "0"
    midi = synthetic_score(np.random.RandomState(3), n_bars=24)
    tok_a, tok_b = tokenizer(cls), tokenizer(cls)
    score = tok_a.score_midi_to_tokens(midi.copy(), preprocess=True)
    want = python_scan(lambda: tok_a.performance_midi_to_tokens(midi.copy(), score))
    got = tok_b.performance_midi_to_tokens(midi.copy(), score)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.meta["initial_tempo"] == want.meta["initial_tempo"]

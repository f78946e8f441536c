"""The port's tokenizer operations against the JAX package's, on the CPU.

tests/test_tokenizer_ops.py's cases on the port: onset ticks against the host
tokenizer's `compute_ticks` (the port's copy), the SPMuple2 decode against the
port's messenger, the batched decode, the deadpan columns; and each against
JAX's `TokenizerOps` on the same tokens (ticks and times to 1e-5, masks and
deadpan tokens exactly), on a synthetic 8-bar performance and on one whose
time signature changes more often than the static cap.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scoreperformer_tpu.ops.tokenizer_ops import TokenizerOps as JaxTokenizerOps
from scoreperformer_tpu.tokenizers import SPMupleWindow as JaxTokenizer
from scoreperformer_tpu.tokenizers import TokenizerConfig as JaxTokenizerConfig

from scoreperformer_tpu_torch.data import synthetic_performance, synthetic_score
from scoreperformer_tpu_torch.inference import SPMuple2IntermediateData, SPMuple2Messenger
from scoreperformer_tpu_torch.ops.tokenizer_ops import TokenizerConstants, TokenizerOps
from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig

PARAMS = {"max_bar_embedding": 64}


@pytest.fixture(scope="module")
def tok_and_seq():
    rng = np.random.RandomState(11)
    tok = SPMupleWindow(TokenizerConfig(additional_params=PARAMS))
    score = synthetic_score(rng, n_bars=8)
    score_seq = tok.score_midi_to_tokens(score)
    perf = synthetic_performance(score, rng, tempo_base=100.0)
    return tok, tok.performance_midi_to_tokens(perf, score_seq)


@pytest.fixture(scope="module")
def jax_ops():
    return JaxTokenizerOps(JaxTokenizer(JaxTokenizerConfig(additional_params=PARAMS)))


def test_constants_are_the_tokenizers(tok_and_seq, jax_ops):
    tok, _ = tok_and_seq
    const = TokenizerConstants.from_tokenizer(tok)
    for field in ("zero_token", "max_beat_res", "types_idx"):
        assert getattr(const, field) == getattr(jax_ops.const, field)
    for field in ("duration_values", "tempos", "time_signatures", "rel_onset_deviations", "rel_performed_durations"):
        np.testing.assert_array_equal(getattr(const, field), getattr(jax_ops.const, field))


def test_note_on_ticks_match_the_host_and_jax(tok_and_seq, jax_ops):
    tok, perf_seq = tok_and_seq
    ops = TokenizerOps(tok)
    got = ops.note_on_ticks(torch.as_tensor(perf_seq.ids), 480).numpy()
    np.testing.assert_allclose(got, tok.compute_ticks(perf_seq.ids, 480)["note_on"], atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(jax_ops.note_on_ticks(jnp.asarray(perf_seq.ids), 480)))


def test_note_on_ticks_past_the_cap_of_time_signature_changes(tok_and_seq, jax_ops):
    """Time signatures changing every 5 notes: JAX keeps the first 8
    changes (its static cap) and so does the port."""
    tok, perf_seq = tok_and_seq
    ids = np.array(perf_seq.ids)
    col = tok.types_idx["TimeSig"]
    ids[:, col] = tok.zero_token + (np.arange(len(ids)) // 5) % min(len(tok.vocab.time_signatures), 3)
    got = TokenizerOps(tok).note_on_ticks(torch.as_tensor(ids), 480).numpy()
    assert (np.diff(ids[:, col]) != 0).sum() > 8
    np.testing.assert_array_equal(got, np.asarray(jax_ops.note_on_ticks(jnp.asarray(ids), 480)))


def test_spmuple2_decode_matches_the_messenger_and_jax(tok_and_seq, jax_ops):
    """The messenger works in beat-resolution ticks (messengers.py:231),
    seeded with the decode's initial tempo."""
    tok, perf_seq = tok_and_seq
    ops = TokenizerOps(tok)
    td = tok.max_beat_res
    times, offsets, performed = (t.numpy() for t in ops.spmuple2_decode_times(torch.as_tensor(perf_seq.ids), td))
    tempos = tok.decode_token_type(perf_seq.ids, "Tempo")
    ticks = tok.compute_ticks(perf_seq.ids, td)["note_on"]
    msgs = SPMuple2Messenger(tok).tokens_to_messages(
        perf_seq.ids, intermediates=SPMuple2IntermediateData(initial_tempo=tempos[ticks == ticks[0]].mean()),
        sort=False)
    n = len(perf_seq.ids)
    assert performed.any()
    np.testing.assert_allclose(times[performed], msgs[:n, 0][performed], atol=1e-4)
    np.testing.assert_allclose(offsets[performed], msgs[n:, 0][performed], atol=1e-4)
    want = [np.asarray(x) for x in jax_ops.spmuple2_decode_times(jnp.asarray(perf_seq.ids), td)]
    np.testing.assert_allclose(times, want[0], atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(offsets, want[1], atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(performed, want[2])


def test_spmuple2_decode_with_unperformed_notes_matches_jax(tok_and_seq, jax_ops):
    """Whole onsets left unperformed (velocity zero) drop out of the onset
    groups, and the groups after them are renumbered."""
    tok, perf_seq = tok_and_seq
    ids = np.array(perf_seq.ids)
    ticks = tok.compute_ticks(ids, 480)["note_on"]
    onsets = np.unique(ticks)
    silent = np.isin(ticks, onsets[3:9:2])
    ids[silent, tok.types_idx["Velocity"]] = tok.zero_token
    got = [t.numpy() for t in TokenizerOps(tok).spmuple2_decode_times(torch.as_tensor(ids), 480)]
    want = [np.asarray(x) for x in jax_ops.spmuple2_decode_times(jnp.asarray(ids), 480)]
    assert not got[2][silent].any() and got[2].any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-6)


def test_batched_decode(tok_and_seq, jax_ops):
    tok, perf_seq = tok_and_seq
    ops = TokenizerOps(tok)
    ids = np.array(perf_seq.ids)
    other = ids.copy()
    other[:, tok.types_idx["Tempo"]] = np.clip(other[:, tok.types_idx["Tempo"]] + 2, tok.zero_token,
                                                tok.zero_token + len(tok.vocab.tempos) - 1)
    batch = np.stack([ids, other, ids])
    t0, t1, m = ops.spmuple2_decode_times_batch(torch.as_tensor(batch), 480)
    assert t0.shape == (3, len(ids))
    np.testing.assert_array_equal(t0[0].numpy(), t0[2].numpy())
    single = ops.spmuple2_decode_times(torch.as_tensor(other), 480)
    for got, one in zip((t0, t1, m), single):
        np.testing.assert_array_equal(got[1].numpy(), one.numpy())
    want = jax_ops.spmuple2_decode_times_batch(jnp.asarray(batch), 480)
    for got, w in zip((t0, t1, m), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-6)


def test_deadpan_matches_the_host_and_jax(tok_and_seq, jax_ops):
    tok, perf_seq = tok_and_seq
    score_ids = perf_seq.ids[:, :-2]
    got = TokenizerOps(tok).score_tokens_as_performance(torch.as_tensor(score_ids)).numpy()
    np.testing.assert_array_equal(got, tok.score_tokens_as_performance(score_ids).ids)
    np.testing.assert_array_equal(got, np.asarray(jax_ops.score_tokens_as_performance(jnp.asarray(score_ids))))
    batched = TokenizerOps(tok).score_tokens_as_performance(torch.as_tensor(np.stack([score_ids] * 2)))
    np.testing.assert_array_equal(batched[1].numpy(), got)

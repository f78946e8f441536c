"""The port's streaming generator against the JAX package's, on the CPU.

One synthetic piece, one tiny model (tests/test_inference.py's config: dim
32, one layer a stack, heads of 8), the JAX weights carried into the port by
`convert.state_dict_from_jax`. Held against JAX: the messengers (exactly),
the MMD latent helpers (1e-5), the decoder's multi-row `decode_step` (caches
1e-5, logits 1e-4), the encoder pass (1e-4), and greedy windows token for
token, messages to 1e-6. Sampling cannot share JAX's threefry stream: the
port's own properties are checked (block and per-note decoding sample alike
from one seed, a temperature change, ids inside each stream's vocabulary).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.data import LocalScorePerformanceDataset as JaxDataset
from scoreperformer_tpu.data import MixedLMScorePerformanceCollator as JaxCollator
from scoreperformer_tpu.data import scoreperformer_model_inputs as jax_model_inputs
from scoreperformer_tpu.data.synthetic import build_synthetic_dataset as jax_build_synthetic_dataset
from scoreperformer_tpu.data.synthetic import synthetic_performance as jax_synthetic_performance
from scoreperformer_tpu.data.synthetic import synthetic_score as jax_synthetic_score
from scoreperformer_tpu.inference import ScorePerformerGenerator as JaxGenerator
from scoreperformer_tpu.inference import SPMuple2IntermediateData as JaxIntermediates2
from scoreperformer_tpu.inference import SPMuple2Messenger as JaxMessenger2
from scoreperformer_tpu.inference import SPMupleMessenger as JaxMessenger
from scoreperformer_tpu.inference.generator import StreamingDecoder as JaxDecoder
from scoreperformer_tpu.models import MODELS
from scoreperformer_tpu.tokenizers import SPMupleBar as JaxSPMupleBar
from scoreperformer_tpu.tokenizers import TokenizerConfig as JaxTokenizerConfig
from scoreperformer_tpu.training import inject_data_config

from scoreperformer_tpu_torch.convert import load_state_dict, state_dict_from_jax
from scoreperformer_tpu_torch.data import LocalScorePerformanceDataset, MixedLMScorePerformanceCollator
from scoreperformer_tpu_torch.inference import (
    IntermediateData,
    ScorePerformerGenerator,
    SPMuple2IntermediateData,
    SPMuple2Messenger,
    SPMupleMessenger,
    StreamingDecoder,
)
from scoreperformer_tpu_torch.inference.generator import gumbel_noise
from scoreperformer_tpu_torch.models.factory import build_scoreperformer
from scoreperformer_tpu_torch.tokenizers import SPMupleBar, TokenizerConfig

torch.set_num_threads(1)

MAX_SEQ = 48  # the dataset's windows (the encoder pass's chunks)
CTX = 40  # max_context_len: the decoder's cache
N_BARS = 8
WINDOW = 0.4
DATASET_KW = dict(max_seq_len=MAX_SEQ, bar_sliding_window=8, fit_to_zero_bar=True, add_sos_eos=True, preload=True,
                  auxiliary_data_keys=["bars"])
COLLATOR_KW = dict(mask_ignore_token_ids=[0, 1, 2, 3], mask_ignore_token_dims=[0, 1, 2, 4, 6, 7, 8, 9])


def tiny_cfg():
    """tests/test_inference.py's model."""
    emb = {"_target_": "simple", "emb_dims": 16, "mode": "cat", "emb_norm": True, "discrete": False,
           "continuous": True, "continuous_dense": True, "discrete_ids": [0, 1, 2, 3]}
    attn = {"dim_head": 8, "one_kv_head": True, "alibi_pos_bias": True, "alibi_learned": True}
    ff = {"mult": 2, "glu": True, "swish": True}
    enc_t = {"_target_": "encoder", "depth": 1, "heads": 2, "attention": attn, "feed_forward": ff}
    common = {"emb_norm": True, "use_abs_pos_emb": False, "max_seq_len": MAX_SEQ + 2}
    return {
        "dim": 32, "tie_token_emb": True, "mode": "mixlm",
        "score_encoder": {"token_embeddings": dict(emb), **common, "transformer": dict(enc_t)},
        "perf_encoder": {"token_embeddings": dict(emb), **common, "latent_dim": [8, 6, 4, 2],
                         "aggregate_mode": ["mean", "bar_mean", "beat_mean", "onset_mean"],
                         "max_segments": 64, "hierarchical": True, "transformer": dict(enc_t)},
        "perf_decoder": {"token_embeddings": {**emb, "_target_": "multi-seq", "multiseq_mode": "post-cat"},
                         **common, "context_emb_mode": "cat", "style_emb_mode": "adanorm",
                         "transformer": {"_target_": "decoder", "depth": 1, "heads": 2, "attention": attn,
                                         "feed_forward": ff},
                         "lm_head": {"_target_": "lm-tied"}},
    }


class Pair:
    """The JAX and port generators over one piece, with the same weights
    (`cfg`, `tiny_cfg()` by default, before the data config is injected)."""

    def __init__(self, root, cfg=None):
        jax_build_synthetic_dataset(root, n_scores=1, n_perfs_per_score=1, n_bars=N_BARS, seed=7,
                                    with_directions=False)
        jds = JaxDataset(root=root, **DATASET_KW)
        tds = LocalScorePerformanceDataset(root=root, **DATASET_KW)
        jcoll, tcoll = JaxCollator(**COLLATOR_KW), MixedLMScorePerformanceCollator(**COLLATOR_KW)
        self.cfg = inject_data_config(cfg or tiny_cfg(), jds)
        self.jmodel, _ = MODELS.get("ScorePerformer")(**self.cfg)
        inputs = {k: jnp.asarray(v) for k, v in jax_model_inputs(jcoll([jds[0]])).items()}
        rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                "latent_dropout": jax.random.PRNGKey(2), "mmd": jax.random.PRNGKey(3)}
        self.variables = jax.jit(lambda r, x: self.jmodel.init(r, **x, deterministic=True))(rngs, inputs)
        self.port, _ = build_scoreperformer(self.cfg, device="cpu", seed=0)
        load_state_dict(self.port, state_dict_from_jax(jax.device_get(self.variables["params"])))
        self.port.eval()
        self.jgen = JaxGenerator(self.jmodel, self.variables, jds, jcoll, JaxMessenger2(jds.tokenizer))
        self.tgen = ScorePerformerGenerator(self.port, tds, tcoll, SPMuple2Messenger(tds.tokenizer))
        self.greedy = {}  # runs of the JAX generator, kept: each is a few compiles

    def jax_greedy(self, name, **kw):
        if name not in self.greedy:
            self.greedy[name] = drive(self.jgen, **kw)
        return self.greedy[name]


def drive(gen, windows=12, window=WINDOW, overlay_bars=0.0, **kw):
    """Stream `windows` windows from the piece's start; returns each
    window's (tokens, messages, decoder window start, decoder stats)."""
    gen.reset()
    gen.prepare_performance_notes(0, overlay_bars=overlay_bars)
    out, clock = [], 0.0
    for _ in range(windows):
        tokens, messages = gen.generate_performance_notes(start_time=clock, time_window=window,
                                                          max_context_len=CTX, **kw)
        out.append((tokens, messages, gen._last_window_start, dict(gen._decoder.stats)))
        clock += window
        if gen.perf_data.reached_eos:
            break
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return Pair(str(tmp_path_factory.mktemp("streaming")))


def assert_same_windows(want, got):
    assert len(got) == len(want)
    for w, ((jt, jm, _, _), (tt, tm_, _, _)) in enumerate(zip(want, got)):
        if jt is None:
            assert tt is None, f"window {w}: JAX generated nothing, the port {len(tt)} notes"
            continue
        assert tt is not None, f"window {w}: the port generated nothing"
        np.testing.assert_array_equal(tt, jt, err_msg=f"window {w}")
        np.testing.assert_allclose(np.asarray(tm_), np.asarray(jm), atol=1e-6, rtol=0, err_msg=f"window {w}")


# ---- messengers ----


def v1_tokens():
    """A v1 (SPMupleBar) performance of a synthetic score, tokenized by both packages."""
    rng = np.random.RandomState(3)
    score = jax_synthetic_score(rng, n_bars=6)
    perf = jax_synthetic_performance(score, rng, tempo_base=104.0)
    jtok = JaxSPMupleBar(JaxTokenizerConfig())
    ids = jtok.performance_midi_to_tokens(perf, jtok.score_midi_to_tokens(score)).ids
    return jtok, SPMupleBar(TokenizerConfig()), np.asarray(ids)


def assert_same_messages(want, got):
    if isinstance(want, tuple):
        (wm, wi), (gm, gi) = want, got
        np.testing.assert_array_equal(gm, wm)
        assert type(gi).__name__ == type(wi).__name__
        for field in vars(wi):
            a, b = getattr(wi, field), getattr(gi, field)
            if a is None or np.isscalar(a):
                assert a == b, field
            else:
                np.testing.assert_array_equal(b, a, err_msg=field)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kw", [{}, {"note_attributes": False, "note_off_events": False, "sort": False},
                                {"to_times": False}], ids=["messages", "onset_times", "ticks"])
def test_messengers_equal_jax_on_a_whole_performance(pair, version, kw):
    if version == "v1":
        jtok, ttok, ids = v1_tokens()
        jm, tm_ = JaxMessenger(jtok), SPMupleMessenger(ttok)
    else:
        jtok, ttok = pair.jgen.tokenizer, pair.tgen.tokenizer
        ids = np.asarray(pair.jgen.dataset.performances[0])
        jm, tm_ = JaxMessenger2(jtok), SPMuple2Messenger(ttok)
        if kw.get("to_times") is False:  # v2 messages are in seconds only, in both packages
            for messenger in (jm, tm_):
                with pytest.raises(AssertionError, match="tick messages"):
                    messenger.tokens_to_messages(ids.copy(), **kw)
            return
    assert_same_messages(jm.tokens_to_messages(ids.copy(), **kw), tm_.tokens_to_messages(ids.copy(), **kw))


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("chunk", [1, 5, 7])
def test_messengers_equal_jax_in_chunks_with_carried_intermediates(pair, version, chunk):
    if version == "v1":
        jtok, ttok, ids = v1_tokens()
        jm, tm_ = JaxMessenger(jtok), SPMupleMessenger(ttok)
        jinter = tinter = None
    else:
        jtok, ttok = pair.jgen.tokenizer, pair.tgen.tokenizer
        ids = np.asarray(pair.jgen.dataset.performances[0])
        jm, tm_ = JaxMessenger2(jtok), SPMuple2Messenger(ttok)
        jinter, tinter = JaxIntermediates2(initial_tempo=117.0), SPMuple2IntermediateData(initial_tempo=117.0)
    for i in range(0, len(ids), chunk):
        part = ids[i : i + chunk]
        kw = dict(return_intermediates=True, sort=False)
        want = jm.tokens_to_messages(part.copy(), intermediates=jinter, **kw)
        got = tm_.tokens_to_messages(part.copy(), intermediates=tinter, **kw)
        assert_same_messages(want, got)
        jinter, tinter = want[1], got[1]
    assert isinstance(tinter, IntermediateData)


# ---- MMD latent helpers ----


def test_mmd_latent_helpers_match_jax_and_round_trip(pair):
    """embeddings_to_latents and latents_to_embeddings of the style encoder
    against JAX's (1e-5), and their round trip as
    tests/test_mlm_and_isolated.py holds JAX's: the encoder's latents back to
    its note embeddings, and those to the latents of every bar that holds a
    note; a bar without notes has zero latents."""
    rng = np.random.RandomState(5)
    b, t = 2, 30
    x = np.stack([rng.randint(4, v, (b, t)) for v in pair.cfg["num_tokens"].values()], -1).astype(np.int32)
    seg = {"bars": np.sort(rng.randint(4, 12, (b, t)), 1).astype(np.int32),
           "beats": np.sort(rng.randint(4, 30, (b, t)), 1).astype(np.int32),
           "onsets": np.sort(rng.randint(4, 40, (b, t)), 1).astype(np.int32)}
    mask = np.ones((b, t), bool)
    mask[1, t - 4:] = False
    jseg = {k: jnp.asarray(v) for k, v in seg.items()}
    tseg = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in seg.items()}

    @jax.jit
    def jax_enc(variables, x, mask, seg):
        def fn(m):
            out = m.perf_encoder(x, mask=mask, deterministic=True, compute_loss=False, **seg)
            lat = m.perf_encoder.embeddings_to_latents(out.full_embeddings, mask=mask, **seg)
            return out, lat, m.perf_encoder.latents_to_embeddings(out.latents, t, **seg)

        return pair.jmodel.apply(variables, method=fn)

    out, want, want_emb = jax_enc(pair.variables, jnp.asarray(x), jnp.asarray(mask), jseg)
    emb = np.array(out.full_embeddings)
    enc = pair.port.perf_encoder
    with torch.no_grad():
        tout = enc(torch.as_tensor(x, dtype=torch.int64), mask=torch.as_tensor(mask), **tseg)
        np.testing.assert_allclose(tout.full_embeddings.numpy(), emb, atol=1e-5, rtol=1e-5)
        got = enc.embeddings_to_latents(torch.from_numpy(emb), mask=torch.as_tensor(mask), **tseg)
        got_emb = enc.latents_to_embeddings(tout.latents, t, **tseg)
        back = enc.embeddings_to_latents(got_emb, **tseg)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), atol=1e-5, rtol=1e-5)
    # the latents back to the encoder's note embeddings on every valid note
    full, valid = tout.full_embeddings.numpy(), np.broadcast_to(mask[..., None], emb.shape)
    np.testing.assert_allclose(got_emb.numpy()[valid], full[valid], atol=1e-6)
    # the unmasked sequence's bars: populated segments round-trip, empty ones are zero
    lat, seen = tout.latents[1].numpy()[0], np.zeros(tout.latents[1].shape[1], bool)
    seen[np.unique(seg["bars"][0])] = True
    np.testing.assert_allclose(back[1].numpy()[0][seen], lat[seen], atol=1e-5)
    assert (lat[~seen] == 0).all()


# ---- the decoder's multi-row decode_step ----


DECODE_CAP = 96


@pytest.fixture(scope="module")
def jax_consume(pair):
    """JAX's consume call: decode_step over `seq` at `start`, then the LM
    head on the last row, jitted once a chunk size."""
    model = pair.jmodel

    def fn(variables, caches, seq, masked, style, ctx, start):
        out = model.apply(variables, seq, masked_tokens=masked, style_embeddings=style, context=ctx, caches=caches,
                          cache_index=start, method="decode_step")
        logits = model.apply(variables, out.hidden_state[:, -1],
                             method=lambda m, h: m.perf_decoder.apply_lm_head(h))
        return out.caches, logits

    return jax.jit(fn)


@pytest.mark.parametrize("C", [1, 8, 64])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_multi_row_decode_step_matches_jax(pair, jax_consume, C, where):
    start = {"first": 0, "middle": (DECODE_CAP - C) // 2, "last": DECODE_CAP - C}[where]
    rng = np.random.RandomState(C + start)
    sizes = list(pair.cfg["num_tokens"].values())
    seq = np.stack([rng.randint(4, v, (1, C)) for v in sizes], -1).astype(np.int32)
    masked = seq.copy()
    masked[..., pair.tgen.mask_dims] = 1
    style = rng.randn(1, C, pair.port.perf_encoder.embedding_dim).astype(np.float32)
    ctx = rng.randn(1, C, 32).astype(np.float32)
    # caches holding earlier rows (random) before `start`, stale rows after
    jcaches = pair.jmodel.apply(pair.variables, 1, DECODE_CAP, method=lambda m, b, t: m.init_decoder_cache(b, t))
    jcaches = [None if c is None else {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)) for k, v in c.items()}
               for c in jcaches]
    tcaches = [None if c is None else {k: torch.from_numpy(np.array(v)) for k, v in c.items()} for c in jcaches]
    jc, jlogits = jax_consume(pair.variables, jcaches, *map(jnp.asarray, (seq, masked, style, ctx)), start)
    with torch.no_grad():
        hidden = pair.port.decode_step(torch.as_tensor(seq, dtype=torch.int64),
                                       torch.as_tensor(masked, dtype=torch.int64), torch.from_numpy(style),
                                       torch.from_numpy(ctx), caches=tcaches, cache_index=torch.tensor([start]))
        tlogits = pair.port.decoder.apply_lm_head(hidden[:, -1])
    for j, t in zip(jc, tcaches):
        if j is not None:
            for k in ("k", "v"):
                np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5, rtol=1e-5)
    assert set(tlogits) == set(jlogits)
    for key, lg in tlogits.items():
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlogits[key]), atol=1e-4, rtol=1e-4, err_msg=key)


# ---- the encoder pass ----


@pytest.mark.parametrize("overlay_bars", [0.0, 0.5])
def test_prepare_performance_notes_matches_jax(pair, overlay_bars):
    pair.jgen.reset()
    pair.tgen.reset()
    want = pair.jgen.prepare_performance_notes(0, overlay_bars=overlay_bars)
    got = pair.tgen.prepare_performance_notes(0, overlay_bars=overlay_bars)
    np.testing.assert_array_equal(got.notes, want.notes)
    assert got.context.shape == want.context.shape and got.embeddings.shape == want.embeddings.shape
    np.testing.assert_allclose(got.context, want.context, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=1e-4, rtol=1e-4)
    assert got.intermediates.initial_tempo == want.intermediates.initial_tempo


def test_encode_embeddings_latents_match_jax(pair):
    _, jemb, jlat = pair.jgen.encode_embeddings(0, compute_latents=True)
    _, temb, tlat = pair.tgen.encode_embeddings(0, compute_latents=True)
    np.testing.assert_allclose(temb, jemb, atol=1e-4, rtol=1e-4)
    for g, w in zip(tlat, jlat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


# ---- greedy windows, token for token ----


class JaxEvents:
    """What the JAX decoder did over a run: left-aligned (near-capacity)
    blocks and rollbacks past an overshoot."""

    def __init__(self, monkeypatch):
        self.left_aligned = self.rollbacks = 0
        block, rollback = JaxDecoder.decode_block, JaxDecoder.rollback
        events = self

        def spy_block(dec, tokens, masked, style, ctx, first, n, *a, **kw):
            n_pad = next((b for b in dec.BLOCK_BUCKETS if b >= n), None)
            if n_pad is not None and (first - 1) + n_pad > dec.max_context_len:
                events.left_aligned += 1
            return block(dec, tokens, masked, style, ctx, first, n, *a, **kw)

        def spy_rollback(dec, position):
            if position < dec.consumed:
                events.rollbacks += 1
            return rollback(dec, position)

        monkeypatch.setattr(JaxDecoder, "decode_block", spy_block)
        monkeypatch.setattr(JaxDecoder, "rollback", spy_rollback)


def test_greedy_windows_equal_jax(pair, monkeypatch):
    """Blocks of up to 20 notes (JAX's 32 bucket), so that JAX left-aligns
    some near the cache's end, where the port decodes just the real rows."""
    events = JaxEvents(monkeypatch)
    kw = dict(greedy=True, block_size=32, window=0.5)
    want = pair.jax_greedy("wide", **kw)
    got = drive(pair.tgen, **kw)
    assert len(want) >= 10
    assert max(w[2] for w in want) > 0, "no window shift"
    assert events.rollbacks > 0, "no rollback past an overshoot"
    assert events.left_aligned > 0, "no block near the cache's end"
    assert_same_windows(want, got)
    # the same window shifts (each a reset of the decoder)
    assert got[-1][3]["resets"] - got[0][3]["resets"] == want[-1][3]["resets"] - want[0][3]["resets"]


def test_greedy_windows_with_a_style_delta_equal_jax(pair):
    delta = np.random.RandomState(4).randn(pair.port.perf_encoder.embedding_dim).astype(np.float32) * 0.1
    want = pair.jax_greedy("delta", greedy=True, delta_embedding=delta)
    got = drive(pair.tgen, greedy=True, delta_embedding=delta)
    assert len(want) >= 10
    assert_same_windows(want, got)
    np.testing.assert_allclose(pair.tgen.perf_data.embeddings, pair.jgen.perf_data.embeddings, atol=1e-6)
    plain = pair.jax_greedy("plain", greedy=True)
    assert any(p[0] is not None and d[0] is not None and not np.array_equal(p[0], d[0])
               for p, d in zip(plain, want)), "the style delta changed no token"


def test_warmup_keeps_the_greedy_windows(pair):
    pair.tgen.warmup(max_context_len=CTX, greedy=True)
    assert pair.tgen._decoder.stats["block_refusals"] == 0
    assert_same_windows(pair.jax_greedy("plain", greedy=True), drive(pair.tgen, greedy=True))


def test_predict_number_of_notes_matches_jax(pair):
    for gen in (pair.jgen, pair.tgen):
        gen.reset()
        gen.prepare_performance_notes(0, overlay_bars=0.0)
        gen.generate_performance_notes(start_time=0.0, time_window=1.0, greedy=True, max_context_len=CTX)
    for start, width in ((1.0, 0.2), (1.0, 1.5), (2.0, 0.5)):
        assert pair.tgen.predict_number_of_notes(start, width) == pair.jgen.predict_number_of_notes(start, width)


# ---- the port's own properties (tests/test_inference.py's, ported) ----


def port_run(pair, windows=12, **kw):
    return drive(pair.tgen, windows=windows, **kw)


def generated(run):
    return np.concatenate([t for t, _, _, _ in run if t is not None])


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_block_and_per_note_decoding_give_the_same_tokens(pair, monkeypatch, greedy):
    """One seed, the same blocks of notes: decoded by `decode_block` (one
    device-to-host copy a block) or, where a block is refused, note by note
    through `predict` (one copy a note). The block partition itself decides
    where the window shifts, and so the context, so it is held fixed."""
    kw = dict(greedy=greedy, temperature=1.5, seed=21, block_size=16)
    block = port_run(pair, **kw)
    assert block[-1][3]["block_calls"] > block[0][3]["block_calls"]
    assert block[-1][3]["block_refusals"] == block[0][3]["block_refusals"]

    def refuse(self, *a, **k):
        self.stats["block_refusals"] += 1

    monkeypatch.setattr(StreamingDecoder, "decode_block", refuse)
    per_note = port_run(pair, **kw)
    assert per_note[-1][3]["block_refusals"] > block[-1][3]["block_refusals"]
    assert per_note[-1][3]["block_calls"] == block[-1][3]["block_calls"]
    np.testing.assert_array_equal(generated(block), generated(per_note))
    for b, p in zip(block, per_note):
        if b[0] is not None:
            np.testing.assert_array_equal(np.asarray(b[1]), np.asarray(p[1]))


def test_gumbel_noise_depends_on_the_note_alone():
    whole = gumbel_noise(9, np.arange(10, 26), (3, 5, 10), 40)
    parts = np.concatenate([gumbel_noise(9, [n], (3, 5, 10), 40) for n in range(10, 26)])
    np.testing.assert_array_equal(whole, parts)
    np.testing.assert_array_equal(gumbel_noise(9, [12], (5,), 40)[0, 0], whole[2, 1])
    assert not np.array_equal(gumbel_noise(10, np.arange(10, 26), (3, 5, 10), 40), whole)
    # a Gumbel(0, 1) sample: mean 0.5772, variance pi^2 / 6
    big = gumbel_noise(1, np.arange(2000), (0, 1), 64).ravel()
    assert abs(big.mean() - 0.5772) < 0.02 and abs(big.var() - np.pi**2 / 6) < 0.05


def test_temperature_changes_the_sampled_tokens(pair):
    cool = generated(port_run(pair, windows=3, greedy=False, temperature=0.2, seed=13))
    hot = generated(port_run(pair, windows=3, greedy=False, temperature=5.0, seed=13))
    n = min(len(cool), len(hot))
    assert not np.array_equal(cool[:n], hot[:n])
    # between windows of one stream, too: the decoder is kept
    pair.tgen.reset()
    pair.tgen.prepare_performance_notes(0, overlay_bars=0.0)
    decoder = pair.tgen._decoder
    for w, temp in enumerate((0.2, 5.0, 1.0)):
        pair.tgen.generate_performance_notes(start_time=w * WINDOW, time_window=WINDOW, greedy=False,
                                             temperature=temp, seed=13, max_context_len=CTX)
    assert pair.tgen._decoder is decoder


def test_generated_ids_stay_in_each_streams_vocabulary(pair):
    sizes = list(pair.cfg["num_tokens"].values())
    for seed in range(3):
        out = generated(port_run(pair, greedy=False, temperature=3.0, seed=seed))
        for s, size in enumerate(sizes):
            assert out[:, s].max() < size and out[:, s].min() >= 0
        assert not (out == 1).any()  # every MASK filled


def test_window_never_outgrows_the_cache(pair, monkeypatch):
    positions = []
    consume = StreamingDecoder._consume_to

    def spy(self, tokens, masked, style, context, position, **kw):
        positions.append(position)
        assert position <= self.max_context_len
        return consume(self, tokens, masked, style, context, position, **kw)

    monkeypatch.setattr(StreamingDecoder, "_consume_to", spy)
    gen = pair.tgen
    gen.reset()
    gen.prepare_performance_notes(0, overlay_bars=0.0)
    clock = 0.0
    for w in range(24):
        gen.generate_performance_notes(start_time=clock, time_window=0.3, greedy=True, seed=w, max_context_len=10)
        clock += 0.3
        if gen.perf_data.reached_eos:
            break
    assert positions
    assert gen._decoder.stats["block_refusals"] == 0


def test_a_group_wider_than_the_window_raises(pair):
    """A chord of several notes cannot fit a context of 2: no shift makes
    room for it, so the generator refuses rather than outgrow its cache."""
    gen = pair.tgen
    gen.reset()
    gen.prepare_performance_notes(0, overlay_bars=0.0)
    with pytest.raises(ValueError, match="cannot fit"):
        for w in range(20):
            gen.generate_performance_notes(start_time=w * 0.5, time_window=0.5, greedy=True, max_context_len=2,
                                           block_size=1)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_after_a_shift_the_tokens_of_a_fresh_generator(pair, monkeypatch, greedy):
    """The decode writes its cache in place, so a reset must not hand back
    rows that earlier windows wrote, and rows past the write frontier must
    never be read. Over windows with shifts: the long-lived generator (its
    decoder's cache written by every earlier test), a fresh generator, and
    one whose caches come back from every reset full of large garbage give
    the same tokens."""
    kw = dict(greedy=greedy, temperature=1.5, seed=8)
    reused = port_run(pair, **kw)
    assert max(r[2] for r in reused) > 0, "no window shift"
    assert reused[-1][3]["resets"] > reused[0][3]["resets"]

    def fresh_run():
        gen = ScorePerformerGenerator(pair.port, pair.tgen.dataset, pair.tgen.collator, pair.tgen.messenger)
        return drive(gen, **kw)

    fresh = fresh_run()
    init = StreamingDecoder._init_cache

    def garbage(self):
        caches = init(self)
        g = torch.Generator().manual_seed(self.stats["resets"])
        for layer in caches:
            for t in (layer or {}).values():
                t.copy_(torch.randn(t.shape, generator=g) * 1e3)
        return caches

    monkeypatch.setattr(StreamingDecoder, "_init_cache", garbage)
    poisoned = fresh_run()
    for other in (fresh, poisoned):
        np.testing.assert_array_equal(generated(other), generated(reused))


def test_reset_hands_back_a_zeroed_cache(pair):
    dec = StreamingDecoder(pair.port, CTX, len(pair.cfg["num_tokens"]))
    first = dec._init_cache()
    for layer in first:
        for t in (layer or {}).values():
            t.fill_(7.0)
    again = dec._init_cache()
    assert all(a is b for la, lb in zip(first, again) if la for a, b in zip(la.values(), lb.values()))
    assert all(not t.any() for layer in again if layer for t in layer.values())

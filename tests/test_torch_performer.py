"""The standalone Performer family in the port against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights (a JAX `model.init`
carried over by `scoreperformer_tpu_torch.convert`) go through both, at a
small size (dim 32, 1-2 layers, 2 heads of 16). Tolerances: the performance
dataset's samples and the collators' batches exactly; forwards, heads and
losses 1e-5; one train step's loss 1e-5 and gradients atol/rtol 1e-4 against
`jax.value_and_grad`; the filters' logits 1e-6 with the same -inf set;
greedy `ar_generate` and `mlm_unmask` exactly (tokens and `num_generated`).
Sampled tokens cannot match `jax.random`: they are checked by their support.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu import data as jdata
from scoreperformer_tpu.data.synthetic import build_synthetic_dataset
from scoreperformer_tpu.models import MODELS
from scoreperformer_tpu.models import scoreperformer as jsp
from scoreperformer_tpu.models import wrappers as jwrappers
from scoreperformer_tpu.ops import sampling as jsampling
from scoreperformer_tpu.training import evaluator as jevaluator
from scoreperformer_tpu.training.torch_convert import convert_reference_state_dict

from scoreperformer_tpu_torch import data as tdata
from scoreperformer_tpu_torch import train as ttrain
from scoreperformer_tpu_torch.convert import _expand, jax_param_paths, load_state_dict, state_dict_from_jax
from scoreperformer_tpu_torch.inference import load_model_from_checkpoint
from scoreperformer_tpu_torch.models import scoreperformer as tsp
from scoreperformer_tpu_torch.models import wrappers as twrappers
from scoreperformer_tpu_torch.models.factory import build_performer, build_scoreperformer
from scoreperformer_tpu_torch.ops import sampling as tsampling
from scoreperformer_tpu_torch.training import evaluator as tevaluator
from scoreperformer_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

from test_torch_modules import NUM_TOKENS, build_pair as build_scoreperformer_pair, make_inputs, tiny_config

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = list(NUM_TOKENS)


def performer_config(mode="clm", head="lm-tied", depth=2, max_seq_len=40, dropout=0.0, multiseq=False,
                     reuse_projection=True):
    """A small Performer: recipes/performer.yaml's layout at dim 32, 2 heads
    of 16, one KV head, learned ALiBi, GLU-swish; a decoder for clm and
    mixlm, an encoder for mlm."""
    emb = {"_target_": "multi-seq" if multiseq else "simple", "emb_dims": 16, "mode": "cat", "emb_norm": True,
           "discrete": False, "continuous": True, "continuous_dense": True, "discrete_ids": [0, 1, 2, 3],
           "token_values": {k: np.linspace(0, 1, v).tolist() for k, v in NUM_TOKENS.items()}}
    if multiseq:
        emb["multiseq_mode"] = "post-cat"
    lm_head = {"_target_": head}
    if not reuse_projection:
        lm_head["reuse_projection"] = False
    return {
        "num_tokens": NUM_TOKENS, "mode": mode,
        "transformer": {
            "dim": 32, "max_seq_len": max_seq_len, "token_embeddings": emb, "emb_norm": True,
            "use_abs_pos_emb": False,
            "transformer": {"_target_": "encoder" if mode == "mlm" else "decoder", "depth": depth, "heads": 2,
                            "attention": {"dim_head": 16, "one_kv_head": True, "alibi_pos_bias": True,
                                          "alibi_learned": True, "dropout": dropout},
                            "feed_forward": {"mult": 2, "glu": True, "swish": True, "dropout": dropout}},
            "lm_head": lm_head,
        },
    }


def tokens(seed=0, b=2, t=12):
    """Random performance tokens (no special ids), with non-decreasing bars."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(4, v, (b, t)) for v in NUM_TOKENS.values()], -1).astype(np.int64)
    x[..., 0] = np.sort(rng.randint(4, 9, (b, t)), 1)
    return x


def build_pair(cfg, x):
    """(JAX model, JAX variables, port model on the CPU) with the same weights."""
    model, _ = MODELS.get("Performer")(**cfg)
    variables = jax.jit(lambda r, p: model.init(r, p, masked_perf=p))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x))
    port, _ = build_performer(cfg, device="cpu", seed=0)
    load_state_dict(port, state_dict_from_jax(jax.device_get(variables["params"])))
    return model, variables, port.eval()


def t(x):
    return torch.from_numpy(np.array(x))


def close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **tol)


@pytest.fixture(scope="module")
def clm_pair():
    return build_pair(performer_config(), tokens())


@pytest.fixture(scope="module")
def mlm_pair():
    return build_pair(performer_config(mode="mlm", head="lm"), tokens())


# ---- the performance dataset and its collators: exactly ----


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("perf_data"))
    build_synthetic_dataset(root, n_scores=2, n_perfs_per_score=2, n_bars=12, seed=17, with_directions=False)
    return root


DATASET_ARGS = dict(max_seq_len=48, bar_sliding_window=8, fit_to_zero_bar=True, add_sos_eos=True, sample=True,
                    sample_bars=True, augment_performance=True, velocity_shift_range=(-12, 12), seed=5)


def test_performance_dataset_samples_match_jax(data_root):
    want = jdata.PerformanceDataset(root=data_root, **DATASET_ARGS)
    got = tdata.DATASETS.get("PerformanceDataset")(root=data_root, **DATASET_ARGS)
    assert len(got) == len(want) > 4
    for idx in range(len(want)):
        a = want.get(idx, rng=np.random.RandomState(idx))
        b = got.get(idx, rng=np.random.RandomState(idx))
        np.testing.assert_array_equal(b.perf, a.perf)
        assert (b.meta.start_bar, b.meta.end_bar, b.meta.bar_offset) == (a.meta.start_bar, a.meta.end_bar,
                                                                         a.meta.bar_offset)
        # replaying the sample's meta gives the sample
        np.testing.assert_array_equal(got.get(meta=b.meta).perf, b.perf)


@pytest.mark.parametrize("name,kwargs", [
    ("PerformanceCollator", {}),
    ("LMPerformanceCollator", {}),
    ("LMPerformanceCollator", {"mlm": True, "mask_ignore_token_ids": [0, 1, 2, 3], "seed": 3}),
    ("MixedLMPerformanceCollator", {"mask_ignore_token_ids": [0, 1, 2, 3], "mask_ignore_token_dims": [0, 1, 2, 4]}),
], ids=["plain", "clm", "mlm", "mixlm"])
def test_performance_collators_match_jax(data_root, name, kwargs):
    dataset = jdata.PerformanceDataset(root=data_root, **DATASET_ARGS)
    samples = [dataset.get(i, rng=np.random.RandomState(i)) for i in range(4)]
    want = jdata.performer_model_inputs(jdata.COLLATORS.get(name)(fixed_seq_len=50, **kwargs)(samples))
    got = tdata.performer_model_inputs(tdata.COLLATORS.get(name)(fixed_seq_len=50, **kwargs)(samples))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ---- the model: forward, heads, one train step ----


def forward_inputs(mode, seed=0):
    x = tokens(seed, t=14)
    mask = np.ones(x.shape[:2], bool)
    mask[1, -3:] = False
    labels = np.where(mask[..., None], x, -100)
    masked = x.copy()
    masked[..., 3:] = 1
    inputs = {"perf": x, "mask": mask, "labels": labels}
    if mode == "mixlm":
        inputs["masked_perf"] = masked
    if mode == "mlm":
        inputs["perf"] = np.where(np.random.RandomState(seed).rand(*x.shape) < 0.3, 1, x)
    return inputs


@pytest.mark.parametrize("mode", ["clm", "mlm", "mixlm"])
def test_performer_forward_matches_jax(mode):
    inputs = forward_inputs(mode)
    model, variables, port = build_pair(performer_config(mode=mode, multiseq=mode == "mixlm"), inputs["perf"])
    want = model.apply(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = port(**{k: t(v) for k, v in inputs.items()})
    close(want.loss, got.loss)
    assert list(got.logits) == NAMES
    for key in NAMES:
        close(want.perf_decoder.logits[key], got.logits[key])
    assert set(got.losses) == set(want.losses)
    for key in want.losses:
        close(want.losses[key], got.losses[key])


@pytest.mark.parametrize("head", ["lm", "lm-tied-split", "lm-tied-own-projection"])
def test_performer_heads_match_jax(head):
    cfg = performer_config(head=head.replace("-own-projection", ""), reuse_projection="own" not in head)
    inputs = forward_inputs("clm", seed=1)
    model, variables, port = build_pair(cfg, inputs["perf"])
    want = model.apply(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = port(**{k: t(v) for k, v in inputs.items()})
    close(want.loss, got.loss)
    for key in NAMES:
        close(want.perf_decoder.logits[key], got.logits[key])
    # only some streams: the head's `keys`
    hidden = port.decoder(t(inputs["perf"][:, :-1]))
    assert list(port.decoder.apply_lm_head(hidden, keys=["Pitch", "Bar"])) == ["Bar", "Pitch"]


def test_untied_head_filter_keys_match_jax():
    cfg = performer_config(head="lm")
    cfg["transformer"]["lm_head"]["filter_keys"] = ["Velocity", "Tempo"]
    inputs = forward_inputs("clm", seed=2)
    model, variables, port = build_pair(cfg, inputs["perf"])
    want = model.apply(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = port(**{k: t(v) for k, v in inputs.items()})
    assert list(got.logits) == ["Velocity", "Tempo"]
    for key in got.logits:
        close(want.perf_decoder.logits[key], got.logits[key])
    close(want.loss, got.loss)


def test_performer_train_step_matches_jax_value_and_grad():
    inputs = forward_inputs("clm", seed=3)
    model, variables, port = build_pair(performer_config(), inputs["perf"])
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: model.apply({"params": p}, **jin).loss))(variables["params"])
    port.train()
    out = port(**{k: t(v) for k, v in inputs.items()}, generators={"dropout": torch.Generator().manual_seed(0)})
    out.loss.backward()
    close(loss, out.loss)
    want = state_dict_from_jax(jax.device_get(grads))
    named = dict(port.named_parameters())
    assert len(want) == len(named)
    for name, g in want.items():
        hit = next(n for n in _expand(name) if n in named)
        close(g, named[hit].grad, GRAD_TOL)


def test_performer_parameter_paths_are_the_jax_tree():
    """Every port parameter maps to the JAX parameter of its flax path, so
    that `finetune_layers` and `warm_start` reach a Performer."""
    for head in ("lm-tied", "lm", "lm-tied-split"):
        cfg = performer_config(head=head)
        model, variables, port = build_pair(cfg, tokens())
        flat = {"/".join(str(p.key) for p in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(jax.device_get(variables["params"]))[0]}
        paths = jax_param_paths(port)
        assert {"/".join(path) for path, _ in paths.values()} == set(flat)
        params = dict(port.named_parameters())
        for name, (path, transposed) in paths.items():
            value = flat["/".join(path)]
            np.testing.assert_array_equal(params[name].detach().numpy(), value.T if transposed else value)


def test_regression_head_and_losses_match_jax():
    cfg = tiny_config()
    cfg["perf_encoder"] = None  # no style: no MMD samples to share
    cfg["perf_decoder"]["style_emb_mode"] = "cat"
    cfg["perf_decoder"]["regression_head"] = {"regression_keys": ["Velocity", "Tempo"]}
    x = make_inputs(seed=4)
    model, variables, port = build_scoreperformer_pair(cfg, x)
    labels = np.where(x["mask"][..., None], x["perf"], -100)
    labels[0, :3, 3] = 2  # special labels, left out of the regression
    kw = dict(perf=x["perf"], perf_mask=x["mask"], score=x["score"], score_mask=x["mask"], masked_perf=x["masked"],
              labels=labels)
    want = model.apply(variables, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = port(**{k: t(v) for k, v in kw.items()})
    close(want.loss, got.loss)
    for key in ("Velocity", "Tempo"):
        close(want.perf_decoder.reg_values[key], got.reg_values[key])
        close(want.losses[f"{key}/l1"], got.losses[f"{key}/l1"])
    close(want.losses["loss/lm"], got.losses["loss/lm"])
    # the function alone
    rng = np.random.RandomState(5)
    reg = {k: rng.randn(2, 7, 1).astype(np.float32) for k in ("a", "c")}
    lab = rng.randint(0, 9, (2, 7, 3))
    values = {k: np.linspace(0, 1, 9).tolist() for k in "abc"}
    want_loss, want_terms = jsp.regression_losses({k: jnp.asarray(v) for k, v in reg.items()}, list("abc"),
                                                  jnp.asarray(lab), values)
    got_loss, got_terms = tsp.regression_losses({k: t(v) for k, v in reg.items()}, list("abc"), t(lab), values)
    close(want_loss, got_loss, dict(atol=1e-6, rtol=1e-6))
    assert set(got_terms) == set(want_terms) == {"a/l1", "c/l1"}


def test_performer_evaluator_matches_jax():
    inputs = forward_inputs("clm", seed=6)
    model, variables, port = build_pair(performer_config(), inputs["perf"])
    want_out = model.apply(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    got_out = port(**{k: t(v) for k, v in inputs.items()})

    class Tokenizer:
        def token_values(self, normalize=False):
            return {k: np.arange(v, dtype=np.float32) * 0.5 for k, v in NUM_TOKENS.items()}

    kw = dict(tokenizer=Tokenizer(), mode="clm", weighted_distance=True, ignore_keys=["Bar", "TimeSig"])
    want = jevaluator.ScorePerformerEvaluator(**kw)(jnp.asarray(inputs["labels"]), want_out.perf_decoder.logits)
    got = tevaluator.ScorePerformerEvaluator(**kw)(t(inputs["labels"]), got_out.logits)
    assert set(got) == set(want)
    for key in want:
        close(want[key], got[key])


# ---- sampling filters: the same logits and -inf set ----


@pytest.mark.parametrize("name,kwargs", [
    ("top_p", {"thres": 0.9}), ("top_p", {"thres": 0.5}), ("top_a", {}), ("top_a", {"min_p_pow": 1.0, "min_p_ratio": 0.1}),
    ("top_k", {"thres": 0.9}),
])
def test_filters_match_jax(name, kwargs):
    logits = np.random.RandomState(7).randn(6, 33).astype(np.float32) * 3
    logits[0, :5] = logits[0, 5]  # ties
    logits[1, :2] = -1e9  # masked ids
    want = np.asarray(getattr(jsampling, name)(jnp.asarray(logits), **kwargs))
    got = getattr(tsampling, name)(t(logits), **kwargs).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fn", ["top_p", "top_a", "top_k"])
def test_filter_logits_and_sample_matches_jax(fn):
    logits = np.random.RandomState(8).randn(64, 21).astype(np.float32) * 2
    kw = dict(filter_kwargs={"thres": 0.8} if fn != "top_a" else {}, temperature=0.7)
    want = jsampling.filter_logits_and_sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                                              getattr(jsampling, fn), sample=False, **kw)
    got = tsampling.filter_logits_and_sample(None, t(logits), getattr(tsampling, fn), sample=False, **kw)
    close(want, got, dict(atol=1e-6, rtol=1e-6))
    draws = tsampling.filter_logits_and_sample(torch.Generator().manual_seed(0), t(logits), getattr(tsampling, fn),
                                               **kw)
    assert draws.shape == (64,)
    assert (np.asarray(want)[np.arange(64), draws.numpy()] > 0).all()


# ---- ar_generate: JAX's tokens, greedy ----


AR_CASES = {
    # chunked: t0 >= 2 and the generation fits the window; step counts that are no multiple of C
    "chunked_t0_4": dict(t0=4, seq_len=30),
    "chunked_t0_2": dict(t0=2, seq_len=30),
    "chunked_c5": dict(t0=4, seq_len=22, chunk_size=5),
    "classic": dict(t0=4, seq_len=30, chunk_size=None),
    # past max_seq_len (40): the ring wraps
    "ring": dict(t0=4, seq_len=70),
    "ring_t0_1": dict(t0=1, seq_len=20),
    "no_fix_errors": dict(t0=4, seq_len=30, fix_errors=False),
    "no_fix_errors_ring": dict(t0=3, seq_len=50, fix_errors=False),
    "stream_names_default": dict(t0=4, seq_len=20, stream_names=None),
}


def ar_pair(model, variables, port, prompt, **kw):
    kw = {"stream_names": NAMES, **kw}
    want_gen, want_n = jwrappers.ar_generate(model, variables, jnp.asarray(prompt), rng=jax.random.PRNGKey(0),
                                             greedy=True, **kw)
    got_gen, got_n = twrappers.ar_generate(port, t(prompt), greedy=True, **kw)
    return np.asarray(want_gen), np.asarray(want_n), got_gen.numpy(), got_n.numpy()


@pytest.mark.parametrize("case", list(AR_CASES))
def test_ar_generate_greedy_matches_jax(clm_pair, case):
    kw = dict(AR_CASES[case])
    t0 = kw.pop("t0")
    prompt = tokens(seed=9, b=3, t=t0)
    want_gen, want_n, got_gen, got_n = ar_pair(*clm_pair, prompt, **kw)
    assert got_gen.shape == (3, kw["seq_len"] + 1 - t0, len(NAMES))
    np.testing.assert_array_equal(got_gen, want_gen)
    np.testing.assert_array_equal(got_n, want_n)


def test_ar_generate_max_bar_stop_matches_jax():
    """An untied head whose Bar bias rises with the id, so that greedy bars
    climb and rows pass `max_bar` at different steps: a row stops at its
    first Bar above it, PAD in its other streams and in every later row."""
    model, variables, port = build_pair(performer_config(head="lm"), tokens())
    params = jax.device_get(variables["params"])
    params["transformer"]["lm_head"]["head_Bar"]["bias"] = np.linspace(0, 1, NUM_TOKENS["Bar"]).astype(np.float32)
    load_state_dict(port, state_dict_from_jax(params))
    want_gen, want_n, got_gen, got_n = ar_pair(model, {"params": params}, port, tokens(seed=9, b=4, t=4),
                                               seq_len=30, max_bar=12)
    np.testing.assert_array_equal(got_gen, want_gen)
    np.testing.assert_array_equal(got_n, want_n)
    assert len(set(got_n.tolist())) > 1 and (got_n < got_gen.shape[1]).all()
    for row, n in enumerate(got_n):
        assert got_gen[row, n - 1, 0] > 12 and (got_gen[row, n - 1, 1:] == 0).all() and (got_gen[row, n:] == 0).all()


def test_ar_generate_eos_stop_matches_jax(clm_pair):
    """Prompts whose greedy continuation emits EOS on the Bar stream: the
    row's other streams are PAD from there, every later row is PAD."""
    stops = 0
    for seed in (13, 14):  # prompts whose continuations stop, one in each row
        prompt = tokens(seed=seed, b=2, t=4)
        want_gen, want_n, got_gen, got_n = ar_pair(*clm_pair, prompt, seq_len=24)
        np.testing.assert_array_equal(got_gen, want_gen)
        np.testing.assert_array_equal(got_n, want_n)
        for row, n in enumerate(got_n):
            if got_gen[row, n - 1, 0] == 3:
                stops += 1
                assert (got_gen[row, n - 1, 1:] == 0).all() and (got_gen[row, n:] == 0).all()
    assert stops == 2


def test_ar_generate_scoreperformer_with_style_and_context_matches_jax():
    x = make_inputs(seed=11, b=2, t=21)
    model, variables, port = build_scoreperformer_pair(tiny_config(), x)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    context, style, _ = model.apply(variables, j["perf"], j["mask"], j["score"], j["mask"], j["bars"], j["beats"],
                                    j["onsets"], method="encode_embeddings")
    prompt = x["perf"][:, :4].astype(np.int64)
    kw = dict(seq_len=20, stream_names=NAMES)
    want_gen, want_n = jwrappers.ar_generate(model, variables, jnp.asarray(prompt), rng=jax.random.PRNGKey(0),
                                             greedy=True, style_embeddings=style, context=context, **kw)
    got_gen, got_n = twrappers.ar_generate(port, t(prompt), greedy=True, style_embeddings=t(style),
                                           context=t(context), **kw)
    np.testing.assert_array_equal(got_gen.numpy(), np.asarray(want_gen))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("fn,kwargs,chunk_size", [("top_p", {"thres": 0.8}, 16), ("top_a", {}, None),
                                                  ("top_k", {"thres": 0.9}, 16)])
def test_ar_generate_sampled_ids_lie_in_the_filtered_support(clm_pair, fn, kwargs, chunk_size):
    """Every sampled id is in its stream's vocabulary and in the support of
    the filter (recomputed with the plain filter on the step's logits);
    without fix_errors, before a row stops."""
    _, _, port = clm_pair
    prompt = t(tokens(seed=12, b=4, t=4))
    gen, num = twrappers.ar_generate(port, prompt, 26, torch.Generator().manual_seed(1), filter_fn=getattr(tsampling, fn),
                                     filter_kwargs=kwargs, stream_names=NAMES, fix_errors=False,
                                     chunk_size=chunk_size)
    seq = torch.cat([prompt, gen], dim=1)
    for s, (key, V) in enumerate(NUM_TOKENS.items()):
        assert (gen[..., s] < V).all() and (gen[..., s] >= 0).all()
    with torch.inference_mode():  # the logits of every step, by one causal forward
        logits = port.decoder.apply_lm_head(port.decoder(seq[:, :-2]))
    for s, key in enumerate(NAMES):
        lg = logits[key][:, 2:].clone()  # position L's logits consume token L - 2
        lg[..., :2] = -1e9
        support = getattr(tsampling, fn)(lg, **kwargs) > -np.inf
        for row in range(4):
            n = int(num[row])
            steps = range(n - 1 if gen[row, n - 1, 0] == 3 else n)
            ids = gen[row, list(steps), s]
            assert support[row, list(steps), ids].all(), (fn, key, row)


# ---- mlm_unmask: JAX's tokens, greedy ----


@pytest.mark.parametrize("single_run,forbid", [(True, False), (False, False), (False, True)],
                         ids=["single_run", "iterative", "iterative_forbid_ids"])
def test_mlm_unmask_greedy_matches_jax(mlm_pair, single_run, forbid):
    model, variables, port = mlm_pair
    x = tokens(seed=13, b=2, t=14)
    x[:, 3:7, 2] = 1
    x[0, 9:11, :4] = 1
    x[1, 5, :] = 1
    mask = np.ones(x.shape[:2], bool)
    mask[1, -2:] = False
    forbid_ids = {2: np.array([5, 6, 7]), 0: np.array([4])} if forbid else None
    want = jwrappers.mlm_unmask(model, variables, jnp.asarray(x), jax.random.PRNGKey(0), single_run=single_run,
                                mask=jnp.asarray(mask), greedy=True,
                                forbid_ids={s: jnp.asarray(v) for s, v in forbid_ids.items()} if forbid else None)
    got = twrappers.mlm_unmask(port, t(x), single_run=single_run, mask=t(mask), greedy=True,
                               forbid_ids={s: t(v) for s, v in forbid_ids.items()} if forbid else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got.numpy() == 1).any()
    if forbid:
        filled = x == 1
        assert not np.isin(got.numpy()[..., 2][filled[..., 2]], [5, 6, 7]).any()


def test_mlm_unmask_sampled_fills_outside_the_special_ids(mlm_pair):
    _, _, port = mlm_pair
    x = tokens(seed=14, b=2, t=10)
    x[:, 2:5, 1:4] = 1
    got = twrappers.mlm_unmask(port, t(x), torch.Generator().manual_seed(0), single_run=False,
                               filter_fn=tsampling.top_p, filter_kwargs={"thres": 0.9}).numpy()
    assert (got[x == 1] >= 4).all()
    np.testing.assert_array_equal(got[x != 1], x[x != 1])


# ---- checkpoints: a reference-layout .pt and a port directory ----


def test_reference_performer_checkpoint_loads_as_jax_imports_it(tmp_path):
    """A reference-layout `.pt` ({"model": {"config", "state_dict"}}, the
    reference's `transformer.model.*` names) of a Performer loads into the
    port and gives the logits of the JAX model that the JAX converter
    (`convert_reference_state_dict`, which `import_reference_checkpoint`
    runs) builds from the same state dict. `import_reference_checkpoint`
    itself cannot build a Performer's template: it passes the
    ScorePerformer's inputs."""
    cfg = performer_config(head="lm")
    x = tokens(seed=15, t=10)
    model, variables, _ = build_pair(cfg, x)
    state = {k.replace("proj|0", "proj"): torch.from_numpy(np.array(v))
             for k, v in state_dict_from_jax(jax.device_get(variables["params"])).items()}
    path = tmp_path / "performer.pt"
    torch.save({"model": {"config": {"_name_": "Performer", **cfg}, "state_dict": state}}, path)
    loaded = torch.load(path, weights_only=False)["model"]["state_dict"]
    template = jax.tree_util.tree_map(np.zeros_like, jax.device_get(variables["params"]))
    params, _ = convert_reference_state_dict({k: v.numpy() for k, v in loaded.items()}, template)
    want = model.apply({"params": params}, jnp.asarray(x)).perf_decoder.logits
    port, port_cfg = load_model_from_checkpoint(str(path), device="cpu")
    assert isinstance(port, tsp.PerformerModel) and port_cfg.mode == "clm"
    got = port(t(x)).logits
    for key in NAMES:
        close(want[key], got[key])
    # and through a port checkpoint directory
    save_checkpoint(str(tmp_path / "ckpt"), port, model_config={"_name_": "Performer", **cfg})
    again, _ = load_model_from_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    close(got["Bar"].detach(), again(t(x)).logits["Bar"], dict(atol=0, rtol=0))
    cache = again.init_decoder_cache(2, 8)
    assert cache[0]["k"].device == next(again.parameters()).device


# ---- the train CLI on a shrunk recipes/performer.yaml ----


def test_train_entry_point_trains_performer_yaml(tmp_path):
    root = tmp_path / "data"
    build_synthetic_dataset(str(root), n_scores=2, n_perfs_per_score=2, n_bars=12, seed=3, with_directions=False,
                            splits=True)
    lines = [f"base: {REPO / 'recipes' / 'performer.yaml'}", "data:", "  dataset:", f"    root: {root}",
             "    max_seq_len: 30", "    bar_sliding_window: 4",
             "model:", "  transformer:", "    dim: 32", "    max_seq_len: 32", "    token_embeddings:",
             "      emb_dims: 16", "    transformer:", "      depth: 1", "      heads: 2", "      attention:",
             "        dim_head: 16",
             "trainer:", f"  output_dir: {tmp_path / 'run'}", "  epochs: 2", "  max_steps: 2", "  batch_size: 4",
             "  eval_batch_size: 4", "  num_workers: 1", "  log_steps: 1", "  save_strategy: 'no'",
             "  eval_strategy: 'no'", "  disable_progress: true", "  tensorboard: false"]
    (tmp_path / "performer_tiny.yaml").write_text("\n".join(lines) + "\n")
    ttrain.main(["-r", str(tmp_path), "-n", "performer_tiny.yaml", "--device", "cpu"])
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [log["train_step/loss"] for log in logs if "train_step/loss" in log]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = load_checkpoint(str(tmp_path / "run" / "checkpoint_last"))
    assert ckpt["trainer_state"]["global_step"] == 2 and ckpt["model_config"]["_name_"] == "Performer"
    model, _ = load_model_from_checkpoint(str(tmp_path / "run" / "checkpoint_last"), device="cpu")
    assert isinstance(model, tsp.PerformerModel)


def test_performer_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from scoreperformer_tpu_torch.models.factory import build_performer_config
    from scoreperformer_tpu_torch.training import ExperimentComponents

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_performer(performer_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.PerformerModel(build_performer_config(performer_config()))
    with pytest.raises(RuntimeError, match="CUDA"):
        ExperimentComponents.from_yaml(REPO / "recipes", "performer.yaml")
    # render_performance and the server stay ScorePerformer-only
    from scoreperformer_tpu_torch.inference import render_performance

    port, _ = build_performer(performer_config(), device="cpu")
    with pytest.raises(TypeError, match="ScorePerformer"):
        render_performance(port, None, None, device="cpu")

"""The port's direction classifiers against the JAX package's, on the CPU.

`weighted_cross_entropy` and `effective_class_weights` go through both
frameworks on the same numpy inputs; the linear, multi-head and GRU
classifiers on the same weights (a flax `init` carried over by
`scoreperformer_tpu_torch.convert`); one whole train step of a tiny
ScorePerformer with classifiers against `jax.value_and_grad`, with JAX's MMD
samples handed to the port (the harness of tests/test_torch_train.py).
Tolerances: the loss function 1e-6, modules 1e-5, the train step's loss 1e-5
and its gradients 1e-4.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.models import classifiers as jclf
from scoreperformer_tpu.models.factory import build_classifiers_config as jbuild_classifiers_config
from scoreperformer_tpu.models.scoreperformer import ScorePerformerModel as JScorePerformerModel
from scoreperformer_tpu.models.factory import build_scoreperformer_config as jbuild_scoreperformer_config

from scoreperformer_tpu_torch.convert import gru_cell_stack_state_from_jax, load_state_dict, state_dict_from_jax
from scoreperformer_tpu_torch.inference import load_model_from_checkpoint
from scoreperformer_tpu_torch.models import classifiers as tclf
from scoreperformer_tpu_torch.models.factory import build_classifiers_config, build_scoreperformer
from scoreperformer_tpu_torch.models.scoreperformer import ScorePerformerModel

from test_torch_train import GRAD_TOL, jax_step, port_batch, replay, train_batch, train_config

torch.set_num_threads(1)

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_models.py's classifiers: base.yaml's heads (no hidden layer,
# dropout 0.2, weighted classes, detached inputs) over two groups
CLASSIFIERS = {
    "num_classes": {"dynamics": 3, "tempo": 4},
    "classifier": {"hidden_dims": [], "dropout": 0.2},
    "weighted_classes": True,
    "detach_inputs": True,
    "class_samples": {"dynamics": [10, 5, 3], "tempo": [4, 4, 4, 4]},
}


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- the loss function and the class weights ----

CE_CASES = ["plain", "class_weights", "sample_weights", "both", "all_zero_weights", "pad_and_overflow_labels"]


@pytest.mark.parametrize("case", CE_CASES)
def test_weighted_cross_entropy_matches_jax(case):
    rng = np.random.RandomState(CE_CASES.index(case))
    logits = rand(1, 3, 7, 5) * 3
    labels = rng.randint(0, 5, (3, 7))
    class_weights = sample_weights = None
    if case in ("class_weights", "both", "all_zero_weights", "pad_and_overflow_labels"):
        class_weights = rng.rand(5).astype(np.float32) + 0.1
    if case in ("sample_weights", "both", "pad_and_overflow_labels"):
        sample_weights = (rng.rand(3, 7) < 0.6).astype(np.float32)
    if case == "all_zero_weights":
        sample_weights = np.zeros((3, 7), np.float32)
    if case == "pad_and_overflow_labels":
        labels[0, :3] = -100  # pads read class 0
        labels[1, 2] = 5  # one past the last class reads the last
    want = jclf.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), None if class_weights is None else jnp.asarray(class_weights),
        None if sample_weights is None else jnp.asarray(sample_weights))
    got = tclf.weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), None if class_weights is None else torch.from_numpy(
            class_weights), None if sample_weights is None else torch.from_numpy(sample_weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    if case == "all_zero_weights":
        assert got.item() == 0.0


@pytest.mark.parametrize("samples", [[10, 5, 3], [4, 4, 4, 4], [0, 1, 1000, 7], [0.25, 0.5, 0.25]])
def test_effective_class_weights_match_jax(samples):
    want = jclf.effective_class_weights(samples)
    got = tclf.effective_class_weights(samples)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the heads keep them in fp32, as the JAX heads' jnp.asarray of the floats
    head = tclf.LinearEmbeddingClassifier(4, len(samples), hidden_dims=(), class_weights=got)
    np.testing.assert_array_equal(head.class_weights.numpy(), np.asarray(jnp.asarray(tuple(want.tolist()))))


# ---- the heads against flax, on flax's weights ----


def head_state(group, params):
    """A flax head's parameters as the port head's state dict, through the
    model's name mapping (`classifiers.heads.<group>.layers.<i>`)."""
    sd = state_dict_from_jax({"classifiers": {f"head_{group}": params}})
    prefix = f"classifiers.heads.{group}."
    assert all(name.startswith(prefix) for name in sd)
    return {name[len(prefix):]: value for name, value in sd.items()}


@pytest.mark.parametrize("hidden_dims", [(), (32, 16)], ids=["no_hidden", "hidden_32_16"])
def test_linear_classifier_matches_flax(hidden_dims):
    x, labels = rand(2, 3, 9, 20), np.random.RandomState(3).randint(-1, 5, (3, 9))
    sample_weights = (np.random.RandomState(4).rand(3, 9) < 0.7).astype(np.float32)
    cw = tuple(jclf.effective_class_weights([7, 1, 3, 0, 12]).tolist())
    jhead = jclf.LinearEmbeddingClassifier(num_classes=5, hidden_dims=hidden_dims, dropout=0.2, class_weights=cw)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jhead.apply({"params": params}, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(sample_weights))
    head = tclf.LinearEmbeddingClassifier(20, 5, hidden_dims=hidden_dims, dropout=0.2,
                                          class_weights=jclf.effective_class_weights([7, 1, 3, 0, 12])).eval()
    head.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in head_state("g", params).items()})
    got = head(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(sample_weights))
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits), **MODULE_TOL)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **MODULE_TOL)


def multi_head_pair(hidden_dims, detach, input_dim=20):
    data = {**CLASSIFIERS, "classifier": {"hidden_dims": list(hidden_dims), "dropout": 0.2}, "detach_inputs": detach}
    jhead = jclf.MultiHeadEmbeddingClassifier(input_dim=input_dim, num_classes=data["num_classes"],
                                              config=jbuild_classifiers_config(data))
    x = rand(5, 2, 11, input_dim)
    params = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    port = tclf.MultiHeadEmbeddingClassifier(input_dim, data["num_classes"], build_classifiers_config(data)).eval()
    sd = state_dict_from_jax({"classifiers": params})
    port.load_state_dict({k[len("classifiers."):]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return jhead, params, port


@pytest.mark.parametrize("detach", [0.0, 0.5, 1.0], ids=["detach0", "detach0.5", "detach1"])
@pytest.mark.parametrize("hidden_dims", [(), (32, 16)], ids=["no_hidden", "hidden_32_16"])
def test_multi_head_classifier_matches_flax(hidden_dims, detach):
    jhead, params, port = multi_head_pair(hidden_dims, detach)
    x = rand(6, 2, 11, 20)
    rng = np.random.RandomState(7)
    labels = np.stack([rng.randint(0, 3, (2, 11)), rng.randint(0, 4, (2, 11))], -1)
    labels[1, 8:] = -100
    weights = np.ones((2, 11), np.float32)
    weights[1, 8:] = 0.0

    def jloss(e):
        out = jhead.apply({"params": params}, e, jnp.asarray(labels), jnp.asarray(weights))
        return out.loss, out

    (loss, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    e = torch.from_numpy(x).requires_grad_(True)
    got = port(e, torch.from_numpy(labels), torch.from_numpy(weights))
    got.loss.backward()
    assert list(got.logits) == ["dynamics", "tempo"]
    assert set(got.losses) == set(want.losses) == {"clf", "clf/dynamics", "clf/tempo"}
    for key in want.logits:
        np.testing.assert_allclose(got.logits[key].detach().numpy(), np.asarray(want.logits[key]), **MODULE_TOL)
    for key in want.losses:
        np.testing.assert_allclose(got.losses[key].item(), float(want.losses[key]), err_msg=key, **MODULE_TOL)
    np.testing.assert_allclose(got.loss.item(), float(loss), **MODULE_TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jgrad), **MODULE_TOL)
    if detach == 1.0:
        assert not e.grad.any()
    else:
        assert e.grad.abs().max() > 0


def test_multi_head_classifier_without_labels():
    jhead, params, port = multi_head_pair((), True)
    x = rand(8, 2, 5, 20)
    want = jhead.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert got.loss is None and got.losses is None and want.loss is None
    for key in want.logits:
        np.testing.assert_allclose(got.logits[key].detach().numpy(), np.asarray(want.logits[key]), **MODULE_TOL)


def test_gru_cell_stack_matches_flax():
    """tests/test_misc_components.py's case: 16 hidden units, 5 classes."""
    x = np.random.RandomState(0).randn(3, 7, 8).astype(np.float32)
    labels = np.array([0, 2, 4])
    jm = jclf.GRUCellStack(hidden_dim=16, num_classes=5)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(labels))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(labels))
    port = tclf.GRUCellStack(8, 16, 5)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in gru_cell_stack_state_from_jax(
        jax.device_get(variables["params"])).items()})
    got = port(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.logits.shape == (3, 5)
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits), **MODULE_TOL)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **MODULE_TOL)


def test_classifier_dropout_follows_the_generator_in_train_mode_only():
    from scoreperformer_tpu_torch.models.dropout import dropout_generator

    data = {**CLASSIFIERS, "classifier": {"hidden_dims": [8], "dropout": 0.5}}
    port = tclf.MultiHeadEmbeddingClassifier(20, data["num_classes"], build_classifiers_config(data))
    x = torch.from_numpy(rand(9, 2, 11, 20))

    def logits(seed):
        with dropout_generator(torch.Generator().manual_seed(seed)):
            return port(x).logits["tempo"]

    port.train()
    a, a2, b = logits(0), logits(0), logits(1)
    assert torch.equal(a, a2) and not torch.allclose(a, b)
    port.eval()
    c, d = logits(0), logits(1)
    assert torch.equal(c, d) and not torch.allclose(a, c)
    with torch.no_grad():
        plain = port.heads["tempo"].layers(x)
    assert torch.equal(c, plain)


# ---- the model with classifiers ----


def classifier_config(use_flash=False):
    cfg = train_config(use_flash)
    cfg["classifiers"] = json.loads(json.dumps(CLASSIFIERS))
    return cfg


def classifier_batch():
    """tests/test_torch_train.py's batch with direction labels (class 0 on
    most notes) and its deadpan first row, whose notes the loss ignores."""
    batch = train_batch()
    rng = np.random.RandomState(12)
    b, t = batch["perf_mask"].shape
    directions = np.stack([rng.randint(0, 3, (b, t)), rng.randint(0, 4, (b, t))], -1)
    directions[rng.rand(b, t, 2) < 0.4] = 0
    directions[~batch["perf_mask"]] = -100
    assert batch["deadpan_mask"].tolist() == [True, False]
    return {**batch, "directions": directions}


def build_classifier_pair(cfg, batch):
    """(JAX model, JAX variables, port model on the CPU) with the same
    weights; the JAX init sees `directions`, so its heads have parameters."""
    model = JScorePerformerModel(config=jbuild_scoreperformer_config(cfg))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "latent_dropout": jax.random.PRNGKey(2), "mmd": jax.random.PRNGKey(3)}
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, j: model.init(r, **j))(rngs, j)
    port, _ = build_scoreperformer(cfg, device="cpu", seed=0)
    load_state_dict(port, state_dict_from_jax(jax.device_get(variables["params"])))
    return model, variables, port.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["xla_attention", "flash_attention"])
def classifier_pair(request):
    batch = classifier_batch()
    model, variables, port = build_classifier_pair(classifier_config(request.param), batch)
    return model, variables, port, batch


def test_train_step_with_classifiers_matches_jax(classifier_pair, monkeypatch):
    model, variables, port, batch = classifier_pair
    assert "classifiers" in variables["params"]
    loss, losses, grads, draws = jax_step(model, variables["params"], batch, monkeypatch)
    assert {"clf", "clf/dynamics", "clf/tempo"} <= set(losses)
    port.zero_grad()
    out = port(**port_batch(batch), mmd_sampler=replay(draws))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(loss), atol=1e-5, rtol=1e-5)
    assert set(out.losses) == set(losses)
    for key, value in losses.items():
        np.testing.assert_allclose(out.losses[key].item(), float(value), atol=1e-5, rtol=1e-5, err_msg=key)
    params = dict(port.named_parameters(remove_duplicate=False))
    names = state_dict_from_jax(jax.device_get(grads))
    assert len(names) == len({id(p) for p in params.values()})
    assert sum(name.startswith("classifiers.") for name in names) == 4
    for name, want in names.items():
        got = params[name.replace("proj|0", "proj")].grad
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **GRAD_TOL)
    # detached inputs: the classifier loss alone reaches no encoder weight
    port.zero_grad()
    out = port(**port_batch(batch), mmd_sampler=replay(draws))
    out.losses["clf"].backward()
    reached = {n for n, p in port.named_parameters() if p.grad is not None and p.grad.any()}
    assert reached and all(n.startswith("classifiers.") for n in reached)


def test_classifier_logits_and_deadpan_weights(classifier_pair):
    """The logits ride on the output; a deadpan row weighs nothing: changing
    its labels leaves the loss as it was."""
    _, _, port, batch = classifier_pair
    with torch.no_grad():
        out = port(**port_batch(batch), compute_loss=False)
        other = dict(batch, directions=batch["directions"].copy())
        other["directions"][0] = (other["directions"][0] + 1) % 3
        out2 = port(**port_batch(other), compute_loss=False)
    assert out.classifiers.logits["dynamics"].shape == (2, 12, 3)
    assert out.classifiers.logits["tempo"].shape == (2, 12, 4)
    assert out.loss is not None and out.losses["clf"].item() == out2.losses["clf"].item()


def test_classifier_weights_load_from_jax_and_from_a_reference_checkpoint(classifier_pair, tmp_path):
    """Every classifier parameter loads from the JAX tree and from a
    reference-layout state dict (a single-file `.pt`), none missing or
    unused; a name the model lacks is refused, not skipped."""
    _, variables, port, _ = classifier_pair
    sd = state_dict_from_jax(jax.device_get(variables["params"]))
    clf_names = sorted(n for n in sd if n.startswith("classifiers."))
    assert clf_names == ["classifiers.heads.dynamics.layers.0.bias", "classifiers.heads.dynamics.layers.0.weight",
                         "classifiers.heads.tempo.layers.0.bias", "classifiers.heads.tempo.layers.0.weight"]
    own = port.state_dict()
    for name in clf_names:
        np.testing.assert_array_equal(own[name].numpy(), sd[name])
    cfg = classifier_config()
    path = tmp_path / "reference.pt"
    torch.save({"model": {"config": {"_name_": "ScorePerformer", **cfg},
                          "state_dict": {k.replace("proj|0", "proj"): torch.from_numpy(np.array(v))
                                         for k, v in sd.items()}}}, path)
    loaded, _ = load_model_from_checkpoint(str(path), device="cpu")
    assert loaded.classifiers is not None
    got = loaded.state_dict()
    assert set(got) == set(own)
    for name, value in own.items():
        assert torch.equal(got[name], value), name
    fresh = ScorePerformerModel(port.config, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        load_state_dict(fresh, {**sd, "classifiers.heads.extra.layers.0.weight": np.zeros((3, 20), np.float32)})
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(fresh, {k: v for k, v in sd.items() if k != clf_names[0]})


def test_hidden_layer_heads_map_their_output_layer():
    """With hidden layers, a head's output Linear follows each hidden Linear
    and ReLU: index 2 x (hidden layers), in the JAX tree's mapping too."""
    data = {**CLASSIFIERS, "classifier": {"hidden_dims": [32, 16], "dropout": 0.0}}
    port = tclf.MultiHeadEmbeddingClassifier(20, data["num_classes"], build_classifiers_config(data))
    _, params, _ = multi_head_pair((32, 16), 1.0)
    sd = state_dict_from_jax({"classifiers": params})
    assert {k[len("classifiers."):] for k in sd} == set(port.state_dict())
    assert "classifiers.heads.tempo.layers.4.weight" in sd

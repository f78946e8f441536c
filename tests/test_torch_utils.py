"""The port's copies of utils/plots.py and utils/playback.py, and its
`TupleTokenEmbeddingHead` and `fixed_positional_embedding`, against the JAX
package's, on the CPU.

The copies are the JAX files verbatim under a one-line origin header
(tests/test_torch_copies.py holds every copy of the port to its source);
`cut_midi` and the pianoroll give the JAX functions' results on a synthetic
score, both plots draw (matplotlib's Agg backend), and `midi_to_audio`
raises the same ImportError without note_seq. The two modules equal flax's
to 1e-5, the head's input gradient too.
"""

import matplotlib
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scoreperformer_tpu.data.synthetic import synthetic_score as jax_synthetic_score
from scoreperformer_tpu.models.embeddings import TupleTokenEmbeddingHead as JaxEmbeddingHead
from scoreperformer_tpu.models.layers import fixed_positional_embedding as jax_fixed_positional_embedding
from scoreperformer_tpu.utils import playback as jax_playback
from scoreperformer_tpu.utils import plots as jax_plots

from scoreperformer_tpu_torch.data import synthetic_score
from scoreperformer_tpu_torch.models.embeddings import TupleTokenEmbeddingHead
from scoreperformer_tpu_torch.models.layers import fixed_positional_embedding
from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig
from scoreperformer_tpu_torch.utils import playback, plots

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def scores():
    return synthetic_score(np.random.RandomState(4), n_bars=8), jax_synthetic_score(np.random.RandomState(4), n_bars=8)


@pytest.mark.parametrize("window,cut_end", [((0, 10**9), True), ((960, 4800), True), ((960, 4800), False)])
def test_cut_midi_matches_jax(scores, tmp_path, window, cut_end):
    port_score, jax_score = scores
    got = playback.cut_midi(port_score, *window, cut_end_tick=cut_end, save_path=str(tmp_path / "cut.mid"))
    want = jax_playback.cut_midi(jax_score, *window, cut_end_tick=cut_end)
    for g, w in zip(got.tracks, want.tracks):
        for field in ("pitch", "velocity", "start", "end"):
            np.testing.assert_array_equal(getattr(g.notes, field), getattr(w.notes, field))
    np.testing.assert_array_equal(got.tempos.time, want.tempos.time)
    np.testing.assert_array_equal(got.tempos.tempo, want.tempos.tempo)
    assert got.max_tick == want.max_tick and (tmp_path / "cut.mid").exists()
    assert got.tracks[0].notes.start.min() >= 0


def test_midi_to_audio_needs_note_seq(tmp_path):
    for module in (playback, jax_playback):
        with pytest.raises(ImportError, match="note_seq"):
            module.midi_to_audio(str(tmp_path / "missing.mid"), play=False)


def test_pianoroll_and_plots(scores):
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    port_score, jax_score = scores
    roll = plots.midi_to_pianoroll(port_score, fs=50)
    np.testing.assert_array_equal(roll, jax_plots.midi_to_pianoroll(jax_score, fs=50))
    assert roll.max() > 0
    fig, ax = plots.plot_pianoroll(port_score)
    assert ax.images
    plt.close(fig)
    tok = SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 32}))
    ids = tok.score_tokens_as_performance(tok.score_midi_to_tokens(port_score).ids).ids
    fig = plots.plot_performance_parameter(tok, ids, ids, token_type="Velocity")
    assert len(fig.axes) == 2
    plt.close(fig)


@pytest.mark.parametrize("depth,hidden_dim,detach", [(1, None, 1.0), (2, None, 0.5), (3, 24, 0.0)])
def test_embedding_head_matches_flax(depth, hidden_dim, detach):
    x = np.random.RandomState(depth).randn(2, 5, 16).astype(np.float32)
    jhead = JaxEmbeddingHead(emb_dim=12, hidden_dim=hidden_dim, depth=depth, detach_inputs=detach)
    params = jax.device_get(jhead.init(jax.random.PRNGKey(depth), jnp.asarray(x))["params"])
    head = TupleTokenEmbeddingHead(16, 12, hidden_dim=hidden_dim, depth=depth, detach_inputs=detach)
    assert len(head.layers) == len(params) == depth
    with torch.no_grad():
        for i, layer in enumerate(head.layers):
            layer.weight.copy_(torch.from_numpy(np.asarray(params[f"layer_{i}"]["kernel"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(np.array(params[f"layer_{i}"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    out = head(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jhead.apply({"params": params}, jnp.asarray(x))), **TOL)
    out.sum().backward()
    want = jax.grad(lambda v: jhead.apply({"params": params}, v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    assert (xt.grad.abs().max().item() == 0.0) == (detach == 1.0)


@pytest.mark.parametrize("dim", [8, 64])
def test_fixed_positional_embedding_matches_jax(dim):
    pos = np.arange(0, 36 * 7, 7).reshape(3, 12)
    got = fixed_positional_embedding(dim, torch.as_tensor(pos))
    want = np.asarray(jax_fixed_positional_embedding(dim, jnp.asarray(pos)))
    assert got.shape == want.shape == (3, 12, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)

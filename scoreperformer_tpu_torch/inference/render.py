"""End-to-end performance rendering: score MIDI -> expressive performance MIDI.

Counterpart of scoreperformer_tpu/inference/render.py: tokenize the score,
build a masked deadpan performance, run the encoders for context and style,
unmask the performance streams with the MixedLM decode loop, detokenize.
Runs on the GPU unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..convert import load_state_dict
from ..device import resolve_device
from ..midi import MidiScore
from ..models.factory import build_scoreperformer
from ..models.wrappers import mixedlm_unmask
from ..ops.sampling import top_k
from ..tokenizers import MASK, TokSequence
from ..training.checkpoint import load_checkpoint


def load_model_from_checkpoint(path: str, device="cuda"):
    """Rebuild the model from a checkpoint: the port trainer's directory
    (`params.pt` with the weights, `meta.json` with "model_config"), or a
    reference single-file checkpoint (`.pt`, {"model": {"config",
    "state_dict"}}) whose embedded config is the post-injection recipe node.
    Returns (model, config), the direction classifiers' heads included when
    the config sets them."""
    device = resolve_device(device)
    if os.path.isdir(path):
        ckpt = load_checkpoint(path)
        if "params" not in ckpt or not ckpt.get("model_config"):
            raise ValueError(f"{path}: a checkpoint directory needs params.pt and meta.json's model_config")
        model_node = {"config": ckpt["model_config"], "state_dict": ckpt["params"]}
    elif os.path.isfile(path):
        model_node = torch.load(path, map_location="cpu", weights_only=False).get("model") or {}
    else:
        raise FileNotFoundError(f"{path}: no checkpoint directory or file")
    model_cfg = model_node.get("config")
    if model_cfg is None:
        raise ValueError(f"{path} carries no embedded model config")
    name = model_cfg.get("_name_", "ScorePerformer")
    if name != "ScorePerformer":
        raise NotImplementedError(f"model {name!r} is not ported yet")
    data = {k: v for k, v in model_cfg.items() if not k.startswith("_")}
    model, cfg = build_scoreperformer(data, device=device)
    load_state_dict(model, model_node["state_dict"])
    return model.eval(), cfg


# ---- copied from scoreperformer_tpu/inference/render.py ----


PERF_STREAMS = ("Velocity", "Tempo", "RelOnsetDev", "RelPerfDuration")


def prepare_render_inputs(tokenizer, score_midi: MidiScore) -> Dict[str, np.ndarray]:
    """Host-side render preamble: score tokens, deadpan performance, segment
    maps, and the two masked decoder input streams (dataset counterpart:
    score_performance.py:186-191). Shared by `render_performance` and the
    serving layer."""
    score_seq = tokenizer.score_midi_to_tokens(score_midi)
    deadpan = tokenizer.score_tokens_as_performance(score_seq)

    ticks_data = tokenizer.compute_ticks(score_seq.ids, compute_beat_ticks=True)
    z = tokenizer.zero_token
    bars = score_seq.ids[:, 0] - z
    beats = np.searchsorted(ticks_data["beat"], ticks_data["note_on"], side="right") - 1
    unique_onsets, onset_counts = np.unique(ticks_data["note_on"], return_counts=True)
    onsets = np.arange(len(unique_onsets)).repeat(onset_counts)
    bars, beats, onsets = (s - s[0] + z for s in (bars, beats, onsets))

    mask_dims = [tokenizer.types_idx[k] for k in PERF_STREAMS if k in tokenizer.types_idx]
    tokens = np.asarray(deadpan.ids).copy()
    masked_all = tokens.copy()
    masked_all[:, mask_dims] = MASK
    tokens_in = tokens.copy()
    tokens_in[1:, mask_dims] = MASK  # first note anchors the rendition

    return {
        "score_ids": np.asarray(score_seq.ids),
        "deadpan_ids": np.asarray(deadpan.ids),
        "tokens_in": tokens_in,
        "masked_all": masked_all,
        "bars": np.asarray(bars),
        "beats": np.asarray(beats),
        "onsets": np.asarray(onsets),
        # static: the decode only fills these streams (mixedlm_unmask
        # sample_dims skips the other streams' discarded filters)
        "mask_dims": tuple(int(d) for d in mask_dims),
    }


def render_performance(
    model,
    tokenizer,
    score_midi: MidiScore,
    seed: int = 0,
    temperature: float = 1.0,
    greedy: bool = False,
    filter_kwargs: Optional[Dict] = None,
    style_embeddings: Optional[np.ndarray] = None,
    output_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> MidiScore:
    """Render a score into an expressive performance with `model`, which
    must live on `device`. Style defaults to the encoders' embedding of the
    deadpan performance; pass `style_embeddings` (T, dim) to steer. Sampling
    draws from a generator seeded with `seed`."""
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"the model lives on {param_device}, the render runs on {device}")
    inputs = prepare_render_inputs(tokenizer, score_midi)
    T = len(inputs["deadpan_ids"])

    def batch(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype, device=device)

    with torch.inference_mode():
        mask = torch.ones(1, T, dtype=torch.bool, device=device)
        score_emb, style_emb, _ = model.encode_embeddings(
            batch(inputs["deadpan_ids"]), mask, batch(inputs["score_ids"]), mask,
            batch(inputs["bars"]), batch(inputs["beats"]), batch(inputs["onsets"]),
        )
        if style_embeddings is not None:
            style_emb = batch(style_embeddings, torch.float32)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        out = mixedlm_unmask(
            model, batch(inputs["tokens_in"]), batch(inputs["masked_all"]), generator=generator,
            style_embeddings=style_emb, context=score_emb, temperature=temperature,
            filter_fn=top_k, filter_kwargs=filter_kwargs, greedy=greedy,
            sample_dims=inputs["mask_dims"],
        )
    out_tokens = out[0].cpu().numpy()
    return tokenizer.performance_tokens_to_midi(TokSequence(ids=out_tokens), output_path=output_path)

"""Weights into the port: JAX parameter trees and reference state dicts.

The port's modules carry the reference PyTorch parameter names. A JAX
parameter tree (nested dicts of numpy arrays) becomes a state dict by the
name mapping of scoreperformer_tpu/training/torch_convert.py, of which this
module keeps its own copy (`_torch_name_for` and helpers, copied verbatim);
Dense kernels are transposed to torch's (out, in). A reference `.pt` state
dict already has these names and loads through the same `load_state_dict`.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# ---- name mapping, copied from scoreperformer_tpu/training/torch_convert.py ----


def _torch_name_for(path: List[str]) -> Optional[Tuple[str, str]]:
    """flax param path → (torch state_dict name, transform).

    transform ∈ {"t" (transpose 2D), "id"}. Returns None when the parameter
    has no reference counterpart (should not happen for converted models).
    """
    parts = list(path)

    # --- submodel prefix ---
    prefix = ""
    if parts[0].startswith("shared_emb_"):
        key = parts[0][len("shared_emb_"):]
        return _embedding_leaf(f"perf_decoder.model.token_emb.embs.{key}", parts[1:])
    if parts[0] == "score_encoder":
        prefix = "score_encoder."
        parts = parts[1:]
    elif parts[0] == "perf_encoder":
        prefix = "perf_encoder."
        parts = parts[1:]
        if parts and parts[0] == "transformer":
            # MMD inherits TupleTransformer in the reference: unwrap one level
            parts = parts[1:]
        if parts and parts[0].startswith("vae_"):
            mode = parts[0][len("vae_"):]
            # MMDVAE.linear
            return (f"{prefix}vae_head.{mode}.linear.{_wb(parts[-1])}", "t" if parts[-1] == "kernel" else "id")
    elif parts[0] == "perf_decoder":
        prefix = "perf_decoder.model."
        parts = parts[1:]
    elif parts[0] == "classifiers":
        # classifiers.head_<G>.(layer_{i}|out).(kernel|bias)
        group = parts[1][len("head_"):]
        layer = parts[2]
        leaf = parts[3]
        if layer == "out":
            idx = "last"
        else:
            idx = int(layer[len("layer_"):]) * 2
        name = f"classifiers.heads.{group}.layers.{{{idx}}}.{_wb(leaf)}"
        return (name, "t" if leaf == "kernel" else "id")
    elif parts[0] == "transformer" and len(parts) > 1 and parts[1] in (
        "token_emb", "pos_emb", "emb_norm", "project_emb", "transformer", "final_norm", "lm_head",
    ):
        # Performer: PerformerModel.transformer → reference transformer.model.*
        prefix = "transformer.model."
        parts = parts[1:]

    return _tuple_transformer_leaf(prefix, parts)


def _wb(leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)


def _embedding_leaf(base: str, parts: List[str]) -> Tuple[str, str]:
    """StreamEmbedding params → Discrete(Dense)ContinuousEmbedding names."""
    leaf = parts[-1]
    if parts[0] == "index_weight":
        return (f"{base}.index_weight", "id")
    if parts[0] == "value":  # simple continuous: Linear(1, D, bias=False)
        return (f"{base}.value_layer.{_wb(leaf)}", "t" if leaf == "kernel" else "id")
    m = re.fullmatch(r"value_(\d+)", parts[0])
    if m:  # dense: value_layer.<i>.0 Linear
        return (
            f"{base}.value_layer.{m.group(1)}.0.{_wb(leaf)}",
            "t" if leaf == "kernel" else "id",
        )
    raise KeyError(f"unknown embedding leaf {parts}")


def _tuple_transformer_leaf(prefix: str, parts: List[str]) -> Optional[Tuple[str, str]]:
    leaf = parts[-1]
    head = parts[0]

    if head == "token_emb":
        sub = parts[1]
        if sub.startswith("emb_"):
            key = sub[len("emb_"):]
            return _embedding_leaf(f"{prefix}token_emb.embs.{key}", parts[2:])
        if sub == "norm":
            return (f"{prefix}token_emb.norm.{_wb(leaf)}", "id")
        if sub == "project_kernel":
            return (f"{prefix}token_emb.project_emb.weight", "t")
        if sub == "project_bias":
            return (f"{prefix}token_emb.project_emb.bias", "id")
        if sub == "project_multiemb":
            return (
                f"{prefix}token_emb.project_multiemb.{_wb(leaf)}",
                "t" if leaf == "kernel" else "id",
            )
    if head == "pos_emb":
        return (f"{prefix}pos_emb.emb.weight", "id")
    if head == "emb_norm":
        return (f"{prefix}emb_norm.{_wb(leaf)}", "id")
    if head == "project_emb":
        return (f"{prefix}project_emb.{_wb(leaf)}", "t" if leaf == "kernel" else "id")
    if head == "lm_head":
        sub = parts[1]
        if sub == "norm":
            return (f"{prefix}lm_head.norm.{_wb(leaf)}", "id")
        if sub == "project":  # non-reused projection
            return (f"{prefix}lm_head.project_emb.weight", "t")
        if sub.startswith("head_"):
            key = sub[len("head_"):]
            return (f"{prefix}lm_head.heads.{key}.{_wb(leaf)}", "t" if leaf == "kernel" else "id")
        if sub.startswith("to_emb_"):
            key = sub[len("to_emb_"):]
            return (f"{prefix}lm_head.to_embs.{key}.0.{_wb(leaf)}", "t" if leaf == "kernel" else "id")
        if sub.startswith("norm_"):
            key = sub[len("norm_"):]
            return (f"{prefix}lm_head.to_embs.{key}.1.{_wb(leaf)}", "id")
    if head == "transformer":
        sub = parts[1]
        m = re.fullmatch(r"layer_(\d+)_(attn|cross|ff|norm)", sub)
        if m:
            idx, kind = int(m.group(1)), m.group(2)
            if kind in ("attn", "cross"):
                inner = parts[2]
                if inner == "rel_pos":
                    return (f"{prefix}transformer.layers.{idx}.1.rel_pos.learned_logslopes", "id")
                return (
                    f"{prefix}transformer.layers.{idx}.1.{inner}.weight",
                    "t",
                )
            if kind == "ff":
                inner = parts[2]
                if inner == "proj_in":
                    # GLU: ff.0.proj; plain: ff.0.0
                    return (
                        f"{prefix}transformer.layers.{idx}.1.ff.0.proj|0.{_wb(leaf)}",
                        "t" if leaf == "kernel" else "id",
                    )
                if inner == "proj_out":
                    return (
                        f"{prefix}transformer.layers.{idx}.1.ff.3.{_wb(leaf)}",
                        "t" if leaf == "kernel" else "id",
                    )
                if inner == "post_act_norm":
                    return (f"{prefix}transformer.layers.{idx}.1.ff.1.{_wb(leaf)}", "id")
            if kind == "norm":
                inner = parts[2] if len(parts) > 2 else None
                if inner == "to_gamma_beta":
                    return (
                        f"{prefix}transformer.layers.{idx}.0.0.linear.{_wb(leaf)}",
                        "t" if leaf == "kernel" else "id",
                    )
                return (f"{prefix}transformer.layers.{idx}.0.0.{_wb(leaf)}", "id")
        if sub == "final_norm":
            inner = parts[2] if len(parts) > 2 else None
            if inner == "to_gamma_beta":
                return (
                    f"{prefix}transformer.final_norm.linear.{_wb(leaf)}",
                    "t" if leaf == "kernel" else "id",
                )
            return (f"{prefix}transformer.final_norm.{_wb(leaf)}", "id")
    return None


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


# ---- the port's side ----

# weights of modules the port does not have yet; skipped on load
SKIPPED_PREFIXES = ("classifiers.",)


def state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """JAX (flax) parameter tree -> reference-named state dict of numpy arrays.
    A name may hold one `a|b` alternative (the GLU and the plain feed-forward
    name their input projection differently); `load_state_dict` resolves it."""
    sd: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        mapped = _torch_name_for(list(path))
        if mapped is None:
            raise KeyError(f"no reference name for {'.'.join(path)}")
        name, transform = mapped
        name = name.replace("{last}", "0").replace("{", "").replace("}", "")
        arr = np.asarray(value)
        sd[name] = arr.T if transform == "t" and arr.ndim == 2 else arr
    return sd


def _expand(name: str) -> List[str]:
    m = re.search(r"([^.]+)\|([^.]+)", name)
    if m is None:
        return [name]
    return [name[: m.start()] + alt + name[m.end():] for alt in m.groups()]


def load_state_dict(model: nn.Module, state_dict: Dict[str, object], strict: bool = True) -> List[str]:
    """Copy `state_dict` (numpy arrays or tensors, reference names) into
    `model` in place. A tied parameter registered under several names is
    filled from whichever of them the dict holds. With `strict`, every
    parameter must be filled and every name used, except the weights of
    modules the port does not have (SKIPPED_PREFIXES). Returns the skipped names."""
    own = model.state_dict(keep_vars=True)
    given = {}
    for name, value in state_dict.items():
        for cand in _expand(name):
            if cand in own:
                given[cand] = value
                break
        else:
            given[name] = value
    names_of: Dict[int, List[str]] = {}
    for name, tensor in own.items():
        names_of.setdefault(id(tensor), []).append(name)
    missing = []
    with torch.no_grad():
        for names in names_of.values():
            hit = next((n for n in names if n in given), None)
            if hit is None:
                missing.append(names[0])
                continue
            target = own[hit]
            value = given[hit] if isinstance(given[hit], torch.Tensor) else torch.from_numpy(np.array(given[hit]))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {hit}: given {tuple(value.shape)}, model {tuple(target.shape)}")
            target.copy_(value.to(target.dtype))
    skipped = [n for n in given if n not in own and n.startswith(SKIPPED_PREFIXES)]
    unexpected = [n for n in given if n not in own and not n.startswith(SKIPPED_PREFIXES)]
    if strict and (missing or unexpected):
        raise KeyError(f"missing {missing[:5]} ({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")
    return skipped

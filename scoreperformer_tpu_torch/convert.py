"""Weights into the port: JAX parameter trees and reference state dicts.

The port's modules carry the reference PyTorch parameter names. A JAX
parameter tree (nested dicts of numpy arrays) becomes a state dict by the
name mapping of scoreperformer_tpu/training/torch_convert.py, of which this
module keeps its own copy (`_torch_name_for` and helpers, copied verbatim,
plus the regression head's and the MoE layers' names, which the JAX
converter lacks: an MoE layer's `router`, `wi`, `wo`, `bi`, `bo` keep flax's
names and layouts under the layer's block, `transformer.layers.<i>.1.wi`); Dense
kernels are transposed to torch's (out, in). A reference `.pt` state
dict already has these names and loads through the same `load_state_dict`.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# ---- name mapping, copied from scoreperformer_tpu/training/torch_convert.py ----

MOE_PARAMS = ("router", "wi", "wo", "bi", "bo")  # models/moe.py's, in flax's layouts


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
        "regression_head",
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
    if head == "regression_head":  # the port's own: the JAX converter names no regression head
        key = parts[1][len("reg_"):]
        return (f"{prefix}regression_head.heads.{key}.{_wb(leaf)}", "t" if leaf == "kernel" else "id")
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
                if inner in MOE_PARAMS:  # the port's own: the JAX converter names no MoE layer
                    return (f"{prefix}transformer.layers.{idx}.1.{inner}", "id")
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

def state_dict_from_jax(params) -> Dict[str, np.ndarray]:
    """JAX (flax) parameter tree -> reference-named state dict of numpy arrays.
    A name may hold one `a|b` alternative (the GLU and the plain feed-forward
    name their input projection differently); `load_state_dict` resolves it.
    A classifier head's output layer (`{last}`) follows its hidden layers: a
    Linear and a ReLU each, so index 2 x (number of hidden layers)."""
    mapped_all = []
    for path, value in _flatten(params).items():
        mapped = _torch_name_for(list(path))
        if mapped is None:
            raise KeyError(f"no reference name for {'.'.join(path)}")
        mapped_all.append((path, mapped, value))
    hidden: Dict[str, int] = {}  # classifier head -> its hidden layers
    for path, _, _ in mapped_all:
        if path[0] == "classifiers" and path[2].startswith("layer_"):
            hidden[path[1]] = max(hidden.get(path[1], 0), int(path[2][len("layer_"):]) + 1)
    sd: Dict[str, np.ndarray] = {}
    for path, (name, transform), value in mapped_all:
        if "{last}" in name:
            name = name.replace("{last}", str(2 * hidden.get(path[1], 0)))
        name = name.replace("{", "").replace("}", "")
        arr = np.asarray(value)
        sd[name] = arr.T if transform == "t" and arr.ndim == 2 else arr
    return sd


def jax_path_for(model: nn.Module, name: str) -> Tuple[str, ...]:
    """The reverse of `_torch_name_for`: the flax parameter path of the port
    parameter `name` of a `ScorePerformerModel` or a `PerformerModel` (a tied
    embedding's path is its `shared_emb_<key>` one, whichever of its names is
    given). Raises
    KeyError for a name with no JAX counterpart. The result maps back to
    `name` through `_torch_name_for`."""
    parts = name.split(".")
    leaf = parts[-1]
    owner = model.get_submodule(".".join(parts[:-1]))
    jleaf = {"weight": "scale" if isinstance(owner, nn.LayerNorm) else "kernel"}.get(leaf, leaf)
    path = _jax_path(model, parts, leaf, jleaf)
    mapped = _torch_name_for(list(path))
    if mapped is None or not _same_name(model, mapped[0], name):
        raise KeyError(f"no JAX path for {name} (tried {'/'.join(path)})")
    return path


def _same_name(model: nn.Module, mapped: str, name: str) -> bool:
    """`mapped` (one of `_torch_name_for`'s names, with its `a|b` and
    classifier `{i}` forms) names the same parameter as `name`."""
    params = dict(model.named_parameters(remove_duplicate=False))
    if "{last}" in mapped:
        mapped = mapped.replace("{last}", name.split(".")[4])
    mapped = mapped.replace("{", "").replace("}", "")
    hits = [params[c] for c in _expand(mapped) if c in params]
    return bool(hits) and hits[0] is params[name]


def _jax_path(model, parts, leaf, jleaf) -> Tuple[str, ...]:
    top = parts[0]
    if top == "classifiers":  # classifiers.heads.<group>.layers.<i>.<leaf>
        n_layers = len(model.get_submodule(".".join(parts[:4])))
        i = int(parts[4])
        return ("classifiers", f"head_{parts[2]}", "out" if i == n_layers - 1 else f"layer_{i // 2}", jleaf)
    if top == "perf_encoder" and parts[1] == "vae_head":
        return ("perf_encoder", f"vae_{parts[2]}", "linear", jleaf)
    prefix, rest = {
        "score_encoder": (("score_encoder",), parts[1:]),
        "perf_encoder": (("perf_encoder", "transformer"), parts[1:]),
        "perf_decoder": (("perf_decoder",), parts[2:]),  # perf_decoder.model.*
        "transformer": (("transformer",), parts[2:]),  # a Performer's transformer.model.*
    }.get(top, ((), None))
    if rest is None:
        raise KeyError(f"no JAX path for {'.'.join(parts)}")
    head = rest[0]
    if head == "token_emb":
        sub = rest[1]
        if sub == "embs":
            key, tail = rest[2], rest[3:]
            tied = getattr(getattr(model, "config", None), "tie_token_emb", False)
            base = (f"shared_emb_{key}",) if tied else prefix + ("token_emb", f"emb_{key}")
            if tail[0] == "index_weight":
                return base + ("index_weight",)
            return base + (("value",) if len(tail) == 2 else (f"value_{tail[1]}",)) + (jleaf,)
        if sub == "project_emb":
            return prefix + ("token_emb", "project_kernel" if leaf == "weight" else "project_bias")
        return prefix + ("token_emb", sub, jleaf)  # norm, project_multiemb
    if head == "pos_emb":
        return prefix + ("pos_emb", "emb")
    if head in ("emb_norm", "project_emb"):
        return prefix + (head, jleaf)
    if head == "lm_head":
        if rest[1] == "heads":  # untied: heads.<key>
            return prefix + ("lm_head", f"head_{rest[2]}", jleaf)
        if rest[1] == "to_embs":  # tied split: to_embs.<key>.<0: Linear | 1: LayerNorm>
            return prefix + ("lm_head", f"{'to_emb' if rest[3] == '0' else 'norm'}_{rest[2]}", jleaf)
        if rest[1] == "project_emb":  # tied without reuse_projection
            return prefix + ("lm_head", "project", jleaf)
        return prefix + ("lm_head", rest[1], jleaf)
    if head == "regression_head":
        return prefix + ("regression_head", f"reg_{rest[2]}", jleaf)
    if head == "transformer":
        if rest[1] == "final_norm":
            return prefix + ("transformer", "final_norm") + (("to_gamma_beta",) if rest[2] == "linear" else ()) + (jleaf,)
        i, part = int(rest[2]), rest[3]  # transformer.layers.<i>.<0: norm | 1: block>
        stack = model.get_submodule(".".join(parts[: len(parts) - len(rest) + 1]))
        if part == "0":
            return prefix + ("transformer", f"layer_{i}_norm") + (("to_gamma_beta",) if rest[5] == "linear" else ()) + (jleaf,)
        kind = {"a": "attn", "c": "cross", "f": "ff"}[stack.layer_types[i]]
        inner = rest[4]
        if kind == "ff" and inner in MOE_PARAMS:
            return prefix + ("transformer", f"layer_{i}_ff", inner)
        if kind == "ff":
            return prefix + ("transformer", f"layer_{i}_ff", "proj_in" if rest[5] == "0" else
                             "post_act_norm" if rest[5] == "1" else "proj_out", jleaf)
        if inner == "rel_pos":
            return prefix + ("transformer", f"layer_{i}_{kind}", "rel_pos", leaf)
        return prefix + ("transformer", f"layer_{i}_{kind}", inner, jleaf)
    raise KeyError(f"no JAX path for {'.'.join(parts)}")


def jax_param_paths(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """{port parameter name: (flax path, transposed)} for every parameter of
    `model` (tied ones once, under their first name); `transposed`: the JAX
    array is the port's transposed (a Dense kernel)."""
    out = {}
    for name, _ in model.named_parameters():
        path = jax_path_for(model, name)
        out[name] = (path, _torch_name_for(list(path))[1] == "t")
    return out


def gru_cell_stack_state_from_jax(params) -> Dict[str, np.ndarray]:
    """A flax `GRUCellStack`'s parameters (`GRUCell_0` with Dense `ir`, `iz`,
    `in` on the input and `hr`, `hz`, `hn` on the state, then `out`) as the
    state dict of the port's `models.classifiers.GRUCellStack`. torch stacks
    the gates r, z, n; flax's r and z carry one bias, on the input side, so
    torch's hidden-side bias is zero for them."""
    cell = params["GRUCell_0"]
    gates = ("r", "z", "n")
    hn_bias = np.asarray(cell["hn"]["bias"])
    return {
        "gru.weight_ih_l0": np.concatenate([np.asarray(cell["i" + g]["kernel"]).T for g in gates]),
        "gru.weight_hh_l0": np.concatenate([np.asarray(cell["h" + g]["kernel"]).T for g in gates]),
        "gru.bias_ih_l0": np.concatenate([np.asarray(cell["i" + g]["bias"]) for g in gates]),
        "gru.bias_hh_l0": np.concatenate([np.zeros_like(hn_bias), np.zeros_like(hn_bias), hn_bias]),
        "out.weight": np.asarray(params["out"]["kernel"]).T,
        "out.bias": np.asarray(params["out"]["bias"]),
    }


def _expand(name: str) -> List[str]:
    m = re.search(r"([^.]+)\|([^.]+)", name)
    if m is None:
        return [name]
    return [name[: m.start()] + alt + name[m.end():] for alt in m.groups()]


def load_state_dict(model: nn.Module, state_dict: Dict[str, object], strict: bool = True) -> None:
    """Copy `state_dict` (numpy arrays or tensors, reference names) into
    `model` in place. A tied parameter registered under several names is
    filled from whichever of them the dict holds. With `strict`, every
    parameter must be filled and every name used."""
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
    unexpected = [n for n in given if n not in own]
    if strict and (missing or unexpected):
        raise KeyError(f"missing {missing[:5]} ({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")


def optimizer_state_from_jax(model: nn.Module, mu, nu, count: int) -> Dict[str, object]:
    """An optax adam state's moments (JAX parameter trees `mu`, `nu`) and its
    step `count` as the state of the port's `training.optimizers.Optimizer`
    over `model.named_parameters()`, for a resumed or compared step to start
    from the same moments. Tied parameters are keyed by their first name."""
    params = dict(model.named_parameters(remove_duplicate=False))
    first_name = {}
    for name, p in model.named_parameters():
        first_name[id(p)] = name

    def keyed(tree):
        out = {}
        for name, value in state_dict_from_jax(tree).items():
            hit = next((n for n in _expand(name) if n in params), None)
            if hit is None:
                raise KeyError(f"no parameter for {name}")
            out[first_name[id(params[hit])]] = torch.from_numpy(np.array(value))
        return out

    return {"count": int(count), "mu": keyed(mu), "nu": keyed(nu)}

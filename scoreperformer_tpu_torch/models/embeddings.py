"""Tuple-token embeddings and the output heads.

Counterpart of scoreperformer_tpu/models/embeddings.py. Each stream's full
table (discrete rows + an MLP over fixed token values) is materialized and
gathered from; the same tables serve the tied LM heads. The heads carry the
reference's parameter names, to which `convert.py` maps the JAX ones: the
untied head's `head_<key>` is `heads.<key>`, the tied split head's
`to_emb_<key>` and `norm_<key>` are `to_embs.<key>.0` and `.1`, the
regression head's `reg_<key>` is `heads.<key>`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ModuleConfig
from .layers import LayerNorm, Linear, promoted


@dataclass
class TupleTokenEmbeddingsConfig(ModuleConfig):
    _target_: str = "simple"
    emb_dims: Union[Dict[str, int], int, None] = None
    mode: str = "cat"
    emb_norm: bool = False
    discrete: bool = True
    continuous: Union[bool, List[str]] = False
    continuous_dense: bool = False
    token_values: Optional[Dict[str, list]] = None
    discrete_ids: Optional[List[int]] = None
    tie_keys: Optional[Dict[str, str]] = None
    multiseq_mode: str = "pre-sum"
    num_sequences: int = 2


@dataclass
class TupleTokenHeadConfig(ModuleConfig):
    _target_: str = "lm"
    filter_keys: Optional[List[str]] = None
    reuse_projection: bool = True


@dataclass
class TupleTokenRegressionHeadConfig(ModuleConfig):
    regression_keys: List[str] = field(default_factory=list)


class StreamEmbedding(nn.Module):
    """One token stream's table: optional discrete rows (`index_weight`) plus
    an optional continuous value encoder (`value_layer`) over fixed token
    values, dense (an MLP with mish) or a single Linear(1, dim)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        discrete: bool = True,
        continuous: bool = False,
        dense: bool = False,
        dense_depth: int = 2,
        token_values: Optional[np.ndarray] = None,
        discrete_ids: Optional[tuple] = None,
        padding_idx: Optional[int] = 0,
    ):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.discrete, self.continuous, self.dense = discrete, continuous, dense
        self.padding_idx = padding_idx
        self.has_discrete = discrete or discrete_ids is not None
        if self.has_discrete:
            self.index_weight = nn.Parameter(torch.randn(num_embeddings, embedding_dim) * 1e-2)
            keep = torch.ones(num_embeddings, 1)
            if not discrete:  # only the discrete_ids rows are active
                keep = torch.zeros(num_embeddings, 1)
                keep[list(discrete_ids)] = 1.0
            if padding_idx is not None:
                keep[padding_idx] = 0.0
            self.register_buffer("index_keep", keep, persistent=False)
        if continuous:
            values = (
                np.asarray(token_values, dtype=np.float32)
                if token_values is not None
                else np.linspace(0.0, 1.0, num_embeddings, dtype=np.float32)
            ).copy()
            if padding_idx is not None:
                values[padding_idx] = 0.0
            self.register_buffer("values", torch.from_numpy(values.reshape(-1, 1)), persistent=False)
            if dense:
                self.value_layer = nn.ModuleList(
                    nn.Sequential(Linear(1 if i == 0 else embedding_dim, embedding_dim),
                                  nn.Mish() if i < dense_depth - 1 else nn.Identity())
                    for i in range(dense_depth)
                )
                for seq in self.value_layer:
                    nn.init.normal_(seq[0].weight, std=1e-2)
                    nn.init.zeros_(seq[0].bias)
            else:
                self.value_layer = Linear(1, embedding_dim, bias=False)
                nn.init.normal_(self.value_layer.weight, std=1e-2)
            value_keep = torch.ones(num_embeddings, 1)
            if discrete_ids is not None:
                value_keep[list(discrete_ids)] = 0.0
            self.register_buffer("value_keep", value_keep, persistent=False)

    def table(self) -> torch.Tensor:
        """The materialized (num_embeddings, dim) table."""
        table = 0
        if self.has_discrete:
            table = self.index_weight * self.index_keep
        if self.continuous:
            h = self.values
            if self.dense:
                for seq in self.value_layer:
                    h = seq(h)
            else:
                h = self.value_layer(h)
            table = table + h * self.value_keep
        return table

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.table())


def build_stream_embeddings(
    num_tokens: Dict[str, int], cfg: TupleTokenEmbeddingsConfig, emb_dims_default: int
) -> Dict[str, StreamEmbedding]:
    """Per-stream embeddings, as TupleTokenEmbeddings builds them; also the
    tables ScorePerformer shares across its submodels (tie_token_emb)."""
    emb_dims = cfg.emb_dims if cfg.emb_dims is not None else emb_dims_default
    continuous = cfg.continuous
    keys = list(num_tokens)
    continuous_keys = keys if continuous is True else ([] if continuous is False else list(continuous))
    token_values = cfg.token_values or {}
    out = {}
    for key in keys:
        dim = emb_dims if isinstance(emb_dims, int) else emb_dims[key]
        if key in continuous_keys:
            values = token_values.get(key)
            out[key] = StreamEmbedding(
                num_tokens[key], dim, discrete=cfg.discrete, continuous=True,
                dense=cfg.continuous_dense,
                token_values=np.asarray(values) if values is not None else None,
                discrete_ids=tuple(cfg.discrete_ids) if cfg.discrete_ids else None,
            )
        else:
            out[key] = StreamEmbedding(num_tokens[key], dim, discrete=True, continuous=False)
    return out


class TupleTokenEmbeddings(nn.Module):
    """Per-stream embeddings fused by concat+project ("cat") or sum, with the
    multi-sequence fusion modes for MixedLM (seq, masked_seq) pairs."""

    def __init__(
        self,
        num_tokens: Dict[str, int],
        config: TupleTokenEmbeddingsConfig,
        project_emb_dim: int = 512,
        shared_streams: Optional[Dict[str, StreamEmbedding]] = None,
    ):
        super().__init__()
        cfg = self.config = config
        self.num_tokens = dict(num_tokens)
        tie_keys = cfg.tie_keys or {}
        shared_streams = shared_streams or {}
        own = build_stream_embeddings(
            {k: v for k, v in num_tokens.items() if k not in tie_keys and k not in shared_streams},
            cfg, project_emb_dim,
        )
        embs, dims, total = {}, {}, 0
        for key in num_tokens:
            if key in tie_keys:
                dims[key] = dims[tie_keys[key]]
                total += dims[key] if cfg.mode == "cat" else 0
                continue
            embs[key] = shared_streams[key] if key in shared_streams else own[key]
            dim = embs[key].embedding_dim
            dims[key] = dim
            total += dim if cfg.mode == "cat" else dim - total
        self.embs = nn.ModuleDict(embs)
        self.tie_keys_map = tie_keys
        self.emb_dims_map = dims
        self.total_emb_dim = total
        self.norm = LayerNorm(total, eps=1e-5) if cfg.emb_norm else None
        self.has_project = total != project_emb_dim
        # the tied LM head reuses this projection transposed
        self.project_emb = Linear(total, project_emb_dim) if self.has_project else None
        if self.multiseq_mode == "post-cat":
            self.project_multiemb = Linear(cfg.num_sequences * project_emb_dim, project_emb_dim)

    @property
    def uniform_dim(self) -> Optional[int]:
        """The streams' embedding width when every stream has the same one,
        else None (JAX's `_uniform_dim`)."""
        dims = list(self.emb_dims_map.values())
        return dims[0] if all(d == dims[0] for d in dims) else None

    @property
    def multiseq_mode(self) -> Optional[str]:
        return self.config.multiseq_mode if self.config._target_ == "multi-seq" else None

    def stream_emb(self, key: str) -> StreamEmbedding:
        return self.embs[self.tie_keys_map.get(key, key)]

    def tables(self) -> Dict[str, torch.Tensor]:
        return {key: self.stream_emb(key).table() for key in self.num_tokens}

    def _forward_single(self, x: torch.Tensor) -> torch.Tensor:
        parts = [self.stream_emb(key)(x[..., i]) for i, key in enumerate(self.num_tokens)]
        h = torch.cat(parts, dim=-1) if self.config.mode == "cat" else sum(parts)
        if self.norm is not None:
            h = self.norm(h)
        if self.config.mode == "cat" and self.has_project:
            h = self.project_emb(h)
        return h

    def forward(self, x: torch.Tensor, x_extra: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """`x`: (b, t, S) token ids; `x_extra`: parallel sequences for the
        multi-seq fusion (e.g. the masked performance)."""
        if not x_extra or self.multiseq_mode is None:
            return self._forward_single(x)
        seqs = [x] + list(x_extra)
        mode = self.multiseq_mode
        if mode == "pre-sum":
            parts = [
                sum(self.stream_emb(key)(s[..., i]) for s in seqs)
                for i, key in enumerate(self.num_tokens)
            ]
            h = torch.cat(parts, dim=-1) if self.config.mode == "cat" else sum(parts)
            if self.norm is not None:
                h = self.norm(h)
            if self.config.mode == "cat" and self.has_project:
                h = self.project_emb(h)
            return h
        if mode in ("post-sum", "post-cat"):
            projected = [self._forward_single(s) for s in seqs]
            if mode == "post-cat":
                return self.project_multiemb(torch.cat(projected, dim=-1))
            return sum(projected)
        raise ValueError(f"unknown multiseq_mode {mode}")


class TupleTokenLMHead(nn.Module):
    """Independent per-stream linear heads (JAX `TupleTokenLMHead`), one
    stream's logits a Linear, for the streams of `filter_keys` when set."""

    def __init__(self, dim: int, num_tokens: Dict[str, int], filter_keys: Optional[List[str]] = None):
        super().__init__()
        self.heads = nn.ModuleDict(
            {key: Linear(dim, num) for key, num in num_tokens.items() if not filter_keys or key in filter_keys}
        )

    def forward(self, x: torch.Tensor, embeddings=None, keys: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
        return {key: head(x) for key, head in self.heads.items() if keys is None or key in keys}


class TupleTokenTiedLMHead(nn.Module):
    """Tied head: the embedding projection transposed (or, without
    `reuse_projection`, a Linear of its own into the embedding space), a
    LayerNorm, then logits against each stream's embedding table. The
    embeddings are passed at call time, so their parameters are registered
    only once."""

    def __init__(self, total_emb_dim: int, dim: Optional[int] = None, reuse_projection: bool = True):
        super().__init__()
        self.reuse_projection = reuse_projection
        if not reuse_projection:
            self.project_emb = Linear(dim, total_emb_dim, bias=False)
        self.norm = LayerNorm(total_emb_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, embeddings: TupleTokenEmbeddings, keys: Optional[List[str]] = None,
                batched: bool = False) -> Union[Dict[str, torch.Tensor], torch.Tensor]:
        """Per-stream logits, or with `batched` one (..., S, Vmax) tensor from
        a single product against the zero-padded stacked tables: the columns
        at or past a stream's vocabulary are 0. `batched` needs uniform
        stream dims and emits every stream."""
        if batched:
            if embeddings.uniform_dim is None:
                raise ValueError("the batched head requires uniform stream dims")
            if keys is not None:
                raise ValueError("the batched head emits all streams: keys must be None")
        if self.reuse_projection:
            if not embeddings.has_project:
                raise ValueError("the tied head requires an embedding projection")
            x, weight = promoted(x, embeddings.project_emb.weight)
            h = self.norm(x @ weight)
        else:
            h = self.norm(self.project_emb(x))
        tables = embeddings.tables()
        if batched:
            vmax = max(t.shape[0] for t in tables.values())
            stacked = torch.stack([F.pad(t, (0, 0, 0, vmax - t.shape[0])) for t in tables.values()])  # (S, Vmax, d)
            hs, stacked = promoted(h.reshape(*h.shape[:-1], len(tables), embeddings.uniform_dim), stacked)
            return torch.einsum("...sd,svd->...sv", hs, stacked)
        logits, offset = {}, 0
        for key in embeddings.num_tokens:
            dim = embeddings.emb_dims_map[key]
            if keys is None or key in keys:
                hk, table = promoted(h[..., offset : offset + dim], tables[key])
                logits[key] = hk @ table.T
            offset += dim
        return logits


class TupleTokenTiedSplitLMHead(nn.Module):
    """Per-stream Linear and LayerNorm into that stream's embedding space,
    then logits against its table (JAX `TupleTokenTiedSplitLMHead`)."""

    def __init__(self, dim: int, embeddings: TupleTokenEmbeddings, filter_keys: Optional[List[str]] = None):
        super().__init__()
        self.to_embs = nn.ModuleDict({
            key: nn.Sequential(Linear(dim, embeddings.emb_dims_map[key]),
                               LayerNorm(embeddings.emb_dims_map[key], eps=1e-5))
            for key in embeddings.num_tokens if not filter_keys or key in filter_keys
        })

    def forward(self, x: torch.Tensor, embeddings: TupleTokenEmbeddings,
                keys: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
        tables = embeddings.tables()
        logits = {}
        for key, to_emb in self.to_embs.items():
            if keys is None or key in keys:
                h, table = promoted(to_emb(x), tables[key])
                logits[key] = h @ table.T
        return logits


class TupleTokenRegressionHead(nn.Module):
    """Scalar value heads, one Linear(dim, 1) a regression key (JAX
    `TupleTokenRegressionHead`)."""

    def __init__(self, dim: int, regression_keys: List[str]):
        super().__init__()
        self.heads = nn.ModuleDict({key: Linear(dim, 1) for key in regression_keys})

    def forward(self, x: torch.Tensor, keys: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
        return {key: head(x) for key, head in self.heads.items() if keys is None or key in keys}


class TupleTokenEmbeddingHead(nn.Module):
    """An MLP over (partly) detached hidden states (JAX
    `TupleTokenEmbeddingHead`): `depth` Linear layers, `layers.<i>` (flax's
    `layer_<i>`), hidden ones `hidden_dim` wide (default `emb_dim`) with
    Mish between them, the last `emb_dim` wide. The input is
    `d * x.detach() + (1 - d) * x` for `detach_inputs` d, so at 1 no
    gradient reaches it."""

    def __init__(self, in_dim: int, emb_dim: int, hidden_dim: Optional[int] = None, depth: int = 2,
                 detach_inputs: float = 1.0):
        super().__init__()
        self.detach_inputs = detach_inputs
        hidden = hidden_dim or emb_dim
        dims = [in_dim] + [hidden] * (depth - 1) + [emb_dim]
        self.layers = nn.ModuleList([Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.detach_inputs * x.detach() + (1 - self.detach_inputs) * x
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.mish(x)
        return x

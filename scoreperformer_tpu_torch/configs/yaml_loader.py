# Copy of scoreperformer_tpu/configs/yaml_loader.py with `import yaml` moved into
# load_yaml; the port imports nothing of the JAX package.
"""YAML experiment-config loading with ``base:`` inheritance.

Counterpart of the reference's config hierarchy resolution
(scoreperformer/experiments/components.py:30-46) and ``_disable_`` node
pruning (scoreperformer/utils/config.py:36-46), without omegaconf:
- ``base: <relative path>`` recursively merges a parent YAML (child wins)
- nodes with ``_disable_: true`` are removed after merging
- ``${a.b.c}`` strings interpolate values from the merged tree
- ``${date:fmt}`` resolves to the current date (custom resolver)
"""
from __future__ import annotations

import datetime
import re
from pathlib import Path
from typing import Any, Callable, Dict

from .config import merge_configs

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")

RESOLVERS: Dict[str, Callable[[str], str]] = {
    "date": lambda fmt: datetime.datetime.now().strftime(fmt or "%y%m%d"),
}


def load_yaml(path) -> Dict[str, Any]:
    import yaml  # only here: a machine without PyYAML still imports the package

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def resolve_config_hierarchy(root: Path, name: str) -> Dict[str, Any]:
    """Load ``root/name`` and recursively merge its ``base:`` ancestry.
    ``base:`` paths resolve relative to the child config's directory."""
    root = Path(root)
    path = (root / name).resolve()
    config = load_yaml(path)
    base = config.pop("base", None)
    if base:
        parent = resolve_config_hierarchy(path.parent, base)
        config = merge_configs(parent, config)
    return config


def prune_disabled(node: Any) -> Any:
    """Drop any dict node that carries ``_disable_: true``."""
    if isinstance(node, dict):
        if node.get("_disable_"):
            return None
        out = {}
        for key, value in node.items():
            if key == "_disable_":
                continue
            pruned = prune_disabled(value)
            if pruned is None and isinstance(value, dict) and value.get("_disable_"):
                continue
            out[key] = pruned
        return out
    if isinstance(node, list):
        return [prune_disabled(v) for v in node]
    return node


def _lookup(tree: Dict[str, Any], dotted: str) -> Any:
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"cannot resolve interpolation ${{{dotted}}}")
        node = node[part]
    return node


def _interp_value(value: str, tree: Dict[str, Any]) -> Any:
    full = _INTERP_RE.fullmatch(value.strip())
    if full:  # whole-string interpolation may return non-strings
        expr = full.group(1)
        if ":" in expr:
            name, _, arg = expr.partition(":")
            if name in RESOLVERS:
                return RESOLVERS[name](arg)
        return _lookup(tree, expr)

    def repl(match):
        expr = match.group(1)
        if ":" in expr:
            name, _, arg = expr.partition(":")
            if name in RESOLVERS:
                return str(RESOLVERS[name](arg))
        return str(_lookup(tree, expr))

    return _INTERP_RE.sub(repl, value)


def interpolate(node: Any, tree: Dict[str, Any] = None) -> Any:
    """Resolve ``${...}`` interpolations against the (merged) config tree."""
    if tree is None:
        tree = node
    if isinstance(node, dict):
        return {k: interpolate(v, tree) for k, v in node.items()}
    if isinstance(node, list):
        return [interpolate(v, tree) for v in node]
    if isinstance(node, str) and "${" in node:
        return _interp_value(node, tree)
    return node


def load_experiment_config(root, name: str) -> Dict[str, Any]:
    config = resolve_config_hierarchy(Path(root), name)
    config = prune_disabled(config)
    config = interpolate(config)
    return config

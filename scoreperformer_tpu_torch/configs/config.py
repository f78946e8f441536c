# Verbatim copy of scoreperformer_tpu/configs/config.py; the port imports nothing of the JAX package.
"""Dataclass-based config system.

A re-design of the reference's omegaconf ``Constructor``/``ModuleConfig``
machinery (scoreperformer/modules/constructor.py:13-138) on top of plain
dataclasses: configs are pure data (JSON/YAML-roundtrippable), builders are
explicit functions, and instantiation filters kwargs by the constructor
signature so that config dicts may carry extra service keys.
"""
from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Optional, Type, TypeVar

MISSING = "???"

T = TypeVar("T", bound="ModuleConfig")

# Keys that carry routing/meta information rather than constructor kwargs.
SERVICE_KEYS = ("_target_", "_name_", "_version_", "_disable_", "base")


def _is_missing(value: Any) -> bool:
    return isinstance(value, str) and value == MISSING


def asdict_shallow(config: Any) -> Dict[str, Any]:
    """Dataclass → dict, one level deep (nested dataclasses stay objects)."""
    return {f.name: getattr(config, f.name) for f in fields(config)}


def to_dict(config: Any) -> Any:
    """Recursively convert a (possibly nested) config to plain JSON data."""
    if is_dataclass(config) and not isinstance(config, type):
        return {f.name: to_dict(getattr(config, f.name)) for f in fields(config)}
    if isinstance(config, dict):
        return {k: to_dict(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return [to_dict(v) for v in config]
    import numpy as np

    if isinstance(config, np.ndarray):
        return config.tolist()
    if isinstance(config, (np.integer,)):
        return int(config)
    if isinstance(config, (np.floating,)):
        return float(config)
    return config


@dataclass
class ModuleConfig:
    """Base class for all module configs."""

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]], strict: bool = False) -> T:
        """Build a config from a dict, recursing into nested dataclass fields.

        Unknown keys are ignored unless ``strict``.
        """
        if data is None:
            return cls()
        if is_dataclass(data) and isinstance(data, cls):
            return data
        kwargs: Dict[str, Any] = {}
        field_map = {f.name: f for f in fields(cls)}
        for key, value in data.items():
            if key in SERVICE_KEYS:
                continue
            if key not in field_map:
                if strict:
                    raise KeyError(f"{cls.__name__} has no field {key!r}")
                continue
            ftype = field_map[key].type
            # Recurse into nested ModuleConfig fields when the value is a dict.
            resolved = _resolve_field_dataclass(cls, field_map[key])
            if resolved is not None and isinstance(value, dict):
                value = resolved.from_dict(value, strict=strict)
            kwargs[key] = value
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return to_dict(self)

    def update(self: T, **kwargs) -> T:
        for key, value in kwargs.items():
            if hasattr(self, key):
                setattr(self, key, value)
        return self

    def replace(self: T, **kwargs) -> T:
        return dataclasses.replace(self, **kwargs)

    def validate(self) -> None:
        for f in fields(self):
            if _is_missing(getattr(self, f.name)):
                raise ValueError(
                    f"{type(self).__name__}.{f.name} is required but missing (???)"
                )


def _resolve_field_dataclass(owner: type, f: dataclasses.Field) -> Optional[type]:
    """Best-effort resolution of a field's dataclass type (handles Optional)."""
    ftype = f.type
    if isinstance(ftype, str):
        # Evaluate forward references in the owner's module namespace.
        import sys
        import typing

        module = sys.modules.get(owner.__module__)
        namespace = vars(module) if module else {}
        try:
            ftype = eval(ftype, dict(namespace), dict(vars(typing)))  # noqa: S307
        except Exception:
            return None
    origin = getattr(ftype, "__origin__", None)
    if origin is not None:  # Optional[X] / Union[X, None]
        args = [a for a in getattr(ftype, "__args__", ()) if a is not type(None)]
        if len(args) == 1:
            ftype = args[0]
        else:
            return None
    if inspect.isclass(ftype) and is_dataclass(ftype) and issubclass(ftype, ModuleConfig):
        return ftype
    return None


@dataclass
class VariableModuleConfig(ModuleConfig):
    """Config with a `_target_` registry key selecting the implementation."""

    _target_: str = MISSING


def filter_kwargs(fn, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only kwargs accepted by ``fn``'s signature (unless it has **kwargs)."""
    sig = inspect.signature(fn)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig.parameters}


def init_module(cls, config: Any = None, **extra_kwargs):
    """Instantiate ``cls`` from a config object/dict plus extra kwargs.

    Mirrors Constructor.init (constructor.py:49-65): config fields and extras
    are merged, filtered by the constructor signature, and MISSING values
    raise.
    """
    data: Dict[str, Any] = {}
    if config is not None:
        if is_dataclass(config) and not isinstance(config, type):
            config.validate() if isinstance(config, ModuleConfig) else None
            data = asdict_shallow(config)
        elif isinstance(config, dict):
            data = {k: v for k, v in config.items() if k not in SERVICE_KEYS}
    data.update(extra_kwargs)
    for key, value in data.items():
        if _is_missing(value):
            raise ValueError(f"Field {key!r} of {cls.__name__} config is missing (???)")
    return cls(**filter_kwargs(cls, data))


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge two config dicts (override wins; dicts merge recursively)."""
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_configs(out[key], value)
        else:
            out[key] = value
    return out

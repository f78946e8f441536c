# Verbatim copy of scoreperformer_tpu/configs/registry.py; the port imports nothing of the JAX package.
"""Name → builder registries.

Counterpart of the reference Registry (scoreperformer/modules/constructor.py:94-138),
simplified: a registry maps string names to (class/builder, default config class)
pairs and instantiates from config dicts carrying a ``_target_`` key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from .config import ModuleConfig, init_module


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Tuple[Callable, Optional[type]]] = {}

    def register(self, name: str, config_cls: Optional[type] = None):
        """Decorator: ``@REGISTRY.register("name", ConfigCls)``."""

        def wrapper(cls_or_fn):
            self._entries[name] = (cls_or_fn, config_cls)
            return cls_or_fn

        return wrapper

    def add(self, name: str, builder: Callable, config_cls: Optional[type] = None):
        self._entries[name] = (builder, config_cls)

    def get(self, name: str) -> Callable:
        if name not in self._entries:
            raise KeyError(
                f"{name!r} is not registered in {self.name} registry; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[name][0]

    def config_cls(self, name: str) -> Optional[type]:
        return self._entries[name][1] if name in self._entries else None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)

    def instantiate(self, config: Any, **extra_kwargs):
        """Instantiate from a config dict / dataclass with a ``_target_`` key."""
        if isinstance(config, dict):
            target = config.get("_target_")
            if target is None:
                raise ValueError(f"config for {self.name} registry needs a '_target_' key")
            builder, config_cls = self._entries[target] if target in self._entries else (None, None)
            if builder is None:
                raise KeyError(
                    f"{target!r} is not registered in {self.name}; available: {sorted(self._entries)}"
                )
            if config_cls is not None:
                cfg = config_cls.from_dict(config)
                return init_module(builder, cfg, **extra_kwargs)
            return init_module(builder, config, **extra_kwargs)
        # dataclass config with _target_ field
        target = getattr(config, "_target_", None)
        if target is None:
            raise ValueError(f"config for {self.name} registry needs a '_target_' field")
        builder = self.get(target)
        return init_module(builder, config, **extra_kwargs)

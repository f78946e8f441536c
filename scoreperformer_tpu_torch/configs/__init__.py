"""Config dataclasses, registries and the recipe loader, copied from the JAX package."""
from .config import MISSING, ModuleConfig, to_dict
from .registry import Registry
from .yaml_loader import load_experiment_config, load_yaml, resolve_config_hierarchy

"""Config dataclasses' base, copied from the JAX package."""
from .config import MISSING, ModuleConfig, to_dict

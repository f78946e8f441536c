"""Host helpers copied from the JAX package (numpy only)."""
from .functions import (
    ExplicitEnum,
    apply,
    default,
    exists,
    find_closest,
    or_reduce,
    prob2bool,
)
from .io import dump_json, load_json

# Verbatim copy of scoreperformer_tpu/tokenizers/__init__.py; the port imports nothing of the JAX package.
from .classes import (
    EOS,
    MASK,
    NUM_SPECIAL,
    PAD,
    PERFORMANCE_KEYS,
    SCORE_KEYS,
    SOS,
    SPECIAL_TOKENS,
    TIME_DIVISION,
    TokSequence,
)
from .config import TokenizerConfig
from .octuple_m import OctupleM
from .presets import SPMupleBar, SPMupleBeat, SPMupleOnset, SPMupleWindow, SPMupleWindowRecompute
from .spmuple import SPMuple
from .spmuple2 import SPMuple2
from .vocab import SPVocabulary

TOKENIZERS = {
    "OctupleM": OctupleM,
    "SPMuple": SPMuple,
    "SPMuple2": SPMuple2,
    "SPMupleOnset": SPMupleOnset,
    "SPMupleBeat": SPMupleBeat,
    "SPMupleBar": SPMupleBar,
    "SPMupleWindow": SPMupleWindow,
    "SPMupleWindowRecompute": SPMupleWindowRecompute,
}


def load_tokenizer(path):
    """Load a tokenizer from a (reference-compatible) JSON config file."""
    from .config import TokenizerConfig

    config, tokenization = TokenizerConfig.from_file(path)
    cls = TOKENIZERS.get(tokenization, OctupleM)
    return cls(config)

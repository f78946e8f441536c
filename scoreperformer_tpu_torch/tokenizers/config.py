# Verbatim copy of scoreperformer_tpu/tokenizers/config.py; the port imports nothing of the JAX package.
"""Tokenizer configuration.

Reads/writes the same JSON layout as the shipped reference configs
(/root/reference/data/tokenizers/*.json, miditok-2.1.6 style): a ``config``
dict with ``beat_res`` ranges encoded as ``"a_b": res`` keys plus an
``additional_params`` bag, and a top-level ``tokenization`` class name.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from ..utils import dump_json, load_json
from .classes import SPECIAL_TOKENS


@dataclass
class TokenizerConfig:
    pitch_range: Tuple[int, int] = (21, 109)
    beat_res: Dict[Tuple[int, int], int] = field(
        default_factory=lambda: {(0, 2): 16, (2, 4): 8, (4, 8): 4, (8, 16): 2, (16, 64): 1}
    )
    nb_velocities: int = 127
    special_tokens: List[str] = field(default_factory=lambda: list(SPECIAL_TOKENS))
    use_tempos: bool = True
    use_time_signatures: bool = True
    use_programs: bool = False
    use_sustain_pedals: bool = False
    use_pitch_bends: bool = False
    nb_tempos: int = 121
    tempo_range: Tuple[int, int] = (15, 480)
    log_tempos: bool = True
    delete_equal_successive_tempo_changes: bool = True
    time_signature_range: Dict[int, List[int]] = field(
        default_factory=lambda: {
            2: [1, 2, 3, 4],
            4: [1, 2, 3, 4, 5, 6],
            8: [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
        }
    )
    delete_equal_successive_time_sig_changes: bool = True
    programs: List[int] = field(default_factory=lambda: [0])
    one_token_stream_for_programs: bool = True
    additional_params: Dict[str, Any] = field(default_factory=dict)

    # ---- JSON (reference-compatible) ----

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TokenizerConfig":
        data = dict(data)
        kwargs: Dict[str, Any] = {}
        if "beat_res" in data:
            kwargs["beat_res"] = {
                tuple(map(int, k.split("_"))): int(v) for k, v in data["beat_res"].items()
            }
        if "time_signature_range" in data:
            kwargs["time_signature_range"] = {
                int(k): v for k, v in data["time_signature_range"].items()
            }
        for key in (
            "pitch_range",
            "nb_velocities",
            "special_tokens",
            "use_tempos",
            "use_time_signatures",
            "use_programs",
            "use_sustain_pedals",
            "use_pitch_bends",
            "nb_tempos",
            "tempo_range",
            "log_tempos",
            "delete_equal_successive_tempo_changes",
            "delete_equal_successive_time_sig_changes",
            "programs",
            "one_token_stream_for_programs",
        ):
            if key in data:
                value = data[key]
                if key in ("pitch_range", "tempo_range"):
                    value = tuple(value)
                kwargs[key] = value
        kwargs["additional_params"] = dict(data.get("additional_params", {}))
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "pitch_range": list(self.pitch_range),
            "beat_res": {f"{a}_{b}": res for (a, b), res in self.beat_res.items()},
            "nb_velocities": self.nb_velocities,
            "special_tokens": list(self.special_tokens),
            "use_tempos": self.use_tempos,
            "use_time_signatures": self.use_time_signatures,
            "use_programs": self.use_programs,
            "use_sustain_pedals": self.use_sustain_pedals,
            "use_pitch_bends": self.use_pitch_bends,
            "nb_tempos": self.nb_tempos,
            "tempo_range": list(self.tempo_range),
            "log_tempos": self.log_tempos,
            "delete_equal_successive_tempo_changes": self.delete_equal_successive_tempo_changes,
            "time_signature_range": {str(k): v for k, v in self.time_signature_range.items()},
            "delete_equal_successive_time_sig_changes": self.delete_equal_successive_time_sig_changes,
            "programs": list(self.programs),
            "one_token_stream_for_programs": self.one_token_stream_for_programs,
            "additional_params": dict(self.additional_params),
        }

    @classmethod
    def from_file(cls, path) -> Tuple["TokenizerConfig", str]:
        """Load a shipped tokenizer JSON; returns (config, tokenization name)."""
        data = load_json(path)
        return cls.from_dict(data["config"]), data.get("tokenization", "")

    def save(self, path, tokenization: str) -> None:
        dump_json(
            {
                "config": self.to_dict(),
                "one_token_stream": True,
                "has_bpe": False,
                "tokenization": tokenization,
                "framework": "scoreperformer_tpu",
            },
            path,
        )

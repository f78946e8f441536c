# Verbatim copy of scoreperformer_tpu/tokenizers/presets.py; the port imports nothing of the JAX package.
"""Encoding presets (counterpart of spmuple/encodings.py:5-61)."""
from __future__ import annotations

from .spmuple import SPMuple
from .spmuple2 import SPMuple2


class SPMupleOnset(SPMuple2):
    def _tweak_config(self) -> None:
        super()._tweak_config()
        ap = self.config.additional_params
        ap["use_position_shifts"] = True
        ap["use_onset_indices"] = True
        ap["onset_tempos"] = True


class SPMupleBeat(SPMuple):
    def _tweak_config(self) -> None:
        super()._tweak_config()
        ap = self.config.additional_params
        ap["use_position_shifts"] = True
        ap["use_onset_indices"] = True
        ap["rel_onset_dev"] = True
        ap["rel_perf_duration"] = True
        ap["bar_tempos"] = False


class SPMupleBar(SPMuple):
    def _tweak_config(self) -> None:
        super()._tweak_config()
        ap = self.config.additional_params
        ap["use_position_shifts"] = True
        ap["use_onset_indices"] = True
        ap["rel_onset_dev"] = True
        ap["rel_perf_duration"] = True
        ap["bar_tempos"] = True


class SPMupleWindow(SPMuple2):
    def _tweak_config(self) -> None:
        super()._tweak_config()
        ap = self.config.additional_params
        ap["use_position_shifts"] = True
        ap["use_onset_indices"] = True
        ap["use_quantized_tempos"] = True
        ap["decode_recompute_tempos"] = False


class SPMupleWindowRecompute(SPMuple2):
    def _tweak_config(self) -> None:
        super()._tweak_config()
        ap = self.config.additional_params
        ap["use_position_shifts"] = True
        ap["use_onset_indices"] = True
        ap.setdefault("use_quantized_tempos", True)
        ap["decode_recompute_tempos"] = True

"""Online evaluation metrics.

Counterpart of scoreperformer_tpu/training/evaluator.py: per-stream argmax
accuracy and (weighted) expected value-space distances, with masked means on
the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..configs import Registry

EVALUATORS = Registry("evaluators")


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


@EVALUATORS.register("EmbeddingClassifierEvaluator")
class EmbeddingClassifierEvaluator:
    """(classifiers/evaluator.py:6-19)"""

    def __init__(self, tokenizer=None, mode=None, **kwargs):
        pass

    def __call__(self, labels, logits):
        if isinstance(logits, dict):
            metrics = {}
            correct, total = 0.0, 0
            for i, (key, lg) in enumerate(logits.items()):
                hits = lg.argmax(-1) == labels[..., i]
                metrics[f"accuracy/{key}"] = hits.float().mean()
                correct = correct + hits.sum()
                total = total + labels[..., i].numel()
            metrics["accuracy"] = correct / max(total, 1)
            return metrics
        return {"accuracy": (logits.argmax(-1) == labels).float().mean()}


@EVALUATORS.register("ScorePerformerEvaluator")
class ScorePerformerEvaluator:
    def __init__(
        self,
        tokenizer=None,
        mode: Optional[str] = "mixlm",
        label_pad_token_id: int = -100,
        weighted_distance: bool = False,
        ignore_keys: Optional[List[str]] = None,
    ):
        self.tokenizer = tokenizer
        self.mode = mode
        self.label_pad_token_id = label_pad_token_id
        self.weighted_distance = weighted_distance
        self.ignore_keys = ignore_keys or []
        self.token_values = None
        if tokenizer is not None:
            self.token_values = {
                key: torch.as_tensor(values, dtype=torch.float32)
                for key, values in tokenizer.token_values(normalize=False).items()
            }

    def __call__(self, labels: torch.Tensor, logits: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`labels` is the unshifted (b, t, S) label tensor; `logits` the
        decoder's per-stream logits (already shifted for clm/mixlm)."""
        if self.mode in ("clm", "mixlm"):
            labels = labels[:, 1:]
        keys = list(logits)
        preds = {key: logits[key].argmax(-1) for key in keys}
        metrics: Dict[str, torch.Tensor] = {}
        correct_sum = valid_sum = pred_correct = pred_valid = 0.0
        for i, key in enumerate(keys):
            lab = labels[..., i]
            valid = lab != self.label_pad_token_id
            correct = (preds[key] == lab).float()
            correct_sum = correct_sum + (correct * valid).sum()
            valid_sum = valid_sum + valid.sum()
            if key not in self.ignore_keys:
                pred_correct = pred_correct + (correct * valid).sum()
                pred_valid = pred_valid + valid.sum()
                metrics[f"accuracy/{key}"] = _masked_mean(correct, valid)
        metrics["accuracy"] = correct_sum / torch.clamp_min(torch.as_tensor(valid_sum), 1.0)
        if self.ignore_keys:
            metrics["accuracy/pred"] = pred_correct / torch.clamp_min(torch.as_tensor(pred_valid), 1.0)

        if self.token_values is not None:
            for i, key in enumerate(keys):
                if key in self.ignore_keys:
                    continue
                values = self.token_values[key].to(logits[key].device)
                lab = labels[..., i]
                valid = lab != self.label_pad_token_id
                targets = values[lab.clamp(0, len(values) - 1)]
                if self.weighted_distance:
                    probs = torch.softmax(logits[key].float(), dim=-1)
                    dist = ((targets[..., None] - values).abs() * probs).sum(-1)
                else:
                    dist = (values[preds[key]] - targets).abs()
                metrics[f"distance/{key}"] = _masked_mean(dist, valid)
        return metrics

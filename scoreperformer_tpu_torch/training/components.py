"""Experiment components factory.

Counterpart of scoreperformer_tpu/training/components.py: resolves a recipe
(a yaml hierarchy, or a config dict built in code), builds the datasets,
collator, model, evaluator and trainer, and injects dataset-derived settings
(vocab sizes, token values) into the model config. The model is built on
`device`, the GPU unless the caller asks for the CPU, with weights from the
trainer's seed.
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Any, Dict

from ..configs import load_experiment_config
from ..data import COLLATORS, DATASETS
from ..data.collators import scoreperformer_model_inputs
from ..data.performance import performer_model_inputs
from ..device import resolve_device
from ..models.factory import build_model
from .callbacks import EpochReproducibilityCallback
from .evaluator import EVALUATORS
from .optimizers import OptimizerConfig
from .trainer import Trainer, TrainerConfig


def inject_data_config(model_cfg: Dict[str, Any], dataset) -> Dict[str, Any]:
    """(reference model.py:374-394)"""
    model_cfg = copy.deepcopy(model_cfg)
    model_cfg["num_tokens"] = dataset.tokenizer.performance_sizes
    token_values = {key: value.tolist() for key, value in dataset.tokenizer.token_values(normalize=True).items()}
    if "transformer" in model_cfg and "perf_decoder" not in model_cfg:
        # the standalone Performer: one transformer config node
        model_cfg["transformer"].setdefault("token_embeddings", {})
        model_cfg["transformer"]["token_embeddings"]["token_values"] = token_values
        return model_cfg
    model_cfg["num_score_tokens"] = dataset.tokenizer.score_sizes
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        if model_cfg.get(key) is not None:
            model_cfg[key].setdefault("token_embeddings", {})
            model_cfg[key]["token_embeddings"]["token_values"] = token_values
    if model_cfg.get("classifiers") is not None and getattr(dataset, "performance_directions", None) is not None:
        model_cfg["classifiers"]["num_classes"] = dict(dataset.performance_direction_sizes)
        model_cfg["classifiers"]["class_samples"] = dict(dataset.get_direction_class_weights()[1])
    return model_cfg


@dataclass
class ExperimentComponents:
    config: Dict[str, Any]
    device: Any = "cuda"
    train_dataset: Any = None
    eval_dataset: Any = None
    collator: Any = None
    model: Any = None
    model_config: Any = None
    evaluator: Any = None
    trainer: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def from_yaml(cls, root, name, device="cuda") -> "ExperimentComponents":
        return cls(config=load_experiment_config(root, name), device=device)

    def build_datasets(self):
        data_cfg = dict(self.config["data"]["dataset"])
        name = data_cfg.pop("_name_")
        splits = data_cfg.pop("_splits_", {"train": "train", "eval": "eval"})
        builder = DATASETS.get(name)
        self.train_dataset = builder(**{**data_cfg, "split": splits.get("train", "train")})
        # eval has deterministic sampling
        eval_cfg = {**data_cfg, "sample": False, "noisy_performance": False, "deadpan_performance": False}
        try:
            self.eval_dataset = builder(**{**eval_cfg, "split": splits.get("eval", "eval")})
        except (KeyError, FileNotFoundError):
            self.eval_dataset = None
        return self.train_dataset, self.eval_dataset

    def build_collator(self):
        coll_cfg = dict(self.config["data"]["collator"])
        name = coll_cfg.pop("_name_")
        # fixed shapes: max_seq_len + 2 for SOS/EOS
        coll_cfg.setdefault("fixed_seq_len", int(self.config["data"]["dataset"].get("max_seq_len", 512)) + 2)
        self.collator = COLLATORS.get(name)(**coll_cfg)
        return self.collator

    def build_model(self):
        name = self.config["model"].get("_name_", "ScorePerformer")
        model_cfg = {k: v for k, v in self.config["model"].items() if not k.startswith("_")}
        model_cfg = inject_data_config(model_cfg, self.train_dataset or self.eval_dataset)
        seed = int((self.config.get("trainer") or {}).get("seed", 23))
        self.model, _ = build_model(name, model_cfg, device=self.device, seed=seed)
        # the post-injection recipe node, as checkpoints embed it
        self.model_config = {"_name_": name, **model_cfg}
        return self.model

    def build_evaluator(self):
        eval_cfg = dict(self.config.get("evaluator") or {})
        if not eval_cfg:
            return None
        name = eval_cfg.pop("_name_", "ScorePerformerEvaluator")
        dataset = self.train_dataset or self.eval_dataset
        self.evaluator = EVALUATORS.get(name)(tokenizer=dataset.tokenizer, mode=self.config["model"].get("mode"),
                                              **eval_cfg)
        return self.evaluator

    def build_trainer(self, callbacks=None):
        tcfg_data = dict(self.config.get("trainer") or {})
        opt = OptimizerConfig.from_dict(tcfg_data.pop("optimization", {}) or {})
        tcfg = TrainerConfig.from_dict(tcfg_data)
        tcfg.optimization = opt
        if isinstance(tcfg_data.get("output_dir"), list):
            tcfg.output_dir = os.path.join(*map(str, tcfg_data["output_dir"]))
        callbacks = list(callbacks or [])
        callbacks.append(EpochReproducibilityCallback(dataset=self.train_dataset, collator=self.collator))
        performer = self.config["model"].get("_name_", "ScorePerformer") == "Performer"
        self.trainer = Trainer(
            model=self.model, config=tcfg, train_dataset=self.train_dataset, eval_dataset=self.eval_dataset,
            collator=self.collator, evaluator=self.evaluator, callbacks=callbacks,
            model_config=self.model_config,
            input_fn=performer_model_inputs if performer else scoreperformer_model_inputs,
        )
        return self.trainer

    def init_components(self, callbacks=None) -> "ExperimentComponents":
        self.build_datasets()
        self.build_collator()
        self.build_model()
        self.build_evaluator()
        self.build_trainer(callbacks=callbacks)
        return self

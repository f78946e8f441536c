"""Training on one device: the counterpart of scoreperformer_tpu/training."""
from .callbacks import (
    CallbackHandler,
    DefaultFlowCallback,
    EpochReproducibilityCallback,
    FileLogCallback,
    JSONLMetricsCallback,
    PrinterCallback,
    ProgressCallback,
    TensorBoardCallback,
    TrainerCallback,
    TrainerControl,
    TrainerState,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .components import ExperimentComponents, inject_data_config
from .evaluator import EVALUATORS, ScorePerformerEvaluator
from .optimizers import Optimizer, OptimizerConfig, build_lr_schedule
from .tensorboard import TensorBoardWriter, read_events
from .trainer import Accumulator, Trainer, TrainerConfig, step_generators

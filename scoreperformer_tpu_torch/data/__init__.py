"""Datasets, collators, synthetic data and dataset preparation (MIDI pairs and
MusicXML directions), and the standalone Performer's performance-only dataset
and collators, copied from the JAX package (numpy and the standard library
only)."""
from ..configs import Registry
from .collators import (
    LMScorePerformanceCollator,
    MixedLMScorePerformanceCollator,
    ScorePerformanceCollator,
    ScorePerformanceInputs,
    SeqInputs,
    SeqSegments,
    scoreperformer_model_inputs,
)
from .datasets import (
    LocalScorePerformanceDataset,
    NoteSegments,
    ScorePerformanceDataset,
    ScorePerformanceSample,
    ScorePerformanceSampleMeta,
)
from .directions import DirectionBarEmbeddingDataset, DirectionEmbeddingCollator
from .music_constants import pitch_to_sitch, sitch_to_pitch
from .musicxml_directions import parse_directions, read_musicxml
from .performance import (
    LMPerformanceCollator,
    MixedLMPerformanceCollator,
    PerformanceCollator,
    PerformanceDataset,
    PerformanceSample,
    performer_model_inputs,
)
from .prepare import align_performance_to_score, prepare_dataset
from .synthetic import build_synthetic_dataset, synthetic_performance, synthetic_score

DATASETS = Registry("datasets")
DATASETS.add("ScorePerformanceDataset", ScorePerformanceDataset)
DATASETS.add("LocalScorePerformanceDataset", LocalScorePerformanceDataset)
DATASETS.add("PerformanceDataset", PerformanceDataset)
DATASETS.add("DirectionBarEmbeddingDataset", DirectionBarEmbeddingDataset)

COLLATORS = Registry("collators")
COLLATORS.add("ScorePerformanceCollator", ScorePerformanceCollator)
COLLATORS.add("LMScorePerformanceCollator", LMScorePerformanceCollator)
COLLATORS.add("MixedLMScorePerformanceCollator", MixedLMScorePerformanceCollator)
COLLATORS.add("PerformanceCollator", PerformanceCollator)
COLLATORS.add("LMPerformanceCollator", LMPerformanceCollator)
COLLATORS.add("MixedLMPerformanceCollator", MixedLMPerformanceCollator)
COLLATORS.add("DirectionEmbeddingCollator", DirectionEmbeddingCollator)

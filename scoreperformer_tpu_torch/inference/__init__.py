from .generator import PerformanceData, ScorePerformerGenerator, StreamingDecoder
from .messengers import (
    IntermediateData,
    SPMuple2IntermediateData,
    SPMuple2Messenger,
    SPMupleMessenger,
)
from .render import load_model_from_checkpoint, prepare_render_inputs, render_performance
from .server import RenderServer

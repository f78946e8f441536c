from .render import load_model_from_checkpoint, prepare_render_inputs, render_performance
from .server import RenderServer

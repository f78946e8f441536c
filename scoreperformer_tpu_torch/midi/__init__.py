# Verbatim copy of scoreperformer_tpu/midi/__init__.py; the port imports nothing of the JAX package.
from .containers import Marker, MidiScore, NoteArray, TempoMap, TimeSigMap, Track
from .smf import read_midi, write_midi
from .timing import (
    notes_to_absolute_timing,
    notes_to_symbolic_timing,
    score_tick_to_time_map,
    tick_to_time_map,
    ticks_to_times,
)
from .beats import (
    COMPOUND_METER_BEATS,
    get_bar_beat_ticks,
    get_inter_beat_interval,
    get_performance_beats,
    get_ticks_per_bar,
)
from .preprocess import fill_unperformed_notes, insert_silent_notes, preprocess_midi
from .sync import sync_performance_midi
from . import ops

# Verbatim copy of scoreperformer_tpu/inference/messengers.py; the port imports nothing of the JAX package.
"""Token → timed-MIDI-message messengers for streaming playback.

Role counterpart of scoreperformer/inference/messengers.py: turn (partial)
performance-token sequences into wall-clock note events without building a
MIDI file, carrying running tempo state across streaming calls.

The decode math lives in the tokenizers and is only orchestrated here:

- v1 (`SPMupleMessenger`): per-note ticks come from
  `SPMuple.decode_note_ticks` and tempo-change anchors from
  `SPMuple.tempo_change_table` (both shared with
  `SPMuple.performance_tokens_to_midi`); this module adds the streaming
  concerns — continuing the running (tempo, tick, time) table across chunk
  boundaries, tick→seconds interpolation, and message assembly.
- v2 (`SPMuple2Messenger`): the onset-pair tempo recursion is
  `SPMuple2.decode_onset_times` (shared with
  `SPMuple2.performance_tokens_to_midi`), called with carried state; a chunk
  boundary that splits an onset is folded by the core's merge path.

Message rows are (time_or_tick, midi_event, pitch, velocity) with velocity 0
marking note-offs, matching the reference's wire format.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..tokenizers import SPMuple, SPMuple2
from ..tokenizers.vocab import DEFAULT_TEMPO

NOTE_ON_MIDI_EVENT = 144


@dataclass
class IntermediateData:
    """Carried state between streaming calls: rows of (tempo, tick, time)."""

    tempos: Optional[np.ndarray] = None


@dataclass
class SPMuple2IntermediateData(IntermediateData):
    """v2 carry: tempo rows plus the (tick, time, note count) onset-pair
    chain driving the tempo recursion."""

    initial_tempo: float = DEFAULT_TEMPO
    onset_pairs: Optional[np.ndarray] = None


def _assemble_messages(
    on_times: np.ndarray,
    off_times: np.ndarray,
    pitches: Optional[np.ndarray],
    velocities: Optional[np.ndarray],
    note_on_events: bool,
    note_off_events: bool,
) -> np.ndarray:
    """Stack note-on/off events into message rows; with no attributes the
    result is a bare time/tick vector."""
    assert note_on_events or note_off_events
    parts = []
    if pitches is None:
        if note_on_events:
            parts.append(on_times)
        if note_off_events:
            parts.append(off_times)
    else:
        event = np.full(len(pitches), NOTE_ON_MIDI_EVENT, dtype=float)
        if note_on_events:
            parts.append(np.stack([on_times, event, pitches, velocities], axis=-1))
        if note_off_events:
            parts.append(
                np.stack([off_times, event, pitches, np.zeros(len(pitches))], axis=-1)
            )
    return np.concatenate(parts, axis=0)


class SPMupleMessenger:
    """Streaming messenger for SPMuple (v1) encodings.

    Timing model (reference messengers.py:20-186): tempo is piecewise constant
    between change anchors; message times interpolate linearly inside each
    segment. Streaming continues the running segment table from
    ``intermediates``.
    """

    def __init__(self, tokenizer: SPMuple):
        self.tokenizer = tokenizer
        self.beat_resolution = max(tokenizer.config.beat_res.values())

    # -- note timing -----------------------------------------------------

    def _note_ticks(self, tokens: np.ndarray, ticks_data: dict):
        """Fractional performed on/off ticks (falls back to raw score timing
        for tokenizers without performance streams)."""
        if isinstance(self.tokenizer, SPMuple):
            return self.tokenizer.decode_note_ticks(
                tokens, ticks_data, ticks_per_sample=1, quantize=False
            )
        on = ticks_data["note_on"].astype(float)
        return on, on + self.tokenizer.decode_token_type(tokens, "Duration")

    # -- tempo segment table ---------------------------------------------

    def _continue_tempo_rows(
        self,
        carried: Optional[np.ndarray],
        tempos: np.ndarray,
        anchors: np.ndarray,
        grid: np.ndarray,
        first_note_tick: float,
    ) -> np.ndarray:
        """Extend the running (tempo, tick, time) table with this chunk's
        tempo changes.

        The chunk's first segment starts exactly where the carried table left
        off. If the carried tempo differs from the chunk's first tempo, the
        carried tempo is held until the chunk's first note (snapped to the
        grid) and the new tempo takes over there (messengers.py:84-110).
        Row times follow from cumulative per-segment durations. The first
        returned row is the continuation point itself.
        """
        if carried is None:
            start_tick, start_time = 0.0, 0.0
        else:
            start_tick, start_time = carried[-1, 1], carried[-1, 2]
            if carried[-1, 0] != tempos[0]:
                handover = self.tokenizer._snap_to_grid(
                    np.asarray([first_note_tick]), grid
                )[0]
                tempos = np.r_[carried[-1, 0], tempos]
                anchors = np.r_[anchors[0], handover, anchors[1:]]

        anchors = anchors.astype(float)
        anchors[0] = start_tick
        segment_secs = np.diff(anchors) / self.beat_resolution * 60.0 / tempos[:-1]
        times = start_time + np.r_[0.0, np.cumsum(segment_secs)]
        return np.stack([tempos, anchors, times], axis=1)

    @staticmethod
    def _merge_tempo_rows(
        carried: Optional[np.ndarray], fresh: np.ndarray
    ) -> np.ndarray:
        """Append this chunk's rows to the carry, dropping redundant rows:
        of several rows on one tick the last wins, and runs of equal tempo
        keep only their first row (messengers.py:133-142)."""
        rows = fresh if carried is None else np.concatenate([carried, fresh[1:]])
        last_on_tick = np.r_[np.diff(rows[:, 1]) != 0, True]
        rows = rows[last_on_tick]
        tempo_changed = np.r_[True, np.diff(rows[:, 0]) != 0]
        return rows[tempo_changed]

    # -- public API ------------------------------------------------------

    def tokens_to_messages(
        self,
        tokens: np.ndarray,
        note_attributes: bool = True,
        note_on_events: bool = True,
        note_off_events: bool = True,
        intermediates: Optional[IntermediateData] = None,
        return_intermediates: bool = False,
        to_times: bool = True,
        sort: bool = True,
    ):
        tok = self.tokenizer
        ticks_data = tok.compute_ticks(
            tokens, self.beat_resolution, compute_beat_ticks=True
        )
        on_ticks, off_ticks = self._note_ticks(tokens, ticks_data)

        tempos, anchors = tok.tempo_change_table(tokens, on_ticks, ticks_data)
        rows = self._continue_tempo_rows(
            carried=None if intermediates is None else intermediates.tempos,
            tempos=tempos,
            anchors=anchors,
            grid=tok._tempo_grid(ticks_data),
            first_note_tick=on_ticks[0],
        )

        pitches = velocities = None
        if note_attributes:
            pitches = tok.decode_token_type(tokens, "Pitch")
            velocities = tok.decode_token_type(tokens, "Velocity")
        messages = _assemble_messages(
            on_ticks, off_ticks, pitches, velocities, note_on_events, note_off_events
        )

        if to_times:
            messages = self.messages_to_times(messages, rows, sort=sort)
        elif sort:
            messages = self.sort_messages(messages)

        if return_intermediates:
            carried = None if intermediates is None else intermediates.tempos
            return messages, IntermediateData(
                tempos=self._merge_tempo_rows(carried, rows)
            )
        return messages

    def messages_to_times(
        self, messages: np.ndarray, tempo_rows: np.ndarray, sort: bool = True, inplace: bool = True
    ) -> np.ndarray:
        """Tick → seconds via the segment table: each message finds its
        segment and advances linearly from the segment start
        (messengers.py:149-173)."""
        ticks = messages[:, 0] if messages.ndim == 2 else messages
        seg = np.searchsorted(tempo_rows[:, 1], ticks, side="right") - 1
        seconds = tempo_rows[seg, 2] + (
            (ticks - tempo_rows[seg, 1]) / self.beat_resolution * 60.0 / tempo_rows[seg, 0]
        )

        if not inplace:
            messages = messages.copy()
        if messages.ndim == 2:
            messages[:, 0] = seconds
        else:
            messages[:] = seconds
        return self.sort_messages(messages) if sort else messages

    @staticmethod
    def sort_messages(messages: np.ndarray) -> np.ndarray:
        """Order by time, then pitch, then note-ons before note-offs."""
        if messages.ndim == 2:
            return messages[np.lexsort((-messages[:, 3], messages[:, 2], messages[:, 0]))]
        return np.sort(messages)

    @staticmethod
    def filter_messages(messages: np.ndarray, start: float = 0.0) -> np.ndarray:
        keep = (messages[:, 0] if messages.ndim == 2 else messages) >= start
        return messages[keep]


class SPMuple2Messenger(SPMupleMessenger):
    """Streaming messenger for SPMuple2 (v2) encodings.

    Note times come straight from the shared onset-pair tempo recursion
    (`SPMuple2.decode_onset_times`), with the pair chain and tempo rows
    carried across calls; repeated onsets at chunk boundaries are merged by
    the core. Only seconds-domain messages exist for v2.
    """

    def tokens_to_messages(
        self,
        tokens: np.ndarray,
        note_attributes: bool = True,
        note_on_events: bool = True,
        note_off_events: bool = True,
        intermediates: Optional[SPMuple2IntermediateData] = None,
        return_intermediates: bool = False,
        to_times: bool = True,
        sort: bool = True,
    ):
        assert to_times, "tick messages are not supported with SPMuple2 encoding"
        tok: SPMuple2 = self.tokenizer
        if intermediates is None:
            intermediates = SPMuple2IntermediateData()

        ticks_data = tok.compute_ticks(
            tokens, self.beat_resolution, compute_beat_ticks=True
        )
        on_times, off_times, pairs, tempo_rows = tok.decode_onset_times(
            tokens,
            ticks_data["note_on"].astype(float),
            self.tokenizer.decode_token_type(tokens, "Duration"),
            tempo_scale=60.0 / self.beat_resolution,
            initial_tempo=intermediates.initial_tempo,
            pairs=intermediates.onset_pairs,
            tempo_rows=intermediates.tempos,
        )

        pitches = velocities = None
        if note_attributes:
            pitches = tok.decode_token_type(tokens, "Pitch")
            velocities = tok.decode_token_type(tokens, "Velocity")
        messages = _assemble_messages(
            on_times, off_times, pitches, velocities, note_on_events, note_off_events
        )
        if sort:
            messages = self.sort_messages(messages)

        if return_intermediates:
            return messages, SPMuple2IntermediateData(
                tempos=tempo_rows,
                initial_tempo=intermediates.initial_tempo,
                onset_pairs=pairs,
            )
        return messages

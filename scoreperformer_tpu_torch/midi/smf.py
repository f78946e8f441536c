# Copy of scoreperformer_tpu/midi/smf.py; the port imports nothing of the JAX package.
# One change: `write_midi` clamps a tempo to what the 24-bit tempo event holds.
"""Standard MIDI File (SMF) reader/writer.

This environment ships no MIDI library, so the framework carries its own
parser. It reads format 0/1 files into the SoA :class:`MidiScore` containers
and writes format 1 files back. Only the events the framework consumes are
materialized (notes, tempo, time/key signatures, markers, program changes,
control changes, pitch bends); everything else is skipped structurally.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .containers import Marker, MidiScore, NoteArray, TempoMap, TimeSigMap, Track

_KEY_NAMES_MAJOR = ["C", "G", "D", "A", "E", "B", "F#", "C#"]
_KEY_NAMES_FLAT = ["C", "F", "Bb", "Eb", "Ab", "Db", "Gb", "Cb"]


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _read_varlen_bounded(data: bytes, pos: int, end: int):
    """Bounded variable-length read: returns (value, pos) or None on truncation
    or a varlen longer than 8 bytes — mirroring the native parser exactly so
    malformed files degrade identically in both (tests/test_smf_fuzz.py)."""
    value = 0
    for _ in range(8):
        if pos >= end:
            return None
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos
    return None


def _write_varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"cannot encode negative varlen value {value}")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


def read_midi(path_or_bytes) -> MidiScore:
    """Parse an SMF file into a :class:`MidiScore`.

    Uses the native C++ parser (midi/native.py, parity-tested) when the
    toolchain is available; set SP_NATIVE_SMF=0 to force the Python parser.
    """
    import os

    if os.environ.get("SP_NATIVE_SMF", "1") != "0":
        from .native import native_available, read_midi_native

        if native_available():
            return read_midi_native(path_or_bytes)
    return read_midi_py(path_or_bytes)


def read_midi_py(path_or_bytes) -> MidiScore:
    """Pure-Python SMF parser (the reference implementation for the native one)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if len(data) < 14 or data[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    header_len = struct.unpack(">I", data[4:8])[0]
    fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")
    pos = 8 + header_len

    tempos: List[Tuple[int, float]] = []
    time_sigs: List[Tuple[int, int, int]] = []
    key_sigs: List[Tuple[int, str]] = []
    markers: List[Marker] = []
    # (program, is_drum, name) -> list of note tuples
    track_infos = []

    for _ in range(ntracks):
        if pos + 8 > len(data):
            break
        if data[pos : pos + 4] != b"MTrk":
            length = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
            pos += 8 + length
            continue
        length = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        # clamp the declared chunk length to the file (native parity: a
        # truncated final chunk is parsed as far as the bytes go)
        end = min(pos + 8 + length, len(data))
        p = pos + 8
        tick = 0
        running_status = 0
        track_name = ""
        # channel -> current program
        channel_programs: Dict[int, int] = {}
        # (channel, pitch) -> list of (start_tick, velocity, program)
        open_notes: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        # (channel, program, is_drum) -> note tuples
        notes_by_key: Dict[Tuple[int, int, bool], List[Tuple[int, int, int, int]]] = {}
        control_changes: List[Tuple[int, int, int]] = []
        pitch_bends: List[Tuple[int, int]] = []

        def close_note(channel: int, pitch: int, end_tick: int):
            queue = open_notes.get((channel, pitch))
            if queue:
                start_tick, velocity, program = queue.pop(0)
                key = (channel, program, channel == 9)
                notes_by_key.setdefault(key, []).append(
                    (pitch, velocity, start_tick, end_tick)
                )

        # Bounds discipline matches the native parser byte-for-byte: any event
        # truncated at the chunk edge ends the track gracefully (partial
        # parse), while genuinely invalid streams raise ValueError. The fuzz
        # parity test relies on the two parsers agreeing on every input.
        while p < end:
            varlen = _read_varlen_bounded(data, p, end)
            if varlen is None:
                break
            delta, p = varlen
            tick = min(tick + delta, 1 << 62)  # int64-safe (native parity)
            if p >= end:
                break
            status = data[p]
            if status & 0x80:
                p += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status
                if not status & 0x80:
                    raise ValueError("dangling data byte with no running status")

            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90:  # note on
                if p + 2 > end:
                    break
                pitch, velocity = data[p], data[p + 1]
                p += 2
                if velocity > 0:
                    program = channel_programs.get(channel, 0)
                    open_notes.setdefault((channel, pitch), []).append(
                        (tick, velocity, program)
                    )
                else:
                    close_note(channel, pitch, tick)
            elif kind == 0x80:  # note off
                if p + 2 > end:
                    break
                pitch = data[p]
                p += 2
                close_note(channel, pitch, tick)
            elif kind == 0xB0:  # control change
                if p + 2 > end:
                    break
                control_changes.append((tick, data[p], data[p + 1]))
                p += 2
            elif kind == 0xC0:  # program change
                if p + 1 > end:
                    break
                channel_programs[channel] = data[p]
                p += 1
            elif kind == 0xE0:  # pitch bend
                if p + 2 > end:
                    break
                value = (data[p + 1] << 7 | data[p]) - 8192
                pitch_bends.append((tick, value))
                p += 2
            elif kind == 0xA0 or kind == 0xD0:  # aftertouch
                p += 2 if kind == 0xA0 else 1
            elif status == 0xFF:  # meta
                if p >= end:
                    break
                meta_type = data[p]
                p += 1
                varlen = _read_varlen_bounded(data, p, end)
                if varlen is None:
                    break
                meta_len, p = varlen
                meta_len = min(meta_len, end - p)  # clamp to the chunk
                payload = data[p : p + meta_len]
                p += meta_len
                if meta_type == 0x51 and meta_len == 3:  # tempo
                    us_per_quarter = int.from_bytes(payload, "big")
                    if us_per_quarter > 0:
                        tempos.append((tick, 60_000_000.0 / us_per_quarter))
                elif meta_type == 0x58 and meta_len >= 2:  # time signature
                    time_sigs.append((tick, payload[0], 1 << min(payload[1], 30)))
                elif meta_type == 0x59 and meta_len >= 2:  # key signature
                    sf = struct.unpack("b", payload[:1])[0]
                    minor = payload[1] if meta_len > 1 else 0
                    names = _KEY_NAMES_FLAT if sf < 0 else _KEY_NAMES_MAJOR
                    name = names[min(abs(sf), 7)] + ("m" if minor else "")
                    key_sigs.append((tick, name))
                elif meta_type == 0x06:  # marker
                    markers.append(Marker(tick, payload.decode("latin-1")))
                elif meta_type == 0x03:  # track name
                    track_name = payload.decode("latin-1")
                elif meta_type == 0x2F:  # end of track
                    break
            elif status in (0xF0, 0xF7):  # sysex
                varlen = _read_varlen_bounded(data, p, end)
                if varlen is None:
                    break
                sys_len, p = varlen
                p += sys_len
            else:
                raise ValueError(f"unexpected MIDI status byte 0x{status:02x}")

        # close any dangling notes at end of track
        for (channel, pitch), queue in open_notes.items():
            for start_tick, velocity, program in queue:
                key = (channel, program, channel == 9)
                notes_by_key.setdefault(key, []).append((pitch, velocity, start_tick, tick))

        track_infos.append((track_name, notes_by_key, control_changes, pitch_bends))
        pos = end

    score = MidiScore(ticks_per_beat=division)
    for track_name, notes_by_key, control_changes, pitch_bends in track_infos:
        for (channel, program, is_drum), note_tuples in sorted(notes_by_key.items()):
            note_tuples.sort(key=lambda n: (n[2], n[0], n[3]))
            track = Track(
                notes=NoteArray.from_tuples(note_tuples),
                program=program,
                is_drum=is_drum,
                name=track_name,
            )
            if control_changes:
                track.control_changes = np.array(control_changes, np.int64)
                from .ops import derive_sustain_pedals

                track.pedals = derive_sustain_pedals(track.control_changes)
            if pitch_bends:
                track.pitch_bends = np.array(pitch_bends, np.int64)
            score.tracks.append(track)

    if tempos:
        tempos.sort(key=lambda t: t[0])
        score.tempos = TempoMap([t for t, _ in tempos], [b for _, b in tempos])
    if time_sigs:
        time_sigs.sort(key=lambda t: t[0])
        score.time_sigs = TimeSigMap(
            [t for t, _, _ in time_sigs],
            [n for _, n, _ in time_sigs],
            [d for _, _, d in time_sigs],
        )
    score.key_sigs = sorted(key_sigs)
    score.markers = sorted(markers, key=lambda m: m.time)
    score.recompute_max_tick()
    return score


def _meta_event(delta: int, meta_type: int, payload: bytes) -> bytes:
    return _write_varlen(delta) + bytes([0xFF, meta_type]) + _write_varlen(len(payload)) + payload


def write_midi(score: MidiScore, path=None) -> bytes:
    """Serialize a :class:`MidiScore` to an SMF format-1 byte string."""
    tracks_bytes: List[bytes] = []

    # conductor track: tempo / time signature / key signature / markers
    meta_events: List[Tuple[int, int, bytes]] = []  # (tick, order, raw event body)
    for i in range(len(score.time_sigs)):
        num = int(score.time_sigs.numerator[i])
        den = int(score.time_sigs.denominator[i])
        den_pow = max(0, int(den).bit_length() - 1)
        meta_events.append(
            (int(score.time_sigs.time[i]), 0, bytes([0xFF, 0x58, 0x04, num, den_pow, 24, 8]))
        )
    for i in range(len(score.tempos)):
        # the event holds 1..2**24-1 us a quarter: tempos below ~3.58 BPM
        # (which a sampled rendition can reach) are written at that limit
        us_per_quarter = min(max(int(round(60_000_000.0 / float(score.tempos.tempo[i]))), 1), 0xFFFFFF)
        meta_events.append(
            (
                int(score.tempos.time[i]),
                1,
                bytes([0xFF, 0x51, 0x03]) + us_per_quarter.to_bytes(3, "big"),
            )
        )
    for marker in score.markers:
        text = marker.text.encode("latin-1")
        meta_events.append(
            (int(marker.time), 2, bytes([0xFF, 0x06]) + _write_varlen(len(text)) + text)
        )
    meta_events.sort(key=lambda e: (e[0], e[1]))

    body = bytearray()
    prev_tick = 0
    for tick, _, raw in meta_events:
        body += _write_varlen(tick - prev_tick) + raw
        prev_tick = tick
    body += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])
    tracks_bytes.append(bytes(body))

    # note tracks
    for track in score.tracks:
        channel = 9 if track.is_drum else 0
        events: List[Tuple[int, int, bytes]] = []
        if track.name:
            name = track.name.encode("latin-1")
            events.append((0, 0, bytes([0xFF, 0x03]) + _write_varlen(len(name)) + name))
        events.append((0, 0, bytes([0xC0 | channel, track.program & 0x7F])))
        notes = track.notes
        for i in range(len(notes)):
            pitch = int(notes.pitch[i]) & 0x7F
            velocity = int(notes.velocity[i]) & 0x7F
            start = max(0, int(notes.start[i]))
            end = max(start, int(notes.end[i]))
            events.append((start, 1, bytes([0x90 | channel, pitch, velocity])))
            events.append((end, 0, bytes([0x80 | channel, pitch, 64])))
        # pedals own CC64 on write: the interval array is authoritative (it
        # may have been quantized after parsing), so raw CC64 events are
        # dropped in its favor; all other CCs pass through
        skip_cc64 = len(track.pedals) > 0
        for i in range(len(track.control_changes)):
            t, num, val = (int(x) for x in track.control_changes[i])
            if skip_cc64 and num == 64:
                continue
            events.append((t, 1, bytes([0xB0 | channel, num & 0x7F, val & 0x7F])))
        for i in range(len(track.pedals)):
            start, end = (int(x) for x in track.pedals[i])
            events.append((start, 1, bytes([0xB0 | channel, 64, 127])))
            events.append((end, 0, bytes([0xB0 | channel, 64, 0])))
        for i in range(len(track.pitch_bends)):
            t, val = (int(x) for x in track.pitch_bends[i])
            raw = (val + 8192) & 0x3FFF
            events.append((t, 1, bytes([0xE0 | channel, raw & 0x7F, raw >> 7])))
        events.sort(key=lambda e: (e[0], e[1]))

        body = bytearray()
        prev_tick = 0
        for tick, _, raw in events:
            body += _write_varlen(tick - prev_tick) + raw
            prev_tick = tick
        body += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])
        tracks_bytes.append(bytes(body))

    out = bytearray()
    out += b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks_bytes), score.ticks_per_beat)
    for tb in tracks_bytes:
        out += b"MTrk" + struct.pack(">I", len(tb)) + tb
    out = bytes(out)

    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out

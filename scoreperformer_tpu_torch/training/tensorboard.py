# Verbatim copy of scoreperformer_tpu/training/tensorboard.py; the port imports nothing of the JAX package.
"""Minimal TensorBoard event-file writer (no tensorboard/tensorflow needed).

Counterpart of the reference's TensorBoardCallback
(scoreperformer/experiments/integrations.py:14-55), which logs scalar metrics
and config texts via `torch.utils.tensorboard.SummaryWriter`. The tensorboard
package is not installed in this environment, so this module writes the
TFRecord/Event wire format directly:

- TFRecord framing: uint64-LE length, masked CRC32C of the length bytes,
  payload, masked CRC32C of the payload (tensorflow/core/lib/io/record_writer).
- Event protobuf (tensorflow/core/util/event.proto): wall_time(1,double),
  step(2,int64), file_version(3,string) | summary(5,message).
- Summary protobuf: repeated Value(1): tag(1,string), simple_value(2,float),
  metadata(9): plugin_data(1): plugin_name(1,string); tensor(8): dtype(1,
  varint, DT_STRING=7), string_val(8, repeated bytes) for text summaries.

Files named `events.out.tfevents.<ts>.<host>` are readable by any stock
TensorBoard. Hand-rolled protobuf keeps the framework self-contained.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---- CRC32C (Castagnoli), table-driven, reflected poly 0x82F63B78 ----

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire helpers ----


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _pb_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _pb_str(field: int, value: str) -> bytes:
    return _pb_bytes(field, value.encode("utf-8"))


# ---- summaries ----


def scalar_summary(tag: str, value: float) -> bytes:
    v = _pb_str(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, v)  # Summary.value


def text_summary(tag: str, text: str) -> bytes:
    plugin = _pb_bytes(1, _pb_str(1, "text"))  # SummaryMetadata.plugin_data
    tensor = _pb_varint(1, 7) + _pb_bytes(8, text.encode("utf-8"))  # DT_STRING
    v = _pb_str(1, tag) + _pb_bytes(8, tensor) + _pb_bytes(9, plugin)
    return _pb_bytes(1, v)


def event_bytes(
    wall_time: float,
    step: int = 0,
    summary: Optional[bytes] = None,
    file_version: Optional[str] = None,
) -> bytes:
    out = _pb_double(1, wall_time) + _pb_varint(2, step)
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


class TensorBoardWriter:
    """Append-only event-file writer with the SummaryWriter subset the
    reference callback uses: add_scalar / add_text / flush / close."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        self._write_record(event_bytes(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(event_bytes(time.time(), step, scalar_summary(tag, value)))

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._write_record(event_bytes(time.time(), step, text_summary(tag, text)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# ---- reader (for tests / debugging; validates CRCs like TF's reader) ----


def read_events(path: str):
    """Parse an event file back into dicts. Raises on CRC mismatch."""
    events = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "length CRC mismatch"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "payload CRC mismatch"
            events.append(_parse_event(payload))
    return events


def _read_varint(buf: bytes, i: int):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i : i + 8], i + 8
        elif wire == 5:
            val, i = buf[i : i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _parse_event(buf: bytes):
    ev = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2:
            ev["step"] = val
        elif field == 3:
            ev["file_version"] = val.decode()
        elif field == 5:
            values = []
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    entry = {}
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1:
                            entry["tag"] = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            entry["simple_value"] = struct.unpack("<f", v3)[0]
                        elif f3 == 8:
                            for f4, _, v4 in _fields(v3):
                                if f4 == 8:
                                    entry["text"] = v4.decode()
                    values.append(entry)
            ev["summary"] = values
    return ev

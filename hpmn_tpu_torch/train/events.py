"""TensorBoard event files, written and read by hand — what the JAX driver
writes through ``tensorboardX.SummaryWriter`` for ``train.log_dir``
(neither ``tensorboardX`` nor ``tensorboard`` is on the card's machine).

A file ``<log_dir>/events.out.tfevents.<time>.<host>`` holds TFRecords:

    uint64 length | uint32 masked CRC-32C of the length's 8 bytes
    | data | uint32 masked CRC-32C of the data

all little-endian, masked as ``((crc >> 15) | (crc << 17)) + 0xa282ead8``
mod 2**32. The first record's data is an ``Event`` with ``wall_time`` and
``file_version = "brain.Event:2"``; each :meth:`EventWriter.add_scalar`
appends an ``Event`` with ``wall_time``, ``step`` and a ``Summary`` of
one ``Value`` (``tag``, ``simple_value``). The protobuf fields are
encoded here:

    Event:   wall_time 1 (double), step 2 (varint), file_version 3
             (string), summary 5 (message)
    Summary: value 1 (message, repeated)
    Value:   tag 1 (string), simple_value 2 (float)

A zero step is left out, as proto3 leaves out a default. :func:`read_events`
reads a file back, checking every CRC.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional


def _crc_table() -> List[int]:
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (``crc32c(b"123456789") == 0xE3069283``)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # an int64 as protobuf encodes it
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0,
                 file_version: Optional[str] = None,
                 tag: Optional[str] = None,
                 value: Optional[float] = None) -> bytes:
    """An ``Event`` message: the file version, or one scalar."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if tag is not None:
        val = (_bytes_field(1, tag.encode())
               + _field(2, 5) + struct.pack("<f", float(value)))
        out += _bytes_field(5, _bytes_field(1, val))
    return out


def frame(data: bytes) -> bytes:
    """One TFRecord around ``data``."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


class EventWriter:
    """``SummaryWriter(log_dir)``'s file and ``add_scalar``/``close``.
    Each scalar is written and flushed at once."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time()):010d}."
            f"{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        self._file.write(frame(data))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step, tag=tag, value=value))

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


def _read_varint(buf: bytes, pos: int):
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result, pos


def _fields(buf: bytes):
    """(field number, wire type, value) of a message: an int for a varint,
    bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"wire type {wire} in an event")
        yield number, wire, value


def decode_event(data: bytes) -> Dict:
    """-> {"wall_time", "step", and "file_version" or "values": [(tag,
    simple_value), ...]}."""
    event: Dict = {"wall_time": 0.0, "step": 0}
    for number, _, value in _fields(data):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            step = value - (1 << 64) if value >= 1 << 63 else value
            event["step"] = step
        elif number == 3:
            event["file_version"] = value.decode()
        elif number == 5:
            values = event.setdefault("values", [])
            for _, _, val in _fields(value):
                tag, simple = None, None
                for n, _, v in _fields(val):
                    if n == 1:
                        tag = v.decode()
                    elif n == 2:
                        simple = struct.unpack("<f", v)[0]
                values.append((tag, simple))
    return event


def read_events(path: str) -> List[Dict]:
    """Every event of a file, in order; a bad length or CRC raises."""
    with open(path, "rb") as f:
        buf = f.read()
    events, pos = [], 0
    while pos < len(buf):
        length = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", length)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if crc != masked_crc32c(length):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = buf[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        events.append(decode_event(data))
        pos += 16 + n
    return events


def scalars(path: str) -> List[tuple]:
    """The file's scalars as (tag, step, value), in order."""
    return [(tag, e["step"], v) for e in read_events(path)
            for tag, v in e.get("values", [])]

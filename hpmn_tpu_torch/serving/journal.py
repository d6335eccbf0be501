"""Write-ahead update journal: crash durability for lifelong memories —
counterpart of ``hpmn_tpu/serving/journal.py``, in its file format, so a
journal written by either package replays in the other.

A user's memory is state the serving story must never lose: it is built
event by event and cannot be recomputed without the user's whole history.
Snapshots (``store.save``/``save_bundle``) capture it at a point in time;
this journal covers the gap between snapshots. The daemon
(``serving/server.py``) appends every accepted update batch BEFORE
applying it, and a restarted daemon replays the journal on top of the
last snapshot, so a SIGKILL loses at most the record being written.

Format: ``HPMNJRNL`` magic, then length-prefixed records
``[u32 n][u32 crc32][n x int32 uids][n x int32 items][n x int32 cats]``.
Replay stops at the first truncated or CRC-failing record (the torn tail
of a crash); everything before it is intact by construction (append +
flush + fsync per batch).

Snapshot protocol: after a successful ``store.save``, call
``truncate()``: the snapshot now covers everything the journal held.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

MAGIC = b"HPMNJRNL"
_HDR = struct.Struct("<II")  # n, crc32


class UpdateJournal:
    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "ab")
        if fresh:
            self._f.write(MAGIC)
            self._flush()

    def append(self, uids, items, cats) -> None:
        u = np.ascontiguousarray(uids, np.int32)
        i = np.ascontiguousarray(items, np.int32)
        c = np.ascontiguousarray(cats, np.int32)
        body = u.tobytes() + i.tobytes() + c.tobytes()
        self._f.write(_HDR.pack(len(u), zlib.crc32(body)) + body)
        self._flush()

    def truncate(self) -> None:
        """Reset after a snapshot covered the journaled events."""
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._flush()

    def close(self) -> None:
        self._f.close()

    def _flush(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    @staticmethod
    def replay(path: str) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]:
        """Yield (uids, items, cats) batches; stop silently at a torn tail."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                return
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                n, crc = _HDR.unpack(hdr)
                body = f.read(12 * n)
                if len(body) < 12 * n or zlib.crc32(body) != crc:
                    return  # torn tail from a crash mid-write
                flat = np.frombuffer(body, np.int32)
                yield flat[:n].copy(), flat[n:2 * n].copy(), \
                    flat[2 * n:].copy()

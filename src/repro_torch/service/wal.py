"""CRC-framed write-ahead log for the durable tuning service.

Every state-mutating request is journaled here *before* it is applied to
the ``StudyBank`` (journal-then-apply), so a crash between the fsync and
the in-memory mutation loses nothing: recovery replays the record and the
bank's deterministic ask/tell core reproduces the exact same state.

Frame format (little-endian)::

    +--------+--------+--------+----------------+
    | magic  | length | crc32  | payload        |
    | uint32 | uint32 | uint32 | `length` bytes |
    +--------+--------+--------+----------------+

The payload is a UTF-8 JSON object (one journal op).  ``read_records``
validates each frame in order and stops at the first bad one — a short
header, short payload, wrong magic, or CRC mismatch all mean the tail was
torn by a crash mid-write; everything before it is intact (frames are
appended with a single ``write`` + ``fsync``, so a torn frame can only be
the last one).  Recovery truncates the file back to the good prefix so
the next append extends a clean log.

A copy of the JAX package's ``repro.service.wal``: a record encodes to the
same bytes in both packages, so either reads the other's log.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

MAGIC = 0x57414C31                 # "WAL1"
_HEADER = struct.Struct("<III")    # magic, payload length, payload crc32
MAX_RECORD = 64 * 1024 * 1024      # sanity bound: a longer frame is garbage


def encode_frame(record: Dict[str, Any]) -> bytes:
    payload = json.dumps(record, separators=(",", ":"),
                         sort_keys=True).encode()
    return _HEADER.pack(MAGIC, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def read_records(path) -> Tuple[List[Dict[str, Any]], int, int]:
    """Scan a WAL file; returns ``(records, good_bytes, total_bytes)``.

    ``good_bytes`` is the offset just past the last valid frame; anything
    between it and ``total_bytes`` is a torn tail (or corruption) and must
    be truncated before the log is appended to again.  A missing file is
    an empty log.
    """
    if not os.path.exists(path):
        return [], 0, 0
    with open(path, "rb") as fh:
        buf = fh.read()
    records: List[Dict[str, Any]] = []
    off = 0
    total = len(buf)
    while off + _HEADER.size <= total:
        magic, length, crc = _HEADER.unpack_from(buf, off)
        if magic != MAGIC or length > MAX_RECORD:
            break
        start = off + _HEADER.size
        end = start + length
        if end > total:
            break                              # torn mid-payload
        payload = buf[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                              # bit rot / torn rewrite
        try:
            records.append(json.loads(payload.decode()))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        off = end
    return records, off, total


def truncate_to(path, good_bytes: int) -> None:
    """Cut a torn tail off the log (crash recovery's first step)."""
    with open(path, "r+b") as fh:
        fh.truncate(good_bytes)
        fh.flush()
        os.fsync(fh.fileno())


class WriteAheadLog:
    """Append-only fsync'd journal.  One ``append`` = one durable frame.

    ``append``'s ``mid_hook`` exists for the chaos harness: it is invoked
    after the first half of the frame has been written *and flushed* but
    before the rest, so a SIGKILL inside the hook leaves a genuine torn
    frame on disk at a deterministic point.
    """

    def __init__(self, path):
        self.path = path
        self._fh = open(path, "ab")

    def append(self, record: Dict[str, Any],
               mid_hook: Optional[Callable[[], None]] = None) -> None:
        frame = encode_frame(record)
        if mid_hook is not None:
            half = max(1, len(frame) // 2)
            self._fh.write(frame[:half])
            self._fh.flush()
            os.fsync(self._fh.fileno())
            mid_hook()
            self._fh.write(frame[half:])
        else:
            self._fh.write(frame)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def reset(self) -> None:
        """Truncate the log to empty (after a snapshot made it redundant).
        Not atomic with the snapshot write — it doesn't need to be: every
        journal op carries a monotonic ``seq`` and the snapshot stores the
        last applied one, so replay skips records the snapshot already
        contains if the crash lands between the two steps."""
        self._fh.truncate(0)
        self._fh.seek(0)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


def atomic_write_text(path, text: str) -> None:
    """Durable, atomic file publish: write-tmp -> flush -> fsync ->
    os.replace.  A crash at any byte leaves either the old file or the
    new one, never a torn hybrid — the config/snapshot counterpart of the
    WAL's own fsync'd append discipline."""
    p = str(path)
    tmp = p + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, p)

"""Durable coordinator: MemoryCoordinator semantics + an on-disk record log.

The reference's built-in coordinator keeps its changelog in memory only
(upstream fpindex's src/Coordinator.zig — a restart loses every generation
assignment and all lineage history while replicas keep their data).  This
implementation goes one step further: every state mutation is framed,
CRC'd, and appended to a rotating record log BEFORE it is applied, so a
coordinator restart resumes with the exact meta feed, per-lineage seqs,
and retention floors it acknowledged.

Storage layout (under `dir`):
  * `%016x.clog` — rotating record logs named by their first record
    ordinal; records framed [u32 len][u32 crc32][msgpack body] exactly
    like the per-index WAL (engine/oplog.py), sharing its torn-tail
    recovery (native scanner when available);
  * `snapshot.mpk` — compaction checkpoint: the full coordinator state
    plus `next_ordinal`; written atomically (temp + fsync + rename).
    Log files whose first ordinal is below the snapshot's `next_ordinal`
    are stale (their records are folded into the snapshot) and are
    deleted at open — so a crash between snapshot rename and log cleanup
    can never double-apply.

Record bodies (msgpack lists, first element the kind):
  ["c", name]                      create   (pos assigned on replay order)
  ["d", name]                      delete
  ["a", name, gen, [change wires]] append   (seqs assigned on replay order)
  ["r", name, gen, floor]          retention floor

The log is the commit point: a record is written (and fsync'd when `sync`)
before the in-memory apply, and the apply cannot fail after the record's
validation has passed — replay performs the identical sequence.

The port's copy of acoustid_index_tpu/cluster/file_coordinator.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import List, Optional

import msgpack

from ..engine import errors
from ..engine.model import change_from_wire, change_to_wire
from .coordinator import MemoryCoordinator

FILE_SUFFIX = ".clog"
SNAPSHOT_NAME = "snapshot.mpk"
RECORD_HEADER = struct.Struct("<II")  # payload_len, crc32
MAX_RECORD_SIZE = 64 * 1024 * 1024
DEFAULT_MAX_FILE_SIZE = 16 * 1024 * 1024
DEFAULT_COMPACT_BYTES = 64 * 1024 * 1024


def _file_name(start: int) -> str:
    return f"{start:016x}{FILE_SUFFIX}"


def _parse_name(name: str) -> Optional[int]:
    if len(name) != 16 + len(FILE_SUFFIX) or not name.endswith(FILE_SUFFIX):
        return None
    try:
        return int(name[:16], 16)
    except ValueError:
        return None


class FileCoordinator(MemoryCoordinator):
    def __init__(
        self,
        dir_path: str,
        sync: bool = True,
        max_file_size: int = DEFAULT_MAX_FILE_SIZE,
        compact_bytes: int = DEFAULT_COMPACT_BYTES,
        bootstrap_corpus=None,
    ):
        super().__init__(bootstrap_corpus=bootstrap_corpus)
        self.dir = dir_path
        self.sync = sync
        self.max_file_size = max_file_size
        self.compact_bytes = compact_bytes
        self._files: List[int] = []  # sorted first-record-ordinals
        self._fh = None
        self._current_start = 0
        self._current_size = 0
        self._total_log_size = 0
        self._next_ordinal = 0
        self._broken = False  # fail-stop after an unrecoverable log write
        self._io_lock = threading.Lock()
        os.makedirs(dir_path, exist_ok=True)
        self._load()

    # ---- open / replay ----

    def _load(self) -> None:
        snap_path = os.path.join(self.dir, SNAPSHOT_NAME)
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                snap = msgpack.unpackb(f.read(), strict_map_key=False)
            self._restore_snapshot(snap)
        for name in os.listdir(self.dir):
            start = _parse_name(name)
            if start is None:
                continue
            if start < self._next_ordinal:
                # Folded into the snapshot already (crash between snapshot
                # rename and cleanup leaves these behind) — finish the job.
                os.unlink(os.path.join(self.dir, name))
                continue
            self._files.append(start)
        self._files.sort()
        for start in self._files:
            path = os.path.join(self.dir, _file_name(start))
            with open(path, "rb") as f:
                data = f.read()
            bodies, consumed = _scan_records(data)
            for body in bodies:
                self._apply_record(body)
                self._next_ordinal += 1
            if consumed < len(data):
                # Truncate the torn tail NOW: if this file held zero valid
                # records, the next append reuses its name (_next_ordinal ==
                # start) and would otherwise write acknowledged, fsync'd
                # records BEHIND torn bytes that replay can never pass.
                with open(path, "r+b") as f:
                    f.truncate(consumed)
                    f.flush()
                    os.fsync(f.fileno())
            self._total_log_size += consumed

    def _restore_snapshot(self, snap: dict) -> None:
        from .coordinator import Entry, MetaOp, _Lineage

        self._next_ordinal = snap["next_ordinal"]
        self._meta = [
            MetaOp(pos=p, kind=k, index_name=n) for p, k, n in snap["meta"]
        ]
        self._active = dict(snap["active"])
        for key_wire, lin_wire in snap["lineages"]:
            name, gen = key_wire
            lin = _Lineage()
            lin.first_seq = lin_wire["f"]
            lin.last_seq = lin_wire["l"]
            lin.retention_floor = lin_wire["r"]
            lin.entries = [
                Entry(id=lin.first_seq + i, change=change_from_wire(c))
                for i, c in enumerate(lin_wire["e"])
            ]
            self._lineages[(name, gen)] = lin

    def _apply_record(self, body) -> None:
        kind = body[0]
        if kind == "c":
            super().create_index(body[1])
        elif kind == "d":
            super().delete_index(body[1])
        elif kind == "a":
            changes = [change_from_wire(c) for c in body[3]]
            super().append(body[1], body[2], changes, expected=None)
        elif kind == "r":
            super().set_retention_floor(body[1], body[2], body[3])
        # Unknown kinds are skipped: forward compatibility with newer logs.

    # ---- record log ----

    def _write_record(self, body) -> None:
        payload = msgpack.packb(body, use_bin_type=True)
        header = RECORD_HEADER.pack(len(payload), zlib.crc32(payload))
        with self._io_lock:
            if self._broken:
                raise errors.CoordinatorError("record log failed; restart to recover")
            fh = self._get_file()
            # _current_size is the durable end of the file: a failed write
            # (e.g. ENOSPC at flush) may leave torn bytes past it, and later
            # acknowledged records appended BEHIND a torn region would be
            # destroyed by replay's torn-tail truncation.  Roll back to the
            # durable end on any failure; if the rollback itself fails,
            # fail-stop this log (replay truncates the tail at next open).
            start = self._current_size
            try:
                fh.write(header)
                fh.write(payload)
                fh.flush()
                if self.sync:
                    os.fsync(fh.fileno())
            except Exception:
                try:
                    fh.truncate(start)
                    fh.flush()
                except Exception:
                    self._broken = True
                    try:
                        fh.close()
                    except Exception:
                        pass
                    self._fh = None
                raise
            self._current_size += len(header) + len(payload)
            self._total_log_size += len(header) + len(payload)
            self._next_ordinal += 1

    def _get_file(self):
        if self._fh is not None and self._current_size >= self.max_file_size:
            self._fh.close()
            self._fh = None
        if self._fh is None:
            self._current_start = self._next_ordinal
            path = os.path.join(self.dir, _file_name(self._current_start))
            self._fh = open(path, "ab")
            self._current_size = self._fh.tell()
            self._files.append(self._current_start)
            self._files.sort()
        return self._fh

    # ---- compaction ----

    def _snapshot_state(self) -> dict:
        # Caller holds self._lock.
        return {
            "next_ordinal": self._next_ordinal,
            "meta": [[m.pos, m.kind, m.index_name] for m in self._meta],
            "active": dict(self._active),
            "lineages": [
                [
                    [name, gen],
                    {
                        "f": lin.first_seq,
                        "l": lin.last_seq,
                        "r": lin.retention_floor,
                        "e": [change_to_wire(e.change) for e in lin.entries],
                    },
                ]
                for (name, gen), lin in self._lineages.items()
            ],
        }

    def compact(self) -> None:
        """Fold the whole record log into one snapshot file and delete the
        logs.  Crash-safe at every step: the snapshot replaces atomically,
        and stale logs (ordinal < snapshot's next_ordinal) are re-deleted
        at the next open."""
        with self._lock:
            state = self._snapshot_state()
            with self._io_lock:
                tmp = os.path.join(self.dir, SNAPSHOT_NAME + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(msgpack.packb(state, use_bin_type=True))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, os.path.join(self.dir, SNAPSHOT_NAME))
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                for start in self._files:
                    try:
                        os.unlink(os.path.join(self.dir, _file_name(start)))
                    except FileNotFoundError:
                        pass
                self._files = []
                self._total_log_size = 0

    def _maybe_compact(self) -> None:
        if self._total_log_size >= self.compact_bytes:
            self.compact()

    # ---- mutations: log first, then apply ----

    def append(self, index_name, generation, changes, expected):
        with self._lock:
            # Validate BEFORE logging so a rejected append writes nothing
            # (the WAL's contract, oplog.py append).
            lin = self._lineage(index_name, generation)
            if expected is not None and lin.last_seq != expected:
                raise errors.VersionMismatch(f"expected {expected}, at {lin.last_seq}")
            self._write_record(
                ["a", index_name, generation, [change_to_wire(c) for c in changes]]
            )
            out = super().append(index_name, generation, changes, expected=None)
            self._maybe_compact()
            return out

    def create_index(self, name: str) -> int:
        with self._lock:
            if name in self._active:  # idempotent: no new op, nothing to log
                return self._active[name]
            self._write_record(["c", name])
            return super().create_index(name)

    def delete_index(self, name: str) -> int:
        with self._lock:
            if name not in self._active:
                return len(self._meta)
            self._write_record(["d", name])
            return super().delete_index(name)

    def set_retention_floor(self, index_name, generation, floor):
        with self._lock:
            lin = self._lineage(index_name, generation)
            if floor <= lin.retention_floor:  # no-op: nothing to log
                return
            self._write_record(["r", index_name, generation, floor])
            super().set_retention_floor(index_name, generation, floor)
            self._maybe_compact()

    def close(self) -> None:
        with self._io_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _scan_records(data: bytes):
    """Msgpack bodies of the valid record prefix (torn-tail safe).
    Returns (bodies, consumed_bytes) — consumed marks where the valid
    prefix ends so the caller can truncate torn bytes."""
    from ..utils import native

    valid = native.scan_frames(data, MAX_RECORD_SIZE)
    bodies = []
    pos = 0
    while pos < len(data):
        if pos + RECORD_HEADER.size > len(data):
            break
        length, crc = RECORD_HEADER.unpack_from(data, pos)
        if length == 0 or length > MAX_RECORD_SIZE:
            break
        payload = data[pos + RECORD_HEADER.size : pos + RECORD_HEADER.size + length]
        if valid >= 0:
            if pos + RECORD_HEADER.size + length > valid:
                break
        elif len(payload) < length or zlib.crc32(payload) != crc:
            break
        bodies.append(msgpack.unpackb(payload, strict_map_key=False))
        pos += RECORD_HEADER.size + length
    return bodies, pos

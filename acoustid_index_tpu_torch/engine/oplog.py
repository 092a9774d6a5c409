"""Per-index write-ahead log.

Behavioral contract (mirrors upstream fpindex's src/Oplog.zig):
  * rotating log files named by their first commit id, bounded size;
  * records framed [u32 len][u32 crc32][msgpack transaction] so replay can
    detect a torn or corrupt tail (crash mid-append) and recover the valid
    prefix instead of failing to open;
  * commit ids are minted here, one per transaction, dense — segments tile
    them (SegmentInfo.merge asserts adjacency);
  * the upstream `version` is tracked separately and must never go
    backwards (several commits may legitimately share one position);
  * with `expected_version` set and mismatched, the append writes nothing;
  * `truncate` deletes files whose transactions are all durable in file
    segments;
  * `sync` controls fsync: True when this log is the authoritative durable
    copy (standalone), False when an upstream changelog owns durability.

All access is serialized by the owning Index's write lock.

The port's copy of acoustid_index_tpu/engine/oplog.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import msgpack

from .errors import VersionMismatch, VersionWentBackwards
from .model import Change, Transaction, change_to_wire

FILE_SUFFIX = ".xlog"
RECORD_HEADER = struct.Struct("<II")  # payload_len, crc32
MAX_RECORD_SIZE = 64 * 1024 * 1024
DEFAULT_MAX_FILE_SIZE = 16 * 1024 * 1024


def _file_name(start: int) -> str:
    return f"{start:016x}{FILE_SUFFIX}"


def _parse_name(name: str) -> Optional[int]:
    if len(name) != 16 + len(FILE_SUFFIX) or not name.endswith(FILE_SUFFIX):
        return None
    try:
        return int(name[:16], 16)
    except ValueError:
        return None


class Oplog:
    def __init__(self, dir_path: str, sync: bool = True, max_file_size: int = DEFAULT_MAX_FILE_SIZE):
        self.dir = dir_path
        self.sync = sync
        self.max_file_size = max_file_size
        self.files: List[int] = []  # sorted first-commit-ids
        self._fh = None
        self._current_start = 0
        self._current_size = 0
        self.last_commit_id = 0
        self.last_version = 0

    # ---- open / replay ----

    @classmethod
    def open(cls, dir_path: str, sync: bool, handler: Callable[[Transaction], None], **kw) -> "Oplog":
        os.makedirs(dir_path, exist_ok=True)
        self = cls(dir_path, sync=sync, **kw)
        for name in os.listdir(dir_path):
            start = _parse_name(name)
            if start is not None:
                self.files.append(start)
        self.files.sort()
        self._replay(handler)
        return self

    def _replay(self, handler: Callable[[Transaction], None]) -> None:
        from ..utils import native

        for start in self.files:
            path = os.path.join(self.dir, _file_name(start))
            with open(path, "rb") as f:
                data = f.read()
            # The native scanner validates framing + CRCs in one pass and
            # returns the valid prefix length (torn-tail recovery); -1 means
            # no native library, so the Python loop checks CRCs itself.
            valid = native.scan_frames(data, MAX_RECORD_SIZE)
            pos = 0
            while pos < len(data):
                if pos + RECORD_HEADER.size > len(data):
                    break  # torn header; recover the valid prefix
                length, crc = RECORD_HEADER.unpack_from(data, pos)
                if length == 0 or length > MAX_RECORD_SIZE:
                    break  # corrupt tail
                if valid >= 0:
                    if pos + RECORD_HEADER.size + length > valid:
                        break
                    payload = data[pos + RECORD_HEADER.size : pos + RECORD_HEADER.size + length]
                else:
                    payload = data[pos + RECORD_HEADER.size : pos + RECORD_HEADER.size + length]
                    if len(payload) < length or zlib.crc32(payload) != crc:
                        break  # torn or corrupt record
                txn = Transaction.from_wire(msgpack.unpackb(payload, strict_map_key=False))
                handler(txn)
                if txn.id > self.last_commit_id:
                    self.last_commit_id = txn.id
                v = txn.effective_version()
                if v > self.last_version:
                    self.last_version = v
                pos += RECORD_HEADER.size + length

    # ---- append ----

    def append(
        self,
        changes: Sequence[Change],
        expected_version: Optional[int] = None,
        version: Optional[int] = None,
    ) -> Tuple[int, int]:
        """Frame, CRC, write (fsync if authoritative). Returns
        (commit_id, version). Rejections write nothing."""
        if expected_version is not None and self.last_version != expected_version:
            raise VersionMismatch(f"expected version {expected_version}, at {self.last_version}")
        commit_id = self.last_commit_id + 1
        # Without an upstream position, continue the version sequence (NOT the
        # commit id: after consuming a feed the two are far apart).
        resolved = version if version is not None else self.last_version + 1
        # Versions are resume points and watermarks peers act on: non-decreasing.
        if resolved < self.last_version:
            raise VersionWentBackwards(f"{resolved} < {self.last_version}")

        txn = Transaction(id=commit_id, changes=tuple(changes), version=version)
        payload = msgpack.packb(txn.to_wire(), use_bin_type=True)
        header = RECORD_HEADER.pack(len(payload), zlib.crc32(payload))

        fh = self._get_file(commit_id)
        fh.write(header)
        fh.write(payload)
        fh.flush()
        if self.sync:
            os.fsync(fh.fileno())
        self._current_size += len(header) + len(payload)

        self.last_commit_id = commit_id
        self.last_version = resolved
        return commit_id, resolved

    def _get_file(self, commit_id: int):
        if self._fh is not None and self._current_size >= self.max_file_size:
            self._fh.close()
            self._fh = None
        if self._fh is None:
            self._current_start = commit_id
            self._current_size = 0
            path = os.path.join(self.dir, _file_name(commit_id))
            self._fh = open(path, "ab")
            self._current_size = self._fh.tell()
            self.files.append(commit_id)
            self.files.sort()
        return self._fh

    # ---- truncate ----

    def truncate(self, commit_id: int) -> None:
        """Delete files whose transactions are all below `commit_id` (now
        durable in file segments). The file spanning `commit_id` stays."""
        import bisect

        keep_from = bisect.bisect_left(self.files, commit_id)
        if keep_from > 0:
            keep_from -= 1
        deleted = 0
        while deleted < keep_from:
            start = self.files[deleted]
            if self._fh is not None and start == self._current_start:
                break  # never delete the open file
            try:
                os.unlink(os.path.join(self.dir, _file_name(start)))
            except FileNotFoundError:
                pass
            deleted += 1
        if deleted:
            del self.files[:deleted]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

"""Node-to-node snapshot wire format.

A snapshot is a msgpack header {format, generation, segments: [[info, size]]}
followed by the raw bytes of each segment file, concatenated in order —
zero-copy streamed, no WAL and no memory segments (the fetcher resumes the
feed from the snapshot's watermark), mirroring the reference's design
(upstream fpindex's src/snapshot.zig).

Export safety: every segment file descriptor is opened while the snapshot
is current, so a concurrent merge retiring (deleting) a file cannot corrupt
the stream — POSIX keeps unlinked-but-open files readable.

The port's copy of acoustid_index_tpu/multi/snapshot.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Tuple

import msgpack

from ..engine import filefmt, manifest
from ..engine.model import SegmentInfo
from ..engine.segments import Snapshot

FORMAT = 1
CHUNK = 256 * 1024


def snapshot_header(snapshot: Snapshot, generation: int, data_dir: str):
    """(header bytes, [open file objects in order])."""
    files = []
    entries = []
    try:
        for seg in snapshot.file:
            path = os.path.join(data_dir, filefmt.segment_file_name(seg.info))
            f = open(path, "rb")
            files.append(f)
            size = os.fstat(f.fileno()).st_size
            entries.append([seg.info.to_wire(), size])
    except Exception:
        for f in files:
            f.close()
        raise
    header = msgpack.packb({"f": FORMAT, "g": generation, "s": entries}, use_bin_type=True)
    return header, files


def write_snapshot(snapshot: Snapshot, generation: int, data_dir: str) -> Iterator[bytes]:
    """The snapshot stream (header length prefix + header + raw files).

    File descriptors are opened EAGERLY, before this returns — a concurrent
    merge deletes retired segment files immediately, and POSIX keeps
    unlinked-but-open files readable, so the export must grab its fds while
    the snapshot is current, not when the response body first iterates."""
    header, files = snapshot_header(snapshot, generation, data_dir)

    def stream() -> Iterator[bytes]:
        try:
            yield len(header).to_bytes(4, "little")
            yield header
            for f in files:
                while True:
                    chunk = f.read(CHUNK)
                    if not chunk:
                        break
                    yield chunk
        finally:
            for f in files:
                f.close()

    return stream()


class SnapshotReader:
    """Incremental reader over a byte stream (an iterator of chunks)."""

    def __init__(self, chunks: Iterable[bytes]):
        self._it = iter(chunks)
        self._buf = b""

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                self._buf += next(self._it)
            except StopIteration:
                break
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def parse_header(reader: SnapshotReader):
    raw_len = reader.read(4)
    if len(raw_len) < 4:
        raise ValueError("truncated snapshot header")
    hlen = int.from_bytes(raw_len, "little")
    header = reader.read(hlen)
    if len(header) < hlen:
        raise ValueError("truncated snapshot header")
    d = msgpack.unpackb(header, strict_map_key=False)
    if d.get("f") != FORMAT:
        raise ValueError(f"unsupported snapshot format {d.get('f')}")
    segments = [(SegmentInfo.from_wire(info), size) for info, size in d["s"]]
    return d["g"], segments


def restore_into(data_dir: str, chunks: Iterable[bytes], expect_generation=None) -> None:
    """Stream segment payloads straight to files and reconstruct the manifest
    from the header.  `data_dir` becomes a valid index data directory."""
    os.makedirs(data_dir, exist_ok=True)
    reader = SnapshotReader(chunks)
    generation, segments = parse_header(reader)
    if expect_generation is not None and generation != expect_generation:
        raise ValueError(f"snapshot generation {generation} != expected {expect_generation}")
    infos = []
    for info, size in segments:
        path = os.path.join(data_dir, filefmt.segment_file_name(info))
        remaining = size
        with open(path, "wb") as f:
            while remaining > 0:
                chunk = reader.read(min(CHUNK, remaining))
                if not chunk:
                    raise ValueError("truncated snapshot payload")
                f.write(chunk)
                remaining -= len(chunk)
            f.flush()
            os.fsync(f.fileno())
        infos.append(info)
    manifest.write_manifest(data_dir, infos)

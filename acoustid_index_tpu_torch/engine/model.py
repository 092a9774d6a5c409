"""Core data model: changes, transactions, segment identity, search options.

Mirrors the observable semantics of upstream fpindex's src/change.zig and
segment.zig.  Wire encodings (oplog frames, changelog batches, HTTP bodies)
use the dict forms produced by `to_wire` / parsed by `from_wire`; the
single-char keys match the reference's msgpack `field_name_prefix=1`
convention so payloads stay compact.

The port's copy of acoustid_index_tpu/engine/model.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Union

U32_MAX = 0xFFFFFFFF


def check_u32(value: int, what: str = "value") -> int:
    v = int(value)
    if v < 0 or v > U32_MAX:
        raise ValueError(f"{what} out of u32 range: {value}")
    return v


@dataclass(frozen=True)
class Insert:
    id: int
    hashes: tuple

    def __post_init__(self):
        object.__setattr__(self, "id", check_u32(self.id, "fingerprint id"))
        object.__setattr__(
            self, "hashes", tuple(check_u32(h, "hash") for h in self.hashes)
        )


@dataclass(frozen=True)
class Delete:
    id: int

    def __post_init__(self):
        object.__setattr__(self, "id", check_u32(self.id, "fingerprint id"))


@dataclass(frozen=True)
class SetMetadata:
    # Ordered (key, value) pairs; last write wins. Riding the op stream keeps
    # metadata replicating like data (change.zig:43-55).
    entries: tuple

    def __post_init__(self):
        object.__setattr__(
            self, "entries", tuple((str(k), str(v)) for k, v in self.entries)
        )


@dataclass(frozen=True)
class BulkInsert:
    """A columnar batch of inserts: semantically identical to
    `[Insert(ids[i], hashes[offsets[i]:offsets[i+1]]) for i in range(n)]`
    but carried as three packed u32 arrays end-to-end (HTTP body -> oplog
    frame -> segment build), so a million-doc ingest never materializes
    per-document Python objects.  The reference has no bulk form — its
    ingest cost is MemorySegment.build over a change list
    (upstream fpindex's src/MemorySegment.zig:81-148); this is that same
    operation with the list in columnar form.

    ids: u32[n] (0 is rejected at the API like any insert); hashes: u32[m]
    flat; offsets: u32[n+1] monotone with offsets[0]=0, offsets[n]=m.
    Duplicate ids follow batch semantics: the LAST occurrence wins.
    """

    ids: "object"  # np.ndarray u32[n]
    hashes: "object"  # np.ndarray u32[m]
    offsets: "object"  # np.ndarray u32[n+1]

    def __post_init__(self):
        import numpy as np

        ids = np.ascontiguousarray(self.ids, dtype=np.uint32)
        hashes = np.ascontiguousarray(self.hashes, dtype=np.uint32)
        offsets = np.ascontiguousarray(self.offsets, dtype=np.uint32)
        if offsets.shape[0] != ids.shape[0] + 1:
            raise ValueError("offsets must have len(ids)+1 entries")
        if ids.shape[0] and (int(offsets[0]) != 0 or int(offsets[-1]) != hashes.shape[0]):
            raise ValueError("offsets must span the hashes array")
        if np.any(offsets[1:] < offsets[:-1]):
            raise ValueError("offsets must be monotone non-decreasing")
        object.__setattr__(self, "ids", ids)
        object.__setattr__(self, "hashes", hashes)
        object.__setattr__(self, "offsets", offsets)

    def __len__(self) -> int:
        return int(self.ids.shape[0])


Change = Union[Insert, Delete, SetMetadata, BulkInsert]


def change_to_wire(c: Change) -> dict:
    if isinstance(c, Insert):
        return {"i": {"i": c.id, "h": list(c.hashes)}}
    if isinstance(c, Delete):
        return {"d": {"i": c.id}}
    if isinstance(c, SetMetadata):
        return {"s": {"e": [{"k": k, "v": v} for k, v in c.entries]}}
    if isinstance(c, BulkInsert):
        # Raw little-endian u32 columns as msgpack bin: zero-copy decode.
        return {
            "b": {
                "i": c.ids.astype("<u4").tobytes(),
                "h": c.hashes.astype("<u4").tobytes(),
                "o": c.offsets.astype("<u4").tobytes(),
            }
        }
    raise TypeError(f"not a Change: {c!r}")


def change_from_wire(d: dict) -> Change:
    if "i" in d:
        return Insert(id=d["i"]["i"], hashes=d["i"].get("h") or ())
    if "d" in d:
        return Delete(id=d["d"]["i"])
    if "s" in d:
        return SetMetadata(entries=[(e["k"], e["v"]) for e in d["s"].get("e") or []])
    if "b" in d:
        import numpy as np

        b = d["b"]
        return BulkInsert(
            ids=np.frombuffer(b["i"], dtype="<u4"),
            hashes=np.frombuffer(b["h"], dtype="<u4"),
            offsets=np.frombuffer(b["o"], dtype="<u4"),
        )
    raise ValueError(f"unknown change: {d!r}")


@dataclass(frozen=True)
class Transaction:
    """One durable commit. `id` is the dense internal commit id; `version` is
    the upstream changelog position, or None when minted locally (standalone),
    in which case the version IS the commit id (change.zig:61-73)."""

    id: int
    changes: tuple
    version: Optional[int] = None

    def effective_version(self) -> int:
        return self.version if self.version is not None else self.id

    def to_wire(self) -> dict:
        d = {"i": self.id, "c": [change_to_wire(c) for c in self.changes]}
        if self.version is not None:
            d["v"] = self.version
        return d

    @staticmethod
    def from_wire(d: dict) -> "Transaction":
        return Transaction(
            id=d["i"],
            changes=tuple(change_from_wire(c) for c in d["c"]),
            version=d.get("v"),
        )


@dataclass(frozen=True)
class SegmentInfo:
    """Segment identity: the internal dense commit-id interval
    [commit_id, commit_id+merges], plus the external changelog position its
    contents are complete up to (None = never upstream-fed).  See
    upstream fpindex's src/segment.zig:1-27 for why the two are separate."""

    commit_id: int = 0
    merges: int = 0
    version: Optional[int] = None

    def contains(self, other: "SegmentInfo") -> bool:
        return (
            other.commit_id >= self.commit_id
            and other.commit_id + other.merges <= self.commit_id + self.merges
        )

    def merge(self, other: "SegmentInfo") -> "SegmentInfo":
        # Only internally-adjacent later segments may merge (commit ids are
        # dense, so the tiling stays gapless).
        assert self.commit_id + self.merges + 1 == other.commit_id, (
            f"non-adjacent merge: {self} + {other}"
        )
        if other.version is not None:
            version = (
                max(self.version, other.version)
                if self.version is not None
                else other.version
            )
        else:
            version = self.version
        return SegmentInfo(
            commit_id=min(self.commit_id, other.commit_id),
            merges=self.merges + other.merges + 1,
            version=version,
        )

    def last_commit_id(self) -> int:
        return self.commit_id + self.merges

    def effective_version(self) -> int:
        return self.version if self.version is not None else self.last_commit_id()

    def to_wire(self) -> list:
        # Array form, like the reference's msgpack `as_array` (segment.zig:69).
        return [self.commit_id, self.merges, self.version]

    @staticmethod
    def from_wire(v: Sequence) -> "SegmentInfo":
        return SegmentInfo(commit_id=v[0], merges=v[1], version=v[2])


@dataclass(frozen=True)
class SearchOptions:
    """common.zig:50-54."""

    max_results: int = 10
    min_score: int = 1
    min_score_pct: int = 10


@dataclass(frozen=True)
class SearchResult:
    id: int
    score: int


def fold_metadata(changes: Sequence[Change], metadata: Optional[dict]) -> tuple:
    """Append a trailing set_metadata op when metadata is present, so it rides
    the op stream identically on the local and replicated paths
    (MultiIndex.zig foldMetadata)."""
    changes = tuple(changes)
    if not metadata:
        return changes
    return changes + (SetMetadata(entries=tuple(metadata.items())),)

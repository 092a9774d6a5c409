"""The logical changelog interface and its in-memory implementation.

Contract (mirrors upstream fpindex's src/Coordinator.zig:1-27, vtable
:173-250); every implementation MUST uphold:
  * the meta feed is a single global ordered `pos` sequence; for a create,
    `pos` IS the generation;
  * each (name, generation) lineage's data feed has its own seq starting at
    1, one seq per op — this seq is the index version;
  * `read(after)` returns committed entries with seq > after in order, and
    raises BelowRetention when `after` is under the retention floor;
  * `append` commits a batch atomically and honors optimistic `expected`;
  * `open_bootstrap` is optional: offering one declares "history incomplete
    from 0" and an empty node must bootstrap instead of replaying.

MemoryCoordinator doubles as the built-in coordinator process's store and
as the test fixture for the whole replication matrix (the reference's
MemoryCoordinator plays exactly this role).

The port's copy of acoustid_index_tpu/cluster/coordinator.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..engine import errors
from ..engine.model import Change


@dataclass(frozen=True)
class Entry:
    id: int  # per-lineage seq == index version
    change: Change


@dataclass(frozen=True)
class MetaOp:
    pos: int
    kind: str  # "create" | "delete"
    index_name: str


class BootstrapStream:
    """A lineage's whole current state, streamed in batches.  `position` is
    the feed position the state corresponds to; the consumer applies the
    whole stream at that one position and resumes the feed from it.
    next_batch() returns None exactly once, at a PROPER end — a truncated
    transport must raise, never return None."""

    position: int = 0

    def next_batch(self) -> Optional[List[Change]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Coordinator:
    """Abstract changelog."""

    def append(self, index_name: str, generation: int, changes: Sequence[Change], expected: Optional[int]) -> int:
        raise NotImplementedError

    def read(self, index_name: str, generation: int, after: int, max_entries: int, deadline: float) -> List[Entry]:
        """Block until entries with seq > after exist or `deadline` (a
        monotonic timestamp) passes; [] only on deadline."""
        raise NotImplementedError

    def create_index(self, name: str) -> int:
        raise NotImplementedError

    def delete_index(self, name: str) -> int:
        raise NotImplementedError

    def read_meta(self, after: int, max_ops: int, deadline: float) -> List[MetaOp]:
        raise NotImplementedError

    def set_retention_floor(self, index_name: str, generation: int, floor: int) -> None:
        raise NotImplementedError

    def open_bootstrap(self, index_name: str, generation: int) -> Optional[BootstrapStream]:
        return None

    def close(self) -> None:
        pass


@dataclass
class _Lineage:
    entries: List[Entry] = field(default_factory=list)  # seq = index+1 unless truncated
    first_seq: int = 1  # seq of entries[0]
    last_seq: int = 0
    retention_floor: int = 0  # seqs <= floor are dropped


class _ListBootstrapStream(BootstrapStream):
    def __init__(self, position: int, batches: List[List[Change]]):
        self.position = position
        self._batches = batches
        self._i = 0

    def next_batch(self) -> Optional[List[Change]]:
        if self._i >= len(self._batches):
            return None
        b = self._batches[self._i]
        self._i += 1
        return b


class MemoryCoordinator(Coordinator):
    def __init__(self, bootstrap_corpus: Optional[Dict[Tuple[str, int], Tuple[int, List[List[Change]]]]] = None):
        self._lock = threading.Condition()
        self._lineages: Dict[Tuple[str, int], _Lineage] = {}
        self._meta: List[MetaOp] = []
        self._active: Dict[str, int] = {}  # name -> generation of live create
        # (name, generation) -> (position, batches); set by tests/admin to
        # simulate a feed whose history starts later than its corpus.
        self._bootstrap = bootstrap_corpus

    # ---- data feed ----

    def _lineage(self, name: str, generation: int) -> _Lineage:
        key = (name, generation)
        lin = self._lineages.get(key)
        if lin is None:
            lin = self._lineages[key] = _Lineage()
        return lin

    def append(self, index_name, generation, changes, expected):
        with self._lock:
            lin = self._lineage(index_name, generation)
            if expected is not None and lin.last_seq != expected:
                raise errors.VersionMismatch(f"expected {expected}, at {lin.last_seq}")
            for change in changes:
                lin.last_seq += 1
                lin.entries.append(Entry(id=lin.last_seq, change=change))
            self._lock.notify_all()
            return lin.last_seq

    def read(self, index_name, generation, after, max_entries, deadline):
        with self._lock:
            while True:
                lin = self._lineage(index_name, generation)
                if after < lin.retention_floor:
                    raise errors.BelowRetention(f"after {after} < floor {lin.retention_floor}")
                # Seqs are dense: entries[i].id == first_seq + i, so the batch
                # is a slice — O(batch), not O(history) per poll (replicas
                # poll at the 50ms floor; a scan would melt on long lineages).
                start = max(after + 1 - lin.first_seq, 0)
                out = lin.entries[start : start + max_entries]
                if out:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(timeout=min(remaining, 0.5))

    # ---- meta feed ----

    def create_index(self, name: str) -> int:
        with self._lock:
            # Idempotent: an active name returns its generation, no new op.
            gen = self._active.get(name)
            if gen is not None:
                return gen
            pos = len(self._meta) + 1
            self._meta.append(MetaOp(pos=pos, kind="create", index_name=name))
            self._active[name] = pos  # create's pos IS the generation
            self._lock.notify_all()
            return pos

    def delete_index(self, name: str) -> int:
        with self._lock:
            if name not in self._active:
                # Already gone: a waiter on the returned pos must not block.
                return len(self._meta)
            del self._active[name]
            pos = len(self._meta) + 1
            self._meta.append(MetaOp(pos=pos, kind="delete", index_name=name))
            self._lock.notify_all()
            return pos

    def read_meta(self, after, max_ops, deadline):
        with self._lock:
            while True:
                # Meta positions are dense and never truncated: op.pos == i+1.
                start = max(after, 0)
                out = self._meta[start : start + max_ops]
                if out:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(timeout=min(remaining, 0.5))

    # ---- retention / bootstrap ----

    def set_retention_floor(self, index_name, generation, floor):
        with self._lock:
            lin = self._lineage(index_name, generation)
            lin.retention_floor = max(lin.retention_floor, floor)
            lin.entries = [e for e in lin.entries if e.id > lin.retention_floor]
            # Keep first_seq == entries[0].id (dense seqs); on an empty tail
            # the next live entry will be last_seq + 1.
            lin.first_seq = lin.entries[0].id if lin.entries else lin.last_seq + 1
            self._lock.notify_all()

    def open_bootstrap(self, index_name, generation):
        if self._bootstrap is None:
            return None
        item = self._bootstrap.get((index_name, generation))
        if item is None:
            return _ListBootstrapStream(0, [])
        position, batches = item
        return _ListBootstrapStream(position, [list(b) for b in batches])

    # ---- introspection for the coordinator server / tests ----

    def active_indexes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._active)

    def last_seq(self, index_name: str, generation: int) -> int:
        with self._lock:
            return self._lineage(index_name, generation).last_seq

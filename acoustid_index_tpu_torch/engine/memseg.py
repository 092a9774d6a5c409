"""Host-side segment representation and construction.

A segment is an immutable sorted (hash, docid) term table plus a sorted
"mentioned docs" table (docid -> alive/tombstone), its commit-id interval,
and metadata.  The same structure backs both tiers: memory segments are
built from write batches; file segments are the same thing loaded from disk
(filefmt.py).  Device packing for search lives in segments.py.

Build semantics mirror upstream fpindex's src/MemorySegment.zig:81-148: the
batch is scanned in reverse with first-occurrence-wins per id (so the LAST
change for an id in a batch wins), duplicate hashes within an insert are
kept (they score twice, exactly like the reference's postings), deletes
record tombstones, and metadata is applied forward (last write wins).

Merging mirrors upstream fpindex's src/segment_merger.zig: a doc shadowed by a
*newer commit anywhere in the collection* is skipped (its postings and its
docs-map entry both), tombstones of non-shadowed docs are kept so they keep
shadowing older file segments.

The port's copy of acoustid_index_tpu/engine/memseg.py: the same code, its relative
imports resolving to the port's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .model import BulkInsert, Change, Delete, Insert, SegmentInfo, SetMetadata


@dataclass(frozen=True)
class Segment:
    info: SegmentInfo
    hashes: np.ndarray  # u32[n], sorted by (hash, docid)
    docids: np.ndarray  # u32[n]
    docs_ids: np.ndarray  # u32[m], sorted; every doc mentioned (insert or delete)
    docs_alive: np.ndarray  # bool[m]; False = tombstone
    min_doc_id: int
    max_doc_id: int
    metadata: Tuple[Tuple[str, str], ...] = ()

    @property
    def num_items(self) -> int:
        return int(self.hashes.shape[0])

    @property
    def num_docs(self) -> int:
        # Counts tombstones, like the reference's docs.count().
        return int(self.docs_ids.shape[0])

    def get_size(self) -> int:
        return self.num_items

    def mentions(self, doc_id: int) -> bool:
        i = np.searchsorted(self.docs_ids, np.uint32(doc_id))
        return bool(i < self.docs_ids.shape[0] and self.docs_ids[i] == doc_id)

    def doc_alive(self, doc_id: int) -> Optional[bool]:
        i = int(np.searchsorted(self.docs_ids, np.uint32(doc_id)))
        if i < self.docs_ids.shape[0] and self.docs_ids[i] == doc_id:
            return bool(self.docs_alive[i])
        return None

    def metadata_dict(self) -> Dict[str, str]:
        return dict(self.metadata)


def _sort_items(hashes: np.ndarray, docids: np.ndarray):
    # Lexicographic (hash, docid) — the u64 key order of segment.zig's Item,
    # sorted AS that u64 key: one single-key sort is ~4x faster than
    # np.lexsort's two stable passes + index gathers, bit-identical order.
    u = (hashes.astype(np.uint64) << np.uint64(32)) | docids.astype(np.uint64)
    u.sort()
    return (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)


def build_segment(changes: Sequence[Change], info: SegmentInfo) -> Segment:
    """Build a segment from one write batch (MemorySegment.build)."""
    if any(isinstance(c, BulkInsert) for c in changes):
        return _build_segment_columnar(changes, info)
    seen: Dict[int, bool] = {}
    hash_chunks = []
    id_chunks = []
    for change in reversed(changes):
        if isinstance(change, Insert):
            if change.id in seen:
                continue
            seen[change.id] = True
            if change.hashes:
                h = np.asarray(change.hashes, dtype=np.uint32)
                hash_chunks.append(h)
                id_chunks.append(np.full(h.shape, change.id, dtype=np.uint32))
        elif isinstance(change, Delete):
            if change.id in seen:
                continue
            seen[change.id] = False
        elif isinstance(change, SetMetadata):
            continue
        else:
            raise TypeError(f"not a Change: {change!r}")

    if hash_chunks:
        hashes = np.concatenate(hash_chunks)
        docids = np.concatenate(id_chunks)
        hashes, docids = _sort_items(hashes, docids)
    else:
        hashes = np.empty(0, dtype=np.uint32)
        docids = np.empty(0, dtype=np.uint32)

    if seen:
        docs_ids = np.fromiter(seen.keys(), dtype=np.uint32, count=len(seen))
        alive = np.fromiter(seen.values(), dtype=bool, count=len(seen))
        order = np.argsort(docs_ids, kind="stable")
        docs_ids = docs_ids[order]
        docs_alive = alive[order]
        min_doc = int(docs_ids[0])
        max_doc = int(docs_ids[-1])
    else:
        docs_ids = np.empty(0, dtype=np.uint32)
        docs_alive = np.empty(0, dtype=bool)
        min_doc = 0
        max_doc = 0

    metadata: Dict[str, str] = {}
    for change in changes:
        if isinstance(change, SetMetadata):
            for k, v in change.entries:
                metadata[k] = v

    return Segment(
        info=info,
        hashes=hashes,
        docids=docids,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=min_doc,
        max_doc_id=max_doc,
        metadata=tuple(metadata.items()),
    )


def _build_segment_columnar(changes: Sequence[Change], info: SegmentInfo) -> Segment:
    """Vectorized build for batches containing BulkInsert changes: every
    per-document step of the classic loop (last-change-wins, tombstones,
    duplicate in-doc hashes kept) runs as numpy column operations, so a
    million-doc bulk batch never touches per-document Python objects."""
    # Flatten the batch into per-DOC-ENTRY columns (one row per insert or
    # delete, in batch order) plus one flat hash pool with per-entry spans.
    id_cols = []
    alive_cols = []
    start_cols = []
    count_cols = []
    hash_pool = []
    pool_pos = 0
    metadata: Dict[str, str] = {}
    for change in changes:
        if isinstance(change, BulkInsert):
            n = len(change)
            if n:
                id_cols.append(change.ids)
                alive_cols.append(np.ones(n, bool))
                counts = (change.offsets[1:] - change.offsets[:-1]).astype(np.int64)
                start_cols.append(change.offsets[:-1].astype(np.int64) + pool_pos)
                count_cols.append(counts)
                hash_pool.append(change.hashes)
                pool_pos += change.hashes.shape[0]
        elif isinstance(change, Insert):
            id_cols.append(np.array([change.id], np.uint32))
            alive_cols.append(np.ones(1, bool))
            h = np.asarray(change.hashes, dtype=np.uint32)
            start_cols.append(np.array([pool_pos], np.int64))
            count_cols.append(np.array([h.shape[0]], np.int64))
            if h.shape[0]:
                hash_pool.append(h)
                pool_pos += h.shape[0]
        elif isinstance(change, Delete):
            id_cols.append(np.array([change.id], np.uint32))
            alive_cols.append(np.zeros(1, bool))
            start_cols.append(np.array([pool_pos], np.int64))
            count_cols.append(np.array([0], np.int64))
        elif isinstance(change, SetMetadata):
            for k, v in change.entries:
                metadata[k] = v
        else:
            raise TypeError(f"not a Change: {change!r}")

    if not id_cols:
        return Segment(
            info=info,
            hashes=np.empty(0, np.uint32),
            docids=np.empty(0, np.uint32),
            docs_ids=np.empty(0, np.uint32),
            docs_alive=np.empty(0, bool),
            min_doc_id=0,
            max_doc_id=0,
            metadata=tuple(metadata.items()),
        )

    ids = np.concatenate(id_cols)
    alive = np.concatenate(alive_cols)
    starts = np.concatenate(start_cols)
    counts = np.concatenate(count_cols)
    pool = np.concatenate(hash_pool) if hash_pool else np.empty(0, np.uint32)

    # Last change per id wins (the classic loop scans in reverse with
    # first-occurrence-wins — same thing): stable sort by id keeps batch
    # order within ties, so the last row of each id group is the winner.
    order = np.argsort(ids, kind="stable")
    sids = ids[order]
    last = np.ones(sids.shape[0], bool)
    last[:-1] = sids[1:] != sids[:-1]
    win = order[last]  # winners, already in ascending-id order

    docs_ids = ids[win]
    docs_alive = alive[win]

    # Expand the winning live entries' hash spans out of the pool.
    live = counts[win] > 0
    w_start = starts[win][live]
    w_count = counts[win][live]
    w_id = docs_ids[live]
    total = int(w_count.sum())
    if total:
        cum0 = np.zeros(w_count.shape[0], np.int64)
        np.cumsum(w_count[:-1], out=cum0[1:])
        pos = np.arange(total, dtype=np.int64)
        pos += np.repeat(w_start - cum0, w_count)
        hashes = pool[pos]
        docids = np.repeat(w_id, w_count)
        hashes, docids = _sort_items(hashes, docids)
    else:
        hashes = np.empty(0, np.uint32)
        docids = np.empty(0, np.uint32)

    return Segment(
        info=info,
        hashes=hashes,
        docids=docids,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=int(docs_ids[0]),
        max_doc_id=int(docs_ids[-1]),
        metadata=tuple(metadata.items()),
    )


def _not_newer_mask(s: Segment, oracle) -> np.ndarray:
    """Mask of s.docs_ids entries with NO newer commit in the collection."""
    if hasattr(oracle, "has_newer_commit_batch"):
        return ~oracle.has_newer_commit_batch(s.docs_ids, s.info.commit_id)
    return np.fromiter(
        (not oracle(int(d), s.info.commit_id) for d in s.docs_ids),
        dtype=bool,
        count=s.docs_ids.shape[0],
    )


def merge_segments(sources: Sequence[Segment], collection) -> Segment:
    """Merge adjacent segments into one (segment_merger.zig semantics).

    `collection` answers supersession against the WHOLE collection the merge
    happens inside, not just `sources` — a doc rewritten in a segment
    outside the merged range is dropped here too.  It is either a Snapshot
    (vectorized via has_newer_commit_batch) or a scalar callable
    `(doc_id, commit_id) -> bool`.
    """
    has_newer_commit = collection  # scalar-callable fallback name
    assert sources, "no sources"
    info = sources[0].info
    for s in sources[1:]:
        info = info.merge(s.info)

    metadata: Dict[str, str] = {}
    for s in sources:  # oldest -> newest, newest key wins
        metadata.update(s.metadata)

    hash_chunks = []
    id_chunks = []
    doc_chunks = []
    alive_chunks = []
    for s in sources:
        mask = _not_newer_mask(s, has_newer_commit)
        doc_chunks.append(s.docs_ids[mask])
        alive_chunks.append(s.docs_alive[mask])
        if s.num_items:
            # A posting survives iff its doc's map entry survived.
            kept = s.docs_ids[mask]
            idx = np.searchsorted(kept, s.docids)
            idx_c = np.clip(idx, 0, max(kept.shape[0] - 1, 0))
            item_mask = (
                (kept[idx_c] == s.docids) if kept.shape[0] else np.zeros(s.num_items, bool)
            )
            hash_chunks.append(s.hashes[item_mask])
            id_chunks.append(s.docids[item_mask])

    if hash_chunks:
        hashes = np.concatenate(hash_chunks)
        docids = np.concatenate(id_chunks)
        hashes, docids = _sort_items(hashes, docids)
    else:
        hashes = np.empty(0, dtype=np.uint32)
        docids = np.empty(0, dtype=np.uint32)

    all_docs = np.concatenate(doc_chunks) if doc_chunks else np.empty(0, np.uint32)
    all_alive = np.concatenate(alive_chunks) if alive_chunks else np.empty(0, bool)
    if all_docs.shape[0]:
        # Newest wins per doc: sources are oldest -> newest, so a stable sort
        # keeps source order within equal ids and the LAST occurrence wins.
        order = np.argsort(all_docs, kind="stable")
        sorted_docs = all_docs[order]
        sorted_alive = all_alive[order]
        last = np.ones(sorted_docs.shape[0], bool)
        last[:-1] = sorted_docs[1:] != sorted_docs[:-1]
        docs_ids = sorted_docs[last]
        docs_alive = sorted_alive[last]
        min_doc = int(docs_ids[0])
        max_doc = int(docs_ids[-1])
    else:
        docs_ids = np.empty(0, dtype=np.uint32)
        docs_alive = np.empty(0, dtype=bool)
        min_doc = 0
        max_doc = 0

    return Segment(
        info=info,
        hashes=hashes,
        docids=docids,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=min_doc,
        max_doc_id=max_doc,
        metadata=tuple(metadata.items()),
    )

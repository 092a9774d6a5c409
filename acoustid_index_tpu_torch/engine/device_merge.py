"""Segment compaction on the device for big merges (counterpart of
acoustid_index_tpu/engine/device_merge.py).

The host merger (memseg.merge_segments) is one lexsort of the whole run on
the host; at 240M postings a checkpoint spends most of its time there.  The
device merge packs the run into pinned host buffers, copies each array to
the card once, merges it with ops/build.merge_postings_live (device sorts
and binary searches) and copies the result back through pinned buffers,
with one host sync (and one per part of a sort split past
ops/build.SORT_PART postings).  Merges of at least DEVICE_MERGE_MIN_POSTINGS postings
take the device path; small merges stay on the host, where the transfers
would cost more than the sort.

Exactness: merge_postings_live drops docs superseded WITHIN the merged run
(the merger's skip_docs rule).  Docs that segments OUTSIDE the run mention
(newer file segments, or the memory tier during a file merge, or the rest
of a bulk stream during a memory merge) are dropped on the card too: the
newer segments' mentioned docs ride along as one more source with no
postings, past the run's ordinals.  The reference drops them in a host
post-filter, one binary search of the merged docs per newer segment, which
took most of a merge (852-935 ms of 865-948 at 10^7 postings; up to ~25 s
per merge of a bulk stream 200 segments ahead of its merges).  Together
they give the host merge_segments result bit for bit
(tests/test_torch_device_merge.py).

What changed against the reference: no padding to bucketed capacities
(they existed so that XLA compiles few programs); no platform probe in the
threshold; and a device failure still falls back to the host merge, since
compaction must not take the index down, but it is logged with its
traceback and counted (MergeCounts, the merge metrics), never silent.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..server import metrics
from ..utils.profiling import trace
from .memseg import Segment, merge_segments

log = logging.getLogger("acoustid_index_tpu_torch.device_merge")

DEVICE_MERGE_MIN_POSTINGS = 1_000_000
MAX_DEVICE_SOURCES = 64  # the reference's slot bucket; the host merger takes any count


class MergeCounts:
    """Merges by route: `device`, `host`, and `fallback` (a device merge
    that raised and was redone on the host; counted under `host` too)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {"device": 0, "host": 0, "fallback": 0}

    def inc(self, route: str) -> None:
        with self._lock:
            self._counts[route] += 1

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


def _device_merge_threshold() -> int:
    """Posting count from which a merge runs on the device.  Read live
    (tests tune DEVICE_MERGE_MIN_POSTINGS per case); the reference's
    AITPU_DEVICE_MERGE_MIN_POSTINGS overrides it."""
    env = os.environ.get("AITPU_DEVICE_MERGE_MIN_POSTINGS")
    return int(env) if env else DEVICE_MERGE_MIN_POSTINGS


def _record(counts: Optional[MergeCounts], route: str) -> None:
    if counts is not None:
        counts.inc(route)
    metrics.inc_merges(route)


def merge_segments_auto(sources: Sequence[Segment], collection, counts: Optional[MergeCounts] = None) -> Segment:
    """Device merge when the run is big, host merge otherwise, or when the
    device merge raises (logged and counted as a fallback).  Runs of more
    than MAX_DEVICE_SOURCES sources (a bulk stream's deferred tier) stay on
    the host, as in the reference, so that both packages route alike."""
    total = sum(s.num_items for s in sources)
    if 2 <= len(sources) <= MAX_DEVICE_SOURCES and total >= _device_merge_threshold():
        try:
            merged = merge_segments_device(sources, collection)
        except Exception:  # noqa: BLE001 -- compaction must not take the index down
            log.exception("device merge of %d sources (%d postings) failed; merging on the host", len(sources), total)
            _record(counts, "fallback")
        else:
            _record(counts, "device")
            return merged
    merged = merge_segments(sources, collection)
    _record(counts, "host")
    return merged


def _newer_docs(collection, info):
    """The mentioned-doc arrays of the collection's segments newer than the
    run."""
    last = info.last_commit_id()
    return [s.docs_ids for s in collection.all_segments() if s.info.commit_id > last and s.num_docs]


def _pack_for_merge(sources: Sequence[Segment], device, newer_docs=()):
    """The run as merge_postings_live's eight inputs on `device`: postings
    and mentioned docs packed contiguously in source order (no padding),
    then, with `newer_docs`, one more source holding those docs and no
    postings; filled in pinned host buffers on a card and copied once
    each."""
    if newer_docs:
        mentions = np.concatenate(newer_docs)
        sources = list(sources) + [Segment(info=None, hashes=np.empty(0, np.uint32), docids=np.empty(0, np.uint32),
                                           docs_ids=mentions, docs_alive=np.zeros(mentions.shape[0], bool),
                                           min_doc_id=0, max_doc_id=0)]
    S = len(sources)
    total = sum(s.num_items for s in sources)
    dtotal = sum(s.num_docs for s in sources)
    pin = device.type == "cuda"

    def buf(n):
        return torch.empty(n, dtype=torch.int32, pin_memory=pin)

    host = [buf(total), buf(total), buf(S), buf(S), buf(dtotal), buf(dtotal), buf(S), buf(S)]
    hashes, docids, seg_start, seg_len, docs_ids, docs_alive, docs_start, docs_len = (t.numpy() for t in host)
    pos = dpos = 0
    for k, s in enumerate(sources):
        seg_start[k], seg_len[k] = pos, s.num_items
        hashes[pos : pos + s.num_items] = s.hashes.view(np.int32)
        docids[pos : pos + s.num_items] = s.docids.view(np.int32)
        pos += s.num_items
        docs_start[k], docs_len[k] = dpos, s.num_docs
        docs_ids[dpos : dpos + s.num_docs] = s.docs_ids.view(np.int32)
        docs_alive[dpos : dpos + s.num_docs] = s.docs_alive
        dpos += s.num_docs
    return [t.to(device, non_blocking=True) for t in host]


def merge_segments_device(sources: Sequence[Segment], collection, device=None) -> Segment:
    """Bit-for-bit equivalent of memseg.merge_segments over a `collection`
    that lists its segments (a Snapshot), with the O(n log n) work on
    `device` (default: utils.device.device())."""
    from ..ops.build import merge_postings_live

    if device is None:
        from ..utils.device import device as default_device

        device = default_device()
    device = torch.device(device)
    assert sources, "no sources"
    info = sources[0].info
    for s in sources[1:]:
        info = info.merge(s.info)
    metadata: Dict[str, str] = {}
    for s in sources:  # oldest -> newest, newest key wins
        metadata.update(s.metadata)

    # Profiler spans (utils/profiling): the device work is asynchronous, so
    # "merge" holds its launches and "copy_back" the wait for it.
    newer = _newer_docs(collection, info)
    with trace("device_merge.pack"):
        packed = _pack_for_merge(sources, device, newer)
    with trace("device_merge.merge"):
        h, d, n_kept, out_id, out_alive, n_docs = merge_postings_live(*packed, n_run=len(sources))
    with trace("device_merge.copy_back"):
        # Back through pinned buffers behind one event: the only host sync
        # below ops/build.SORT_PART postings (a split sort adds one per part).
        outs = (h, d, out_id, out_alive, torch.stack([n_kept, n_docs]))
        if device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
            for dst, src in zip(host, outs):
                dst.copy_(src, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
        else:
            host = list(outs)
        del packed, h, d, out_id, out_alive, outs
        h, d, out_id, out_alive, counts = (t.numpy() for t in host)
        n_kept, n_docs = int(counts[0]), int(counts[1])
        hashes = h[:n_kept].view(np.uint32).copy()
        docids = d[:n_kept].view(np.uint32).copy()
        docs_ids = out_id[:n_docs].view(np.uint32).copy()
        docs_alive = out_alive[:n_docs].astype(bool)

    return Segment(
        info=info,
        hashes=hashes,
        docids=docids,
        docs_ids=docs_ids,
        docs_alive=docs_alive,
        min_doc_id=int(docs_ids[0]) if docs_ids.shape[0] else 0,
        max_doc_id=int(docs_ids[-1]) if docs_ids.shape[0] else 0,
        metadata=tuple(metadata.items()),
    )


"""Query pipeline: preprocessing, batched launch on the card, result
materialization (counterpart of acoustid_index_tpu/engine/searcher.py).

Queries are sorted and de-duplicated up front (a duplicate query hash
counts once, as in the reference's IndexReader.search) and padded to a
query bucket.  The BatchingSearcher keeps the reference's pipeline: a
dispatcher thread packs concurrent requests into one batch and launches it
on a searcher-owned CUDA stream, inside the span `search_dispatch`
(utils/profiling.trace; `search_dispatch[rows/batch]` on a capture's
timeline); collector threads wait on each
batch's event and hand rows back to the callers.

What the port leaves out: the reference's background precompiler, its
superset-bucket program choice and its warm-up launches exist to hide XLA
compile latency.  PyTorch runs eagerly and the kernels build once per
process at first use, so a cold shape costs nothing here: `warm` and
`warm_async` are no-ops, and a batch pads plainly to the next BATCH_SIZES
entry.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.layout import postings_cap
from ..ops.search_kernel import SearchParams, search_segments_batch_packed_io
from ..server import metrics
from ..utils.profiling import trace
from .errors import SearchTimeout
from .model import SearchOptions, SearchResult
from .segments import FILE_SLOTS, MEMORY_SLOTS, Snapshot, pack_tier, tier_view_for_search

QUERY_BUCKETS = (64, 128, 256, 1024, 4096)  # 128: real fingerprint queries run ~120 hashes
MAX_QUERY_HASHES = QUERY_BUCKETS[-1]

# The HTTP API caps limit at 100 (-> the 128 bucket); the legacy protocol's
# 500 default needs the second bucket.  Limits beyond the last bucket clamp.
OUT_BUCKETS = (128, 512)
MAX_RESULTS = OUT_BUCKETS[-1]

BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
MAX_BATCH = BATCH_SIZES[-1]


@dataclass(frozen=True)
class SearchStats:
    postings_scanned: int
    truncated: bool
    max_per_hash: int = 0  # max postings one query hash scanned (both tiers)
    max_blocks_per_hash: int = 0  # max BLOCKs one hash's run spanned


def _out_bucket_for(limit: int) -> int:
    return next(b for b in OUT_BUCKETS if b >= min(limit, MAX_RESULTS))


def _params_for(q_bucket: int, out_bucket: int = 128) -> SearchParams:
    """The reference's serving parameters for a query/output bucket."""
    return SearchParams(
        query_len=q_bucket,
        postings_budget=min(max(1024, q_bucket * 4), 16384),
        per_hash_cap=1024,
        candidate_cap=256 if out_bucket <= 128 else 2 * out_bucket,
        out_len=out_bucket,
    )


def _materialize_row(row, out_len: int):
    """Parse one packed output row (see ops.search_kernel.pack_outputs)."""
    n = int(row[2 * out_len])
    results = [SearchResult(id=int(row[i]), score=int(row[out_len + i])) for i in range(n)]
    stats = SearchStats(
        postings_scanned=int(row[2 * out_len + 1]),
        truncated=bool(row[2 * out_len + 2]),
        max_per_hash=int(row[2 * out_len + 3]),
        max_blocks_per_hash=int(row[2 * out_len + 4]),
    )
    return results, stats


def _pack_rows(params: SearchParams, rows, b: int) -> np.ndarray:
    """Pre-built (Q+4) u32 request rows (a list of rows, or an (n, Q+4)
    array as the native front hands them over) -> ONE (b, Q+4) u32 input
    array."""
    Q = params.query_len
    packed = np.zeros((b, Q + 4), np.uint32)
    packed[:, Q + 1] = 1  # limit >= 1 for padding rows
    if len(rows):
        packed[: len(rows)] = rows
    return packed


def _batch_size(n: int) -> int:
    """The smallest BATCH_SIZES entry that holds n requests (n <= MAX_BATCH)."""
    return next(b for b in BATCH_SIZES if b >= n)


class Searcher:
    """Owns the device layout of segment views and launches the search
    program.  The engine calls pack_file_tier/pack_mem_tier whenever a
    tier's segment set changes (file tier at checkpoint/merge, memory tier
    per write)."""

    def __init__(self, device=None):
        from ..utils.device import device as default_device

        self.device = torch.device(device) if device is not None else default_device()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._lock = threading.Lock()
        # Sticky high-water shapes per (owner index, tier): [postings cap,
        # docs cap, mention cap, slots].  Capacities only grow, so a
        # write-heavy index stops reallocating every half-octave of growth.
        self._hwm: Dict[tuple, list] = {}

    def _pack_sticky(self, segments, slots_cap: int, tier: str, owner) -> Dict:
        with self._lock:
            hwm = list(self._hwm.get((owner, tier), (1024, 1024, 1024, 0)))
        view = pack_tier(
            segments,
            slots_cap,
            min_slots=hwm[3],
            min_caps=(hwm[0], hwm[1], hwm[2]),
            device_mentions=(tier == "mem"),  # only the memory tier's is read
            device=self.device,
        )
        grown = (
            postings_cap(view),
            int(view["docs_ids"].shape[0]),
            int(view["mention_ids"].shape[0]),
            int(view["seg_start"].shape[0]),
        )
        with self._lock:
            cur = self._hwm.setdefault((owner, tier), [1024, 1024, 1024, 0])
            for i in range(4):
                cur[i] = max(cur[i], grown[i])
        view["owner"] = owner
        return view

    def pack_file_tier(self, segments, owner=None) -> Dict:
        return self._pack_sticky(segments, FILE_SLOTS, "file", owner)

    def pack_mem_tier(self, segments, owner=None) -> Dict:
        return self._pack_sticky(segments, MEMORY_SLOTS, "mem", owner)

    def prepare_query(self, query: Sequence[int]) -> Tuple[np.ndarray, int]:
        q = np.asarray(query, dtype=np.uint32)
        n = q.shape[0]
        if n > 1:
            q = np.sort(q)
            keep = np.empty(n, bool)
            keep[0] = True
            np.not_equal(q[1:], q[:-1], out=keep[1:])
            q = q[keep]
        if q.shape[0] > MAX_QUERY_HASHES:
            q = q[:MAX_QUERY_HASHES]
        return q, int(q.shape[0])

    def _row(self, q: np.ndarray, q_len: int, options: SearchOptions) -> Tuple[np.ndarray, int, int]:
        """(request row = queries | len | limit | min_score | pct, query
        bucket, out bucket)."""
        bucket = next(b for b in QUERY_BUCKETS if b >= q_len)
        row = np.zeros(bucket + 4, dtype=np.uint32)
        row[:q_len] = q
        row[bucket:] = (q_len, options.max_results, options.min_score, options.min_score_pct)
        return row, bucket, _out_bucket_for(options.max_results)

    def search(
        self,
        snapshot: Snapshot,
        query: Sequence[int],
        options: SearchOptions,
        deadline: Optional[float] = None,
    ) -> Tuple[List[SearchResult], SearchStats]:
        assert isinstance(snapshot.mem_view, dict) or snapshot.mem_view is None, (
            "unresolved deferred view: search must go through Index.ensure_views"
        )
        q, q_len = self.prepare_query(query)
        if q_len == 0 or snapshot.file_view is None or snapshot.mem_view is None:
            return [], SearchStats(0, False)
        row, bucket, out_bucket = self._row(q, q_len, options)
        params = _params_for(bucket, out_bucket)
        packed = self._fetch(self._launch(snapshot, params, _pack_rows(params, [row], 1)))
        return _materialize_row(packed[0], params.out_len)

    def submit(self, snapshot, query, options, deadline=None):
        """Future-returning form; the plain searcher resolves synchronously."""
        return _ImmediateResult(self.search(snapshot, query, options, deadline))

    _pack_rows = staticmethod(_pack_rows)

    @staticmethod
    def _pick_batch_size(n: int) -> int:
        """Launch size for a chunk of n claimed rows (the native front's
        chunking hook): every shape is as good as any other here, so the
        smallest BATCH_SIZES entry that holds them, capped at MAX_BATCH."""
        return _batch_size(min(n, MAX_BATCH))

    def warm_async(self, snapshot) -> None:
        """No-op: nothing compiles per shape (see the module docstring)."""

    def warm(self, snapshot, *args, **kwargs) -> None:
        """No-op: nothing compiles per shape (see the module docstring)."""

    def _launch(self, snapshot, params: SearchParams, packed_in: np.ndarray):
        """Run the batched program; returns a handle for _fetch.  On a card
        the work is queued on the searcher's stream and the packed output
        copied into pinned host memory behind an event."""
        file_view, mem_view = self._search_views(snapshot)
        inp = torch.from_numpy(np.ascontiguousarray(packed_in).view(np.int32))
        if self._stream is None:
            out = self._program(params, file_view, mem_view, inp.to(self.device))
            return out.cpu().numpy().view(np.uint32)
        with torch.cuda.stream(self._stream):
            out = self._program(params, file_view, mem_view, inp.to(self.device))
            host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return host, done

    @staticmethod
    def _search_views(snapshot):
        """The (file, mem) tier fields the batch program reads (parallel/
        serving.py's come per slot)."""
        return tier_view_for_search(snapshot.file_view, mentions=False), tier_view_for_search(snapshot.mem_view)

    @staticmethod
    def _program(params: SearchParams, file_view, mem_view, inp):
        """The batch program _launch queues: packed inputs in, packed
        outputs out (parallel/serving.py swaps in the sharded one)."""
        return search_segments_batch_packed_io(params, file_view, mem_view, inp)

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        host, done = handle
        done.synchronize()
        return host.numpy().view(np.uint32)


class _ImmediateResult:
    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class _PendingSearch:
    """A submitted search -- the future its caller waits on.

    State transitions (guarded by the searcher's queue lock):
      PENDING   -- sitting in the dispatch queue
      CLAIMED   -- packed into a batch that has been (or is being) launched
      ABANDONED -- deadline expired while still PENDING; the dispatcher drops it
    """

    PENDING, CLAIMED, ABANDONED = 0, 1, 2

    __slots__ = (
        "searcher", "key", "snapshot", "padded", "q_len", "options",
        "deadline", "state", "done", "row", "error", "direct",
    )

    def __init__(self, searcher, key, snapshot, padded, q_len, options, deadline):
        self.searcher = searcher
        self.key = key
        self.snapshot = snapshot
        self.padded = padded
        self.q_len = q_len
        self.options = options
        self.deadline = deadline
        self.state = self.PENDING
        self.done = threading.Event()
        self.row = None
        self.error = None
        self.direct = None  # short-circuit result (empty query)

    def result(self) -> Tuple[List[SearchResult], SearchStats]:
        return self.searcher._await(self)


class BatchingSearcher(Searcher):
    """Coalesces concurrent searches into batched launches and pipelines
    them: a DISPATCHER thread drains the request queue, packs same-group
    requests (same table views + query/out bucket) into the largest ready
    batch and launches it; COLLECTOR threads wait for each batch's results
    and resolve the callers' futures.  Up to MAX_IN_FLIGHT batches are
    launched and not yet collected."""

    MAX_IN_FLIGHT = int(os.environ.get("AITPU_SEARCH_IN_FLIGHT", "8"))
    COLLECTORS = int(os.environ.get("AITPU_SEARCH_COLLECTORS", "4"))
    # A dispatched batch must eventually resolve even with no deadline set.
    MAX_RESULT_WAIT = 300.0

    def __init__(self, max_wait: float = 0.002, device=None):
        super().__init__(device)
        self.max_wait = max_wait
        self._qlock = threading.Lock()
        self._qcond = threading.Condition(self._qlock)
        self._pending: List[_PendingSearch] = []
        self._inflight = 0  # launched, not yet collected (under _qlock)
        self._inflight_sem = threading.BoundedSemaphore(self.MAX_IN_FLIGHT)
        self._collect_q = None
        self._threads = None
        self._stopping = False
        # Requests resolved as expired before their batch launched, and
        # batches whose every member expired so the launch was skipped.
        self.abandoned_prelaunch = 0
        self.launches_skipped = 0

    # ---- submission ----

    def submit(
        self,
        snapshot: Snapshot,
        query: Sequence[int],
        options: SearchOptions,
        deadline: Optional[float] = None,
    ) -> _PendingSearch:
        """Enqueue a search; returns a future-like handle (`.result()`)."""
        assert isinstance(snapshot.mem_view, dict) or snapshot.mem_view is None, (
            "unresolved deferred view: search must go through Index.ensure_views"
        )
        q, q_len = self.prepare_query(query)
        if q_len == 0 or snapshot.file_view is None or snapshot.mem_view is None:
            req = _PendingSearch(self, None, None, None, 0, options, deadline)
            req.direct = ([], SearchStats(0, False))
            req.done.set()
            return req
        padded, bucket, out_bucket = self._row(q, q_len, options)
        key = (
            snapshot.file_view.get("view_token", id(snapshot.file_view)),
            snapshot.mem_view.get("view_token", id(snapshot.mem_view)),
            bucket,
            out_bucket,
        )
        req = _PendingSearch(self, key, snapshot, padded, q_len, options, deadline)
        with self._qcond:
            if self._stopping:
                req.error = RuntimeError("searcher closed")
                req.snapshot = None
                req.done.set()
                return req
            self._ensure_threads_locked()
            self._pending.append(req)
            self._qcond.notify()
        return req

    def search(self, snapshot, query, options, deadline=None):
        return self._await(self.submit(snapshot, query, options, deadline))

    def _await(self, req: _PendingSearch):
        if req.deadline is None:
            # No deadline: keep waiting on a healthy pipeline, but surface a
            # dead one as an error instead of blocking forever.
            while not req.done.wait(self.MAX_RESULT_WAIT):
                threads = self._threads
                if threads is None or not any(t.is_alive() for t in threads):
                    raise RuntimeError("batched search pipeline died")
        elif not req.done.wait(max(0.0, req.deadline - time.monotonic())):
            with self._qlock:
                if req.state == _PendingSearch.PENDING:
                    # Expired while still queued: refuse before launch.
                    req.state = _PendingSearch.ABANDONED
                    req.snapshot = None
            # The deadline is absolute: release the caller now, even if the
            # batch is claimed; the collector resolves it harmlessly later.
            raise SearchTimeout("search deadline expired while batched")
        if req.error is not None:
            raise req.error
        if req.direct is not None:
            return req.direct
        return _materialize_row(req.row, (req.row.shape[0] - 5) // 2)

    # ---- pipeline threads ----

    def _ensure_threads_locked(self) -> None:
        if self._threads is not None:
            return
        import queue

        self._collect_q = queue.Queue()
        ts = [threading.Thread(target=self._dispatch_loop, name="aitpu-dispatch", daemon=True)]
        for i in range(self.COLLECTORS):
            ts.append(threading.Thread(target=self._collect_loop, name=f"aitpu-collect-{i}", daemon=True))
        for t in ts:
            t.start()
        self._threads = ts
        # Drain the daemons at interpreter exit; unregistered by close().
        atexit.register(self.close)

    def close(self) -> None:
        """Stop the pipeline threads.  The dispatcher fails still-queued
        requests and enqueues the collector sentinels as its last act, so
        collectors drain every launched batch before exiting."""
        with self._qcond:
            if self._threads is None:
                return
            self._stopping = True
            self._qcond.notify_all()
            threads = self._threads
        threads[0].join(timeout=30)
        for t in threads[1:]:
            t.join(timeout=10)
        if not any(t.is_alive() for t in threads):
            with self._qcond:
                self._threads = None
                self._stopping = False
            atexit.unregister(self.close)

    def _purge_expired(self, batch: List[_PendingSearch]) -> List[_PendingSearch]:
        """Resolve claimed requests whose absolute deadline already passed
        and return the still-live remainder."""
        now = time.monotonic()
        if not any(r.deadline is not None and now >= r.deadline for r in batch):
            return batch
        live = []
        n_expired = 0
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                r.state = _PendingSearch.ABANDONED
                r.snapshot = None
                r.error = SearchTimeout("search deadline expired while batched")
                r.done.set()
                n_expired += 1
            else:
                live.append(r)
        self.abandoned_prelaunch += n_expired
        try:
            metrics.inc_searches_abandoned(n_expired)
        except Exception:  # noqa: BLE001 -- metrics never fail the op
            pass
        return live

    def _claim_locked(self, key=None, space=MAX_BATCH) -> List[_PendingSearch]:
        """Pop up to `space` same-group requests (group of the queue head
        when `key` is None).  Abandoned requests are dropped."""
        batch: List[_PendingSearch] = []
        keep = []
        for req in self._pending:
            if req.state == _PendingSearch.ABANDONED:
                continue
            if len(batch) < space and (key is None or req.key == key):
                if key is None:
                    key = req.key
                req.state = _PendingSearch.CLAIMED
                batch.append(req)
            else:
                keep.append(req)
        self._pending = keep
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            with self._qcond:
                while not self._pending and not self._stopping:
                    self._qcond.wait()
                if self._stopping:
                    for r in self._pending:
                        if r.state == _PendingSearch.PENDING:
                            r.error = RuntimeError("searcher closed")
                            r.done.set()
                    self._pending = []
                    for _ in range(self.COLLECTORS):
                        self._collect_q.put(None)
                    return
                batch = self._claim_locked()
                busy = bool(self._pending) or self._inflight > 0
            if not batch:
                continue
            key = batch[0].key
            # Coalesce: under load wait a moment for the batch to fill;
            # solo traffic launches at once.
            if len(batch) < MAX_BATCH and busy:
                t_end = time.monotonic() + self.max_wait
                while len(batch) < MAX_BATCH and time.monotonic() < t_end:
                    time.sleep(0.0002)
                    with self._qlock:
                        batch.extend(self._claim_locked(key, MAX_BATCH - len(batch)))
            self._inflight_sem.acquire()
            with self._qlock:
                batch.extend(self._claim_locked(key, MAX_BATCH - len(batch)))
                self._inflight += 1
            batch = self._purge_expired(batch)
            if not batch:
                with self._qlock:
                    self._inflight -= 1
                self._inflight_sem.release()
                self.launches_skipped += 1
                try:
                    metrics.inc_search_launches_skipped()
                except Exception:  # noqa: BLE001 -- metrics never fail the op
                    pass
                continue
            params = _params_for(key[2], key[3])
            b = _batch_size(len(batch))
            try:
                with trace("search_dispatch", (len(batch), b)):
                    handle = self._launch(batch[0].snapshot, params, _pack_rows(params, [r.padded for r in batch], b))
            except Exception as exc:  # noqa: BLE001 -- propagated per-request
                with self._qlock:
                    self._inflight -= 1
                self._inflight_sem.release()
                for r in batch:
                    r.error = exc
                    r.done.set()
                continue
            self._collect_q.put((handle, batch))

    def _collect_loop(self) -> None:
        while True:
            item = self._collect_q.get()
            if item is None:
                return
            handle, batch = item
            try:
                packed = self._fetch(handle)
                now = time.monotonic()
                for i, req in enumerate(batch):
                    if req.deadline is not None and now >= req.deadline:
                        # Landed past the absolute deadline: never serve late.
                        req.error = SearchTimeout("search deadline expired while batched")
                    else:
                        req.row = packed[i]
                    req.snapshot = None
                    req.done.set()
            except Exception as exc:  # noqa: BLE001 -- propagated per-request
                for req in batch:
                    req.error = exc
                    req.done.set()
            finally:
                with self._qlock:
                    self._inflight -= 1
                self._inflight_sem.release()


_default_searcher: Optional[Searcher] = None
_default_lock = threading.Lock()


def default_searcher() -> Searcher:
    global _default_searcher
    with _default_lock:
        if _default_searcher is None:
            _default_searcher = BatchingSearcher()
        return _default_searcher

"""One index: a WAL plus an immutable snapshot of segments, searched on
device.

Orchestration mirrors upstream fpindex's src/Index.zig with Python threading in
place of coroutines and immutable Python objects + GC in place of intrusive
refcounts:

  * readers grab `self._snapshot` (an immutable Snapshot) and search it with
    no lock; the single writer builds a new Snapshot and swaps the reference;
  * write path: build the memory segment BEFORE the durable oplog append (a
    build failure never leaves the log ahead of memory); the append is the
    commit point; the swap after it cannot fail;
  * a background maintenance thread cascades memory merges -> checkpoint ->
    file merges, level-triggered by an event and optionally by a checkpoint
    age timer;
  * checkpoint: memory segments merge into one file segment; the MANIFEST
    write is the durable commit point; the WAL is truncated after;
  * file merge: tiered-policy-selected adjacent range; retired segment files
    are deleted after the manifest commit (readers never touch disk — the
    arrays are RAM/HBM-resident — so deletion is immediate, unlike the
    reference's deferred delete_on_destroy).

Device views: the packed file-tier buffers are shared by reference across
snapshots and rebuilt only when the file set changes; the memory tier
repacks per write (bounded by the checkpoint threshold).

The port's copy of acoustid_index_tpu/engine/index.py: its relative imports
resolve to the port's own modules.  Every merge goes through
device_merge.merge_segments_auto, as in the reference: big runs merge on
the device, small ones on the host, and the index counts both routes and
any fallback from device to host in `merge_counts` (the metrics count
them too, the fold of a long WAL tail at open included).  A checkpoint's merge,
file write and tier pack are profiler spans (utils/profiling.trace), as are
an open's file reads, WAL replay and tier packs.  When the searcher's
device is a card, an open streams its file segments' bytes to the card and
builds the file tier there (engine/card_tier.py).  The
maintenance thread packs a bulk stream's deferred memory tier only after
IDLE_RESOLVE_S without a write; the reference packs it after every pass,
that is after nearly every batch of the stream.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from . import card_tier, filefmt, manifest
from ..server import metrics
from ..utils.profiling import bump, trace
from .device_merge import MergeCounts, merge_segments_auto
from .errors import SearchTimeout, VersionRequired
from .memseg import Segment, build_segment
from .merge_policy import TieredMergePolicy
from .model import Change, SearchOptions, SearchResult, SegmentInfo, Transaction
from .oplog import Oplog
from .searcher import Searcher, SearchStats, default_searcher
from .segments import FILE_SLOTS, MEMORY_SLOTS, PENDING_VIEW, Snapshot, pack_tier

log = logging.getLogger("acoustid_index_tpu_torch.index")


class Index:
    DEFAULT_CHECKPOINT_THRESHOLD = 100_000
    DEFAULT_CHECKPOINT_AGE = 60.0  # seconds; None disables
    IDLE_RESOLVE_S = 2.0  # seconds with no write before the maintenance thread packs a deferred memory tier

    def __init__(
        self,
        path: str,
        oplog: Oplog,
        snapshot: Snapshot,
        checkpoint_threshold: int,
        checkpoint_age: Optional[float],
        searcher: Optional[Searcher] = None,
    ):
        self.path = path
        self.data_dir = os.path.join(path, "data")
        self.oplog = oplog
        self.checkpoint_threshold = checkpoint_threshold
        self.checkpoint_age = checkpoint_age
        self.searcher = searcher or default_searcher()
        self.merge_counts = MergeCounts()

        self._write_lock = threading.RLock()
        self._snapshot_lock = threading.Lock()
        # Serializes lazy view resolution (see ensure_views) without
        # blocking writers: resolution packs + uploads, which can take
        # hundreds of ms at large memory tiers.
        self._view_lock = threading.Lock()
        self._snapshot = snapshot

        # Writer-owned bookkeeping (stable under the write lock).
        self.commit_id = snapshot.commit_id
        self.file_commit_id = snapshot.file_commit_id
        self.version = snapshot.version
        self.file_version = snapshot.file_version
        self.external_versions = snapshot.external_versions

        self._pending_since: Optional[float] = None
        # Serializes whole checkpoint attempts (merge+write+commit): a public
        # flush() racing the maintenance thread must not write the same
        # segment file name and have the loser's abort delete the winner's
        # manifest-committed file.
        self._checkpoint_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._maintenance: Optional[threading.Thread] = None
        self.on_commit = None  # hook for metrics / tests

        self.memory_merge_policy = TieredMergePolicy(
            max_segments=16,
            min_segment_size=100,
            max_segment_size=checkpoint_threshold,
            segments_per_merge=10,
            segments_per_level=5,
        )
        self.file_merge_policy = TieredMergePolicy(
            min_segment_size=100,
            max_segment_size=1_000_000_000,
            segments_per_merge=10,
            segments_per_level=10,
        )

        # Restart path: start compiling the serving program for the loaded
        # tiers before the first request arrives (see _swap).
        self.searcher.warm_async(snapshot)

    # ---- open / close ----

    @classmethod
    def open(
        cls,
        path: str,
        checkpoint_threshold: int = DEFAULT_CHECKPOINT_THRESHOLD,
        checkpoint_age: Optional[float] = DEFAULT_CHECKPOINT_AGE,
        sync: bool = True,
        load_concurrency: Optional[int] = None,
        searcher: Optional[Searcher] = None,
        load_semaphore: Optional[threading.Semaphore] = None,
    ) -> "Index":
        data_dir = os.path.join(path, "data")
        oplog_dir = os.path.join(path, "oplog")
        os.makedirs(data_dir, exist_ok=True)
        os.makedirs(oplog_dir, exist_ok=True)

        # 1. Load the manifest's file segments (concurrently: loads are
        # IO-bound whole-file reads).  `load_semaphore` is SHARED across
        # every index the manager opens so --load-concurrency N bounds the
        # TOTAL concurrent loads (the reference's single semaphore,
        # MultiIndex.zig:201-223) — not N per index.
        # On a card the segments' postings go there as the files hold them,
        # and the file tier is built there from them (card_tier).
        searcher = searcher or default_searcher()
        on_card = card_tier.on_card(searcher.device)
        infos = manifest.read_manifest(data_dir)
        if infos:

            def read(info):
                if on_card:
                    return card_tier.read_segment_card(data_dir, info, searcher.device)
                return filefmt.read_segment(data_dir, info)

            def load(info):
                if load_semaphore is None:
                    return read(info)
                with load_semaphore:
                    return read(info)

            workers = load_concurrency or min(8, len(infos))
            with trace("open.read"), ThreadPoolExecutor(max_workers=workers) as pool:
                file_segments = list(pool.map(load, infos))
            bump(card_tier.OPEN, "card_segments" if on_card else "host_segments", len(file_segments))
        else:
            file_segments = []

        file_commit_id = 0
        file_version = 0
        external = False
        for seg in file_segments:
            file_commit_id = max(file_commit_id, seg.info.last_commit_id())
            file_version = max(file_version, seg.info.effective_version())
            if seg.info.version is not None:
                external = True

        # 2. Replay the WAL tail (txn.id > file_commit_id) into memory
        # segments; checkpointed transactions still mark upstream-fed.
        memory_segments: List[Segment] = []
        state = {"external": external}

        def apply(txn: Transaction):
            if txn.version is not None:
                state["external"] = True
            if txn.id <= file_commit_id:
                return
            memory_segments.append(
                build_segment(txn.changes, SegmentInfo(commit_id=txn.id, merges=0, version=txn.version))
            )

        with trace("open.replay"):
            oplog = Oplog.open(oplog_dir, sync=sync, handler=apply)

        if len(memory_segments) > MEMORY_SLOTS - 8:
            # The replayed WAL tail can hold many transactions (one memory
            # segment each); the device view has static slots, so fold the
            # tail into one segment.  Supersession inside the fold needs the
            # whole collection as the oracle.
            whole = Snapshot(file=tuple(file_segments), memory=tuple(memory_segments))
            memory_segments = [merge_segments_auto(memory_segments, whole)]

        commit_id = max(file_commit_id, oplog.last_commit_id)
        version = max(file_version, oplog.last_version)
        # The WAL can hold less than the index (a bootstrap deletes it and
        # restores donor segments); seed it from the recovered maxima so the
        # next append keeps commit ids dense.
        oplog.last_commit_id = commit_id
        oplog.last_version = version

        with trace("open.pack"):
            file_view = searcher.pack_file_tier(file_segments, owner=path)
            mem_view = searcher.pack_mem_tier(memory_segments, owner=path)
        snapshot = Snapshot(
            file=tuple(file_segments),
            memory=tuple(memory_segments),
            commit_id=commit_id,
            file_commit_id=file_commit_id,
            version=version,
            file_version=file_version,
            external_versions=state["external"],
            file_view=file_view,
            mem_view=mem_view,
        )
        return cls(path, oplog, snapshot, checkpoint_threshold, checkpoint_age, searcher)

    def close(self) -> None:
        self.stop()
        self.oplog.close()

    # ---- maintenance thread ----

    def start(self) -> None:
        if self._maintenance is None:
            self._stop.clear()
            self._maintenance = threading.Thread(target=self._maintenance_loop, daemon=True, name=f"maint:{self.path}")
            self._maintenance.start()
            # Same exit-safety contract as the searcher pipeline: a daemon
            # maintenance thread mid-merge sits inside jax/pybind11 frames,
            # and CPython's pthread_exit unwind through them aborts the
            # process at shutdown.  Unregistered by stop().
            import atexit

            atexit.register(self.stop)

    def stop(self) -> None:
        if self._maintenance is not None:
            self._stop.set()
            self._wake.set()
            self._maintenance.join(timeout=120)
            self._maintenance = None
            import atexit

            atexit.unregister(self.stop)

    def _maintenance_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.checkpoint_age)
            self._wake.clear()  # reset before processing so a set() mid-pass isn't lost
            if self._stop.is_set():
                return
            try:
                self.run_maintenance(resolve_idle=False)
                # Idle means no write for IDLE_RESOLVE_S: a bulk stream's
                # next batch lands well within it (a write sets _wake), so
                # the deferred tier is packed once when the stream stops,
                # not after every batch (each pack re-sorts the whole tier:
                # quadratic over a stream of 2^30 postings).
                if not self._wake.wait(self.IDLE_RESOLVE_S) and not self._stop.is_set():
                    self._resolve_idle()
            except Exception:
                log.exception("maintenance failed")

    def run_maintenance(self, resolve_idle: bool = True) -> None:
        """Cascade pending work until nothing is left; with `resolve_idle`,
        then resolve a deferred memory-tier view."""
        while not self._stop.is_set():
            if self.merge_memory():
                continue
            if self.checkpoint(force=False):
                continue
            if self.merge_files():
                continue
            break
        if resolve_idle:
            self._resolve_idle()

    def _resolve_idle(self) -> None:
        # Cascade idle: if a bulk stream left the memory-tier view deferred,
        # resolve it NOW (fold + pack + background compile) so the stream's
        # first search doesn't pay all three inline and 503 on a cold shape.
        # The resolution cost is bounded by one pack per idle transition.
        if not self._stop.is_set():
            snap = self.acquire_reader()
            if snap.mem_view is PENDING_VIEW:
                self.ensure_views(snap)

    # ---- readers ----

    def acquire_reader(self) -> Snapshot:
        with self._snapshot_lock:
            return self._snapshot

    def ensure_views(self, snapshot: Snapshot) -> Snapshot:
        """Resolve a deferred memory-tier view (bulk-ingest path) exactly
        once per snapshot.  Cheap no-op when the view is already packed.

        A bulk stream can grow the segment list past the view's slot cap
        (update() skips the fold while the view is deferred); the first
        reader folds it here — ONE merge for the whole stream — and packs
        the folded tier.  The merged segment is also installed into the
        live tier when no writer raced, so subsequent snapshots carry it."""
        if snapshot.mem_view is PENDING_VIEW:
            with self._view_lock:
                if snapshot.mem_view is PENDING_VIEW:
                    memory = snapshot.memory
                    if len(memory) > MEMORY_SLOTS:
                        merged = merge_segments_auto(memory, snapshot, self.merge_counts)
                        with self._write_lock:
                            cur = self.acquire_reader()
                            if len(cur.memory) >= len(memory) and all(
                                a is b for a, b in zip(cur.memory[: len(memory)], memory)
                            ):
                                new_memory = (merged,) + cur.memory[len(memory):]
                                self._install_memory(cur, new_memory)
                        memory = (merged,)
                    view = self.searcher.pack_mem_tier(memory, owner=self.path)
                    object.__setattr__(snapshot, "mem_view", view)
                    self.searcher.warm_async(snapshot)
        return snapshot

    def search(self, query: Sequence[int], options: SearchOptions, deadline: Optional[float] = None):
        # The device program is bounded, so the timeout guards host-side
        # queueing (the reference's cancellation fires at scan yield points;
        # our scan is one kernel launch).  `deadline` is an absolute
        # monotonic timestamp taken when the request ENTERED the system;
        # checked before dispatch, so a request that queued past its
        # deadline is refused while a dispatched one finishes.
        snapshot = self.ensure_views(self.acquire_reader())
        if deadline is not None and time.monotonic() > deadline:
            raise SearchTimeout("search queued past its deadline")
        return self.searcher.search(snapshot, query, options, deadline=deadline)

    def search_async(self, query: Sequence[int], options: SearchOptions, deadline: Optional[float] = None):
        """Async form of search(): returns a future-like handle whose
        `.result()` yields (results, stats).  Lets one caller keep many
        searches in flight through the batching pipeline (open-loop load,
        bulk lookups)."""
        snapshot = self.ensure_views(self.acquire_reader())
        if deadline is not None and time.monotonic() > deadline:
            raise SearchTimeout("search queued past its deadline")
        return self.searcher.submit(snapshot, query, options, deadline=deadline)

    # ---- writer ----

    @contextlib.contextmanager
    def _update_locked(self):
        """The write lock for update(), its wait and hold as spans."""
        with trace("update.lock_wait"):
            self._write_lock.acquire()
        try:
            with trace("update.lock_hold"):
                yield
        finally:
            self._write_lock.release()

    def update(
        self,
        changes: Sequence[Change],
        expected_version: Optional[int] = None,
        version: Optional[int] = None,
    ) -> int:
        """Apply a batch; returns the new version. The oplog append is the
        commit point (Index.zig:515-587).  Spans: update.lock_wait and
        update.lock_hold (the write lock), and inside the hold
        update.memseg, update.oplog_append (WAL append + fsync) and
        update.memory_insert (the new memory tier's device view)."""
        with self._update_locked():
            # Once anything carries an upstream position, every later commit
            # needs one — a minted local version would advertise a watermark
            # the upstream never issued (Index.zig:525-534).
            if self.external_versions and version is None:
                raise VersionRequired("index is upstream-fed; local writes are not allowed")

            with trace("update.memseg"):
                seg = build_segment(changes, SegmentInfo())  # info stamped post-commit

            cur = self.acquire_reader()
            if len(cur.memory) >= MEMORY_SLOTS and cur.mem_view is not PENDING_VIEW:
                # Backpressure: the device view has a static slot count; fold
                # the memory tier before accepting more.  ONLY when the view
                # is live — a deferred (bulk-stream) tier has no device view,
                # so the slot cap does not bind: the list grows like the
                # reference's (it trims lazily too) and the fold happens once,
                # at the first reader (ensure_views) or checkpoint, instead
                # of a re-sort of the whole tier every MEMORY_SLOTS batches.
                self._merge_memory_locked(all_segments=True)
                cur = self.acquire_reader()

            with trace("update.oplog_append"):
                commit_id, resolved = self.oplog.append(changes, expected_version=expected_version, version=version)
            # `version`, not `resolved`: a local commit must stay unmarked or
            # the segment would look upstream-fed.
            from dataclasses import replace as _replace

            seg = _replace(seg, info=SegmentInfo(commit_id=commit_id, merges=0, version=version))
            new_memory = cur.memory + (seg,)
            self.external_versions = self.external_versions or version is not None
            # Bulk batches DEFER the memory-tier device packing to the first
            # reader (ensure_views): packing re-sorts the whole tier, and a
            # pure ingest stream repacking per batch is the dominant bulk
            # cost.  Small interactive writes keep the eager pack so a
            # write-then-search flow never pays it on the read path.
            from .model import BulkInsert

            # Defer also when the tier outgrew the slot cap under a bulk
            # stream: a non-bulk write landing mid-stream must not try to
            # pack >MEMORY_SLOTS segments eagerly.
            defer = (
                any(isinstance(c, BulkInsert) for c in changes)
                or len(new_memory) > MEMORY_SLOTS
            )
            with trace("update.memory_insert"):
                snap = Snapshot(
                    file=cur.file,
                    memory=new_memory,
                    commit_id=commit_id,
                    file_commit_id=self.file_commit_id,
                    version=resolved,
                    file_version=self.file_version,
                    external_versions=self.external_versions,
                    file_view=cur.file_view,  # shared: the write never touches the big buffer
                    mem_view=PENDING_VIEW
                    if defer
                    else self.searcher.pack_mem_tier(new_memory, owner=self.path),
                )
                self._swap(snap)
            self._wake.set()
            if self.on_commit:
                self.on_commit(self)
            return resolved

    def bulk_insert(
        self,
        ids,
        hashes,
        offsets=None,
        expected_version: Optional[int] = None,
        version: Optional[int] = None,
    ) -> int:
        """Columnar bulk ingest: one oplog commit for the whole batch, the
        segment built vectorized, device packing deferred to the first
        reader.  `hashes` is either a (n, k) fixed-width matrix (offsets
        None) or a flat array with u32 offsets[n+1] spans."""
        import numpy as np

        from .model import BulkInsert

        ids = np.ascontiguousarray(ids, dtype=np.uint32)
        hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
        if offsets is None:
            if hashes.ndim != 2 or hashes.shape[0] != ids.shape[0]:
                raise ValueError("without offsets, hashes must be (len(ids), k)")
            k = hashes.shape[1]
            offsets = np.arange(0, (ids.shape[0] + 1) * k, k, dtype=np.uint32)
            hashes = hashes.reshape(-1)
        return self.update(
            [BulkInsert(ids=ids, hashes=hashes, offsets=offsets)],
            expected_version=expected_version,
            version=version,
        )

    def _swap(self, snap: Snapshot) -> None:
        with self._snapshot_lock:
            self._snapshot = snap
        self.commit_id = snap.commit_id
        self.file_commit_id = snap.file_commit_id
        self.version = snap.version
        self.file_version = snap.file_version
        # Start compiling the serving program for any NEW view shapes now,
        # off the search path — the first search after a cold shape change
        # would otherwise pay the whole compile inline and time out
        # everything queued behind it.  One background launch per converged
        # shape set (sticky high-water shapes), deduped inside.
        self.searcher.warm_async(snap)

    # ---- maintenance ops ----

    def merge_memory(self) -> bool:
        """Maintenance-path memory merge: the MERGE runs outside the write
        lock (exactly like checkpoint's flush merge) so a multi-second fold
        never stalls concurrent updates — writers only APPEND to the memory
        suffix, so the merged prefix range stays stable; if a racing fold
        (update's slot-cap backpressure) swapped it out meanwhile, this
        result is simply dropped.  A doc superseded by a segment written
        DURING the merge stays in the merged output — query-time
        supersession (pack-time filtering + the mention membership test)
        still hides it, same as a reference merge racing writes."""
        cur = self.acquire_reader()
        mem = cur.memory
        cand = self.memory_merge_policy.should_merge([s.get_size() for s in mem])
        if cand is None:
            return False
        lo, hi = cand.start, cand.end
        merged = merge_segments_auto(mem[lo:hi], cur, self.merge_counts)
        with self._write_lock:
            cur2 = self.acquire_reader()
            if len(cur2.memory) < hi or any(
                a is not b for a, b in zip(cur2.memory[:hi], mem[:hi])
            ):
                return False  # a racing fold restructured the tier: drop
            new_memory = cur2.memory[:lo] + (merged,) + cur2.memory[hi:]
            self._install_memory(cur2, new_memory)
        log.info("merged %d memory segments -> %s (%d items)", hi - lo, merged.info, merged.num_items)
        return True

    def _merge_memory_locked(self, all_segments: bool = False) -> bool:
        cur = self.acquire_reader()
        mem = cur.memory
        sizes = [s.get_size() for s in mem]
        if all_segments:
            if len(mem) < 2:
                return False
            lo, hi = 0, len(mem)
        else:
            cand = self.memory_merge_policy.should_merge(sizes)
            if cand is None:
                return False
            lo, hi = cand.start, cand.end
        merged = merge_segments_auto(mem[lo:hi], cur, self.merge_counts)
        self._install_memory(cur, mem[:lo] + (merged,) + mem[hi:])
        log.info("merged %d memory segments -> %s (%d items)", hi - lo, merged.info, merged.num_items)
        return True

    def _install_memory(self, cur: Snapshot, new_memory) -> None:
        """Swap in a restructured memory tier (caller holds _write_lock or
        is single-threaded bootstrap)."""
        snap = Snapshot(
            file=cur.file,
            memory=new_memory,
            commit_id=self.commit_id,
            file_commit_id=self.file_commit_id,
            version=self.version,
            file_version=self.file_version,
            external_versions=self.external_versions,
            file_view=cur.file_view,
            # Mid-bulk-stream (deferred view) folds stay deferred: repacking
            # the whole tier per fold would make a pure ingest stream
            # quadratic in pack work; the first reader pays it once.
            mem_view=PENDING_VIEW
            if cur.mem_view is PENDING_VIEW
            else self.searcher.pack_mem_tier(new_memory, owner=self.path),
        )
        self._swap(snap)
        metrics.inc_memory_merges()

    def checkpoint(self, force: bool = False) -> bool:
        """Flush all memory segments to one file segment; the manifest write
        is the durable commit; truncate the WAL after."""
        with self._checkpoint_lock:
            return self._checkpoint_locked(force)

    def _checkpoint_locked(self, force: bool) -> bool:
        cur = self.acquire_reader()
        flush_count = len(cur.memory)
        if flush_count == 0:
            self._pending_since = None
            return False
        if self._pending_since is None:
            self._pending_since = time.monotonic()
        over = sum(s.get_size() for s in cur.memory) > self.checkpoint_threshold
        aged = (
            self.checkpoint_age is not None
            and (time.monotonic() - self._pending_since) >= self.checkpoint_age
        )
        if not force and not over and not aged:
            return False

        # Merge outside the write lock; updates keep flowing (they append to
        # the memory suffix; the flushed prefix is stable).
        with trace("checkpoint.merge"):
            fseg = merge_segments_auto(cur.memory, cur, self.merge_counts)
        with trace("checkpoint.write"):
            filefmt.write_segment(self.data_dir, fseg)

        with self._write_lock:
            latest = self.acquire_reader()
            if (
                len(latest.memory) < flush_count
                or any(a is not b for a, b in zip(latest.memory[:flush_count], cur.memory))
            ):
                # A writer-side backpressure merge folded the prefix while we
                # were merging; drop this attempt and let the loop retry.
                filefmt.delete_segment_file(self.data_dir, fseg.info)
                return True
            kept = latest.memory[flush_count:]
            new_file = latest.file + (fseg,)
            with trace("checkpoint.pack"):
                snap = Snapshot(
                    file=new_file,
                    memory=kept,
                    commit_id=self.commit_id,
                    file_commit_id=max(self.file_commit_id, fseg.info.last_commit_id()),
                    version=self.version,
                    file_version=max(self.file_version, fseg.info.effective_version()),
                    external_versions=self.external_versions,
                    file_view=self.searcher.pack_file_tier(new_file, owner=self.path),
                    mem_view=self.searcher.pack_mem_tier(kept, owner=self.path),
                )
            manifest.write_manifest(self.data_dir, [s.info for s in new_file])  # COMMIT
            self._swap(snap)
            self._pending_since = None if not kept else time.monotonic()
            try:
                self.oplog.truncate(self.file_commit_id)
            except OSError:
                log.warning("oplog truncate failed", exc_info=True)
        metrics.inc_checkpoints()
        log.info("checkpointed to file segment %s (%d items)", fseg.info, fseg.num_items)
        return True

    def merge_files(self) -> bool:
        cur = self.acquire_reader()
        sizes = [s.get_size() for s in cur.file]
        cand = self.file_merge_policy.should_merge(sizes)
        if cand is None and len(cur.file) > FILE_SLOTS - 2:
            # Structural bound: the device view has static slots.  Pick the
            # CHEAPEST adjacent window rather than always [0, 10): the head
            # of the tier holds the biggest segments, and rewriting them on
            # every slot-pressure event is the O(N^2) cascade the tiered
            # policy exists to avoid.
            from .merge_policy import MergeCandidate

            w = min(len(cur.file), 10)
            best = min(range(len(cur.file) - w + 1), key=lambda i: sum(sizes[i : i + w]))
            cand = MergeCandidate(start=best, end=best + w, size=sum(sizes[best : best + w]))
        if cand is None:
            return False
        lo, hi = cand.start, cand.end
        if hi - lo < 2:
            return False

        retired = cur.file[lo:hi]
        fseg = merge_segments_auto(retired, cur, self.merge_counts)
        filefmt.write_segment(self.data_dir, fseg)

        with self._write_lock:
            latest = self.acquire_reader()
            # File segments only change on this (single) maintenance path, so
            # lo/hi remain valid; memory may have grown.
            new_file = latest.file[:lo] + (fseg,) + latest.file[hi:]
            snap = Snapshot(
                file=new_file,
                memory=latest.memory,
                commit_id=self.commit_id,
                file_commit_id=self.file_commit_id,
                version=self.version,
                file_version=self.file_version,
                external_versions=self.external_versions,
                file_view=self.searcher.pack_file_tier(new_file, owner=self.path),
                mem_view=latest.mem_view,
            )
            manifest.write_manifest(self.data_dir, [s.info for s in new_file])  # COMMIT
            self._swap(snap)
        # Retired files can go immediately: search reads RAM/HBM arrays, never
        # the files, and the manifest no longer references them.
        for s in retired:
            filefmt.delete_segment_file(self.data_dir, s.info)
        metrics.inc_file_merges()
        log.info("merged %d file segments -> %s (%d items)", hi - lo, fseg.info, fseg.num_items)
        return True

    def flush(self) -> None:
        """Flush everything to disk (used before snapshot install).

        checkpoint() can abort-and-return-True when a concurrent
        backpressure fold changed the memory prefix mid-merge, so a single
        forced call is not enough: loop until the memory tier is actually
        empty (callers treat flush() as "everything durable")."""
        while True:
            with self._write_lock:
                while self._merge_memory_locked(all_segments=True):
                    pass
            self.checkpoint(force=True)
            if not self.acquire_reader().memory:
                return

"""Device pump for the native search-plane front end.

The C++ front end (csrc/aitpu_front.cc) owns the sockets and the entire
per-request host path: HTTP parsing, JSON/msgpack decode, sanitization,
query dedup, device-row packing, batching by (index, query bucket, out
bucket), response encoding, and absolute-deadline enforcement.  This module
is the other half: pump threads claim packed row batches over a C ABI and
LAUNCH them on the searcher's CUDA stream, collector threads wait on each
batch's event and hand packed output rows back — so launches pipeline with
in-flight transfers exactly like the Python dispatcher/collector split
(engine/searcher.py).

Python's per-REQUEST serving cost is zero; its per-BATCH cost is two ctypes
calls plus the searcher's launch.

Spans of the registry (utils/profiling), fixed names, per batch: the pump's
`pump.claim` (aitpu_front_next), `pump.batch` (from the claim's return to
the last chunk enqueued, with the thread's CPU time) and inside it
`pump.pack`, `pump.inflight_wait`, `pump.launch`, `pump.enqueue`; the
collectors' `collect.fetch` (the wait on the batch's event) and
`collect.complete` (serving histograms + aitpu_front_complete).  The C++
front's claim counters (batches, each claimed request's queue wait) are a
source of the registry's counters as `front.*`.

The port's copy of acoustid_index_tpu/server/native_front.py.  It differs
where the reference met JAX: no thread imports jax, the collectors fetch
through Searcher._fetch (a pinned host copy behind a CUDA event) in place of
jax.device_get, and chunks are sized by Searcher._pick_batch_size alone --
nothing compiles per shape here, so there is no warm-program bookkeeping.
The port's launch is not free to return at once as a JAX dispatch is: it
is eager host work under the interpreter lock plus two host syncs per batch
(the search program's branch predicates and its supersession gate) on the
searcher's one stream, so pumps cannot overlap their launches.  Hence the
default of ONE pump where the reference runs four: on an H100 with 256
closed-loop connections the front served the same ~60 batches per second
whatever the pump count, so more pumps only made each batch smaller --
1 pump 16,782 requests/s, 2 pumps 5,324, 4 pumps 1,720, 8 pumps 884
(chip_smoke.py's pumps sweep; see PERF.md).

The control plane (CRUD, updates, snapshots, replication, metrics scrape)
stays on the Python server; run both against one MultiIndex, like the
reference runs its legacy TCP protocol beside the REST API
(upstream fpindex's src/main.zig:137-141).
"""

from __future__ import annotations

import ctypes
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np

from ..engine import errors
from ..engine.searcher import MAX_BATCH, _params_for
from ..utils import profiling
from ..utils.native import front_lib
from ..utils.profiling import cpu_span, trace
from . import metrics

log = logging.getLogger("acoustid_index_tpu_torch.native_front")

ROW_WORDS_MAX = 4096 + 4  # largest query bucket + (len, limit, min_score, pct)
OUT_WORDS_MAX = 2 * 512 + 5  # largest out bucket, packed output row

# aitpu_front_stat indexes of the claim counters (csrc/aitpu_front.cc), by
# the registry's counter names; the queue-wait histogram's bins follow
# (metrics.FRONT_QUEUE_WAIT_BUCKETS and +Inf).
FRONT_STATS = {"front.batches": 6, "front.queue_wait_ns": 7, "front.queue_waits": 8}
FRONT_QUEUE_WAIT_BIN0 = 9


class NativeFront:
    """Runs aitpu_front on `port` and pumps its batches through `mi`."""

    def __init__(
        self,
        mi,
        port: int,
        pumps: int = 1,
        max_conns: int = 512,
        collectors: Optional[int] = None,
        max_inflight: int = 8,
    ):
        self.mi = mi
        self.port = port
        self.pumps = pumps
        self.collectors = collectors if collectors is not None else max(2, pumps)
        self.max_conns = max_conns
        self.lib = None
        self.handle = None
        self._threads = []
        self._collect_threads = []
        # Bounds launched-not-yet-fetched batches on the device queue,
        # shared across pumps (same role as the searcher's MAX_IN_FLIGHT).
        self._inflight = threading.BoundedSemaphore(max_inflight)
        self._cq: queue.Queue = queue.Queue()
        self._stopping = False

    def start(self) -> None:
        self.lib = front_lib()
        if self.lib is None:
            raise RuntimeError("native front library unavailable (compiler missing?)")
        h = self.lib.aitpu_front_start(self.port, self.max_conns)
        if h <= 0:
            raise RuntimeError(f"native front failed to bind port {self.port}")
        self.handle = h
        self.port = int(self.lib.aitpu_front_stat(h, 5))  # resolves port 0
        # aitpu_front_stat is an atomic load: through PyDLL it keeps the
        # interpreter lock, so reading the claim counters at a snapshot
        # hands the lock to no other thread.
        self._stat = ctypes.PyDLL(self.lib._name).aitpu_front_stat
        self._stat.restype, self._stat.argtypes = ctypes.c_int64, [ctypes.c_int64, ctypes.c_int32]
        self._source = f"front-{id(self)}"
        profiling.add_source(self._source, self.claim_counters)
        for i in range(self.collectors):
            t = threading.Thread(
                target=self._collect_loop, name=f"aitpu-pump-collect-{i}", daemon=True
            )
            t.start()
            self._collect_threads.append(t)
        for i in range(self.pumps):
            t = threading.Thread(target=self._pump_loop, name=f"aitpu-pump-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        log.info(
            "native search front listening on 127.0.0.1:%d (%d pumps, %d collectors)",
            self.port,
            self.pumps,
            self.collectors,
        )

    def stop(self) -> None:
        self._stopping = True
        if self.handle is not None:
            self.lib.aitpu_front_stop(self.handle)
        for t in self._threads:
            t.join(timeout=10)
        # Sentinels AFTER the pumps stop launching: FIFO puts them behind
        # the final launched batch, so collectors drain everything first.
        for _ in self._collect_threads:
            self._cq.put(None)
        for t in self._collect_threads:
            t.join(timeout=30)
        if self.handle is not None:
            profiling.remove_source(self._source)
        self.handle = None

    def stat(self, which: int) -> int:
        return int(self.lib.aitpu_front_stat(self.handle, which))

    def claim_counters(self) -> dict:
        """The C++ front's claim counters by the registry's names: batches
        claimed, the claimed requests' queue wait (ns summed, count) and
        its histogram (`front.queue_wait_bin.<i>`, per bin)."""
        stat, h = self._stat, self.handle
        out = {k: int(stat(h, i)) for k, i in FRONT_STATS.items()}
        for b in range(len(metrics.FRONT_QUEUE_WAIT_BUCKETS) + 1):
            out[f"front.queue_wait_bin.{b}"] = int(stat(h, FRONT_QUEUE_WAIT_BIN0 + b))
        return out

    # ---- pump ----

    def _pump_loop(self) -> None:
        u32 = ctypes.POINTER(ctypes.c_uint32)
        name_buf = (ctypes.c_uint8 * 256)()
        meta = np.zeros(4, np.uint32)
        rows = np.zeros(MAX_BATCH * ROW_WORDS_MAX, np.uint32)
        tokens = np.zeros(MAX_BATCH, np.uint64)
        meta_p = meta.ctypes.data_as(u32)
        rows_p = rows.ctypes.data_as(u32)
        tokens_p = tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

        while not self._stopping:
            with trace("pump.claim"):
                n = int(
                    self.lib.aitpu_front_next(
                        self.handle, name_buf, meta_p, rows_p, tokens_p, MAX_BATCH, 200
                    )
                )
            if n <= 0:
                if n < 0:
                    return  # stopping
                continue
            with cpu_span("pump.batch"):
                bucket = int(meta[0])
                out_bucket = int(meta[1])
                name = bytes(name_buf[: int(meta[2])]).decode("utf-8", "replace")
                batch_rows = rows[: n * (bucket + 4)].reshape(n, bucket + 4)
                try:
                    self._launch_group(name, bucket, out_bucket, batch_rows, tokens[:n])
                except errors.IndexError_ as exc:
                    self._fail(tokens[:n], exc.status, exc.name)
                except Exception as exc:  # noqa: BLE001 — per-batch isolation
                    log.exception("native pump batch failed", exc_info=exc)
                    self._fail(tokens[:n], 500, "InternalError")

    def _fail(self, tokens: np.ndarray, status: int, name: str) -> None:
        self.lib.aitpu_front_fail(
            self.handle,
            np.ascontiguousarray(tokens).ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(tokens),
            status,
            name.encode(),
        )

    def _fail_quiet(self, tokens: np.ndarray, status: int, name: str) -> None:
        """_fail that never raises: a _fail failure propagating out of a
        handler that already resolved part of its batch would make the
        caller re-fail the whole batch — and failing a token twice is a
        use-after-free on the C++ side (every claimed token must be
        returned through complete() or fail() exactly once)."""
        try:
            self._fail(tokens, status, name)
        except Exception:  # noqa: BLE001 — the tokens time out client-side
            log.exception("native front fail() failed; %d requests will time out", len(tokens))

    def _launch_group(self, name, bucket, out_bucket, batch_rows, tokens) -> None:
        """Claims one (index, bucket) group: launches warm-sized chunks and
        hands the device handles to the collectors.  Launch only — the
        fetch happens in _collect_loop, so chunk N+1's transfer overlaps
        chunk N's execution and the pumps never hold a round trip."""
        mi = self.mi
        ref = mi._get_ref(name)  # raises IndexNotFound
        try:
            if mi.replication is not None and mi.replication.is_bootstrapping(name):
                raise errors.IndexNotReady(name)
            index = ref.index
            searcher = index.searcher
            snapshot = index.ensure_views(index.acquire_reader())
            n = batch_rows.shape[0]
            metrics.inc_searches(name, n)
            params = _params_for(bucket, out_bucket)
            out_words = 2 * out_bucket + 5
            if snapshot.file_view is None or snapshot.mem_view is None:
                out = np.zeros((n, out_words), np.uint32)
                self._complete(name, tokens.copy(), out, out_words)
                return
            done = 0
            while done < n:
                # Chunks already handed to the collectors (tokens[:done])
                # will be resolved there; a failure mid-group must fail
                # ONLY the remainder — failing a token twice is a
                # use-after-free on the C++ side (aitpu_front.cc: every
                # claimed token is returned through complete() or fail()
                # exactly once).
                try:
                    with trace("pump.pack"):
                        chunk = batch_rows[done:]
                        b = searcher._pick_batch_size(chunk.shape[0])
                        m = min(chunk.shape[0], b)
                        packed = searcher._pack_rows(params, chunk[:m], b)
                    with trace("pump.inflight_wait"):
                        self._inflight.acquire()
                    # The inflight permit transfers to the collector only
                    # when the handle is ENQUEUED; a failure anywhere in
                    # between (launch, even cq.put) must release it here or
                    # the budget shrinks permanently.
                    enqueued = False
                    try:
                        with trace("pump.launch"):
                            handle = searcher._launch(snapshot, params, packed)
                        # tokens is a reused per-pump buffer: copy the
                        # slice, the next claim overwrites it while the
                        # collector still needs these values.
                        with trace("pump.enqueue"):
                            self._cq.put(
                                (name, searcher, handle, tokens[done : done + m].copy(), out_words, time.monotonic())
                            )
                        enqueued = True
                    finally:
                        if not enqueued:
                            self._inflight.release()
                except errors.IndexError_ as exc:
                    # _fail_quiet: tokens[:done] are already queued/resolved;
                    # an exception escaping here would make the pump's outer
                    # handler fail them AGAIN (double-resolution UAF).
                    self._fail_quiet(tokens[done:n], exc.status, exc.name)
                    return
                except Exception as exc:  # noqa: BLE001 — per-batch isolation
                    log.exception("native pump chunk failed", exc_info=exc)
                    self._fail_quiet(tokens[done:n], 500, "InternalError")
                    return
                done += m
        finally:
            mi._release_ref(ref)

    def _collect_loop(self) -> None:
        while True:
            item = self._cq.get()
            if item is None:
                return
            name, searcher, handle, toks, out_words, t_launch = item
            try:
                with trace("collect.fetch"):
                    out = searcher._fetch(handle)[: len(toks)]
                with trace("collect.complete"):
                    self._complete(name, toks, out, out_words)
                    # Every request in the batch experienced the full
                    # launch-to-fetch wall time (C++-side queueing excluded);
                    # dividing by batch size would understate latency ~250x.
                    metrics.observe_search_seconds(
                        name, time.monotonic() - t_launch, n=len(toks)
                    )
            except Exception as exc:  # noqa: BLE001 — per-batch isolation
                log.exception("native collect batch failed", exc_info=exc)
                self._fail(toks, 500, "InternalError")
            finally:
                self._inflight.release()

    def _complete(self, name: str, tokens: np.ndarray, out: np.ndarray, out_words: int) -> None:
        out = np.ascontiguousarray(out, dtype=np.uint32)
        assert out.shape[1] == out_words, (out.shape, out_words)
        # Serving metrics from the packed rows (vectorized, per batch; row
        # layout: ids | scores | count | postings | truncated | max_ph |
        # max_blocks — see ops.search_kernel.pack_outputs).
        counts = out[:, out_words - 5]
        hits = int(np.count_nonzero(counts))
        if hits:
            metrics.inc_search_hit(name, hits)
        if len(tokens) - hits:
            metrics.inc_search_miss(name, len(tokens) - hits)
        metrics.observe_postings_scanned_many(out[:, out_words - 4])
        metrics.observe_max_postings_per_hash_many(out[:, out_words - 2])
        metrics.observe_scanned_blocks_per_hash_many(out[:, out_words - 1])
        self.lib.aitpu_front_complete(
            self.handle,
            np.ascontiguousarray(tokens).ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(tokens),
            out_words,
        )

"""The program's one registry of spans and counters, and its profiler hooks
(counterpart of acoustid_index_tpu/utils/profiling.py).

  * `trace(name)` opens a host span: its wall time (ns, on the host's
    monotonic clock) and its count add to per-name totals.  Only while a
    `capture` runs does it also enter `torch.profiler.record_function`,
    so that the span lies on the Chrome trace's timeline beside the
    card's kernels; with no capture it makes no profiler call and builds
    no string.  `trace(name, detail)` names that range `name[d0/d1/...]`
    from the tuple `detail` (the dispatcher's `search_dispatch`);
    `cpu_span(name)` also adds the thread's CPU time, read on one span
    in CPU_EVERY: all of the thread's CPU time since its previous reading
    counts there (wall minus CPU is the time the thread was not running:
    waiting for the interpreter lock or a core).
  * `counters(group, keys)` registers a plain dict of counters (the
    program's `ops/search_kernel.STATS`, `ops/block_lookup.LAUNCHES`),
    `bump` increments one under the registry's single lock, and
    `add_source(key, fn)` adds counters read at snapshot time (the native
    front's C++ counters), outside that lock.
  * `totals()` reads every span and counter; the registry also keeps one
    cumulative snapshot per second in a bounded ring, taken by the first
    span that closes in a new second (no thread of its own), and
    `capture` records its start time and the totals at its start and
    stop.  `window(s)` gives the totals over the `s` seconds that ended
    when the last capture began: what a traced benchmark run reads as
    its untraced stretch.
  * `capture(log_dir)` records CPU and CUDA activity into a Chrome trace
    under `log_dir`;
  * `start_profiler_server(port)` (`--profile-port`) is the counterpart of
    the reference's jax.profiler live server, which torch lacks: a
    listener on 127.0.0.1 whose `GET /capture?ms=N` runs `capture` over
    the live process for N ms and answers with the Chrome trace.

A closed span costs one append to a queue, which needs no lock; a reader
folds the queue into the totals.  That, and reading the thread CPU clock
on one `cpu_span` in CPU_EVERY, keeps the served path's cost down: on a
loaded host each Python call or dictionary lookup costs microseconds, and
the thread CPU clock (a system call) tens of them.  Server/metrics
exports the totals on /_metrics.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import logging
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import torch

log = logging.getLogger("acoustid_index_tpu_torch.profiling")

SNAP_STEP_NS = 1_000_000_000  # one cumulative snapshot per second
SNAP_RING = 120  # two minutes of them
CPU_EVERY = 16  # a cpu_span reads its thread's CPU clock on one exit in 16

_perf_ns = time.perf_counter_ns
_thread_ns = time.thread_time_ns


class Registry:
    """Span totals by name (wall ns, count, thread CPU ns), counters by
    `group.key`, the ring of cumulative snapshots and the last capture's
    bounds."""

    def __init__(self, step_ns: int = SNAP_STEP_NS, ring: int = SNAP_RING):
        self.lock = threading.Lock()
        self.capturing = 0  # captures whose profiler is recording
        self.next_snap = 0  # perf_counter_ns at which the next snapshot is due
        self.last_capture: Optional[dict] = None
        self._step = step_ns
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self.closed: collections.deque = collections.deque()  # (name, wall_ns, cpu_ns) not yet folded
        self._spans: Dict[str, list] = {}  # name -> [wall_ns, count, cpu_ns], folded
        self._groups: Dict[str, dict] = {}
        # One reader at a time folds the queue and reads the sources, under
        # a lock of its own: `bump` (on the pump's path) waits only for
        # `lock`, which a reader holds just to copy the counters.
        self._read_lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Dict[str, int]]] = {}
        self._retired_counters: Dict[str, int] = {}

    # ---- spans (no lock: deque appends are atomic) ----

    def add(self, name: str, ns: int, cpu_ns: int, t_end: int) -> None:
        """Add one span of `name` that ended at `t_end` (what a span's exit does)."""
        self.closed.append((name, ns, cpu_ns))
        if t_end >= self.next_snap:
            self.snap(t_end)

    # ---- counters ----

    def counters(self, group: str, initial: Dict[str, int]) -> Dict[str, int]:
        """Register `initial` (a plain dict, returned as it is) as the
        counters `group.<key>`."""
        with self.lock:
            self._groups[group] = initial
        return initial

    def bump(self, d: Dict[str, int], key: str, n: int = 1) -> None:
        with self.lock:
            d[key] += n

    def add_source(self, key: str, fn: Callable[[], Dict[str, int]]) -> None:
        """Counters that `fn()` reads at each snapshot (cumulative values,
        by name); sources of one name add up."""
        with self._read_lock:
            self._sources[key] = fn

    def remove_source(self, key: str) -> None:
        """Stop reading `key`; its last values stay in the totals."""
        with self._read_lock:
            fn = self._sources.pop(key, None)
            if fn is not None:
                last = fn()
                with self.lock:
                    for k, v in last.items():
                        self._retired_counters[k] = self._retired_counters.get(k, 0) + v

    # ---- reading ----

    def _fold_locked(self) -> None:  # under _read_lock
        closed, spans = self.closed, self._spans
        for _ in range(len(closed)):
            name, ns, cpu_ns = closed.popleft()
            v = spans.get(name)
            if v is None:
                spans[name] = [ns, 1, cpu_ns]
            else:
                v[0] += ns
                v[1] += 1
                v[2] += cpu_ns

    def totals(self) -> dict:
        """{"spans": {name: (wall_ns, count, cpu_ns)}, "counters": {name: n}}."""
        with self._read_lock:
            self._fold_locked()
            spans = {k: tuple(v) for k, v in self._spans.items()}
            with self.lock:
                counters = dict(self._retired_counters)
                for group, d in self._groups.items():
                    for k, v in dict(d).items():
                        counters[f"{group}.{k}"] = v
            for fn in self._sources.values():
                for k, v in fn().items():
                    counters[k] = counters.get(k, 0) + v
        return {"spans": spans, "counters": counters}

    def _keep(self, t: int, tot: dict) -> None:
        with self.lock:
            self._ring.append((t, tot))

    def snap(self, t: int) -> None:
        with self.lock:
            if t < self.next_snap:
                return
            self.next_snap = t - t % self._step + self._step
        self._keep(t, self.totals())

    def capture_started(self) -> None:
        t = _perf_ns()
        start = self.totals()
        self.last_capture = {"start_ns": t, "start": start}
        self._keep(t, start)

    def capture_stopped(self) -> None:
        if self.last_capture is not None:
            self.last_capture.update(stop_ns=_perf_ns(), stop=self.totals())

    def window(self, seconds: float) -> Optional[dict]:
        """The totals over the `seconds` that ended when the last capture
        began (None before any capture): {"seconds": the stretch covered,
        "spans": {name: {"s", "n", "cpu_s"}}, "counters": {name: n}}.  Its
        start is interpolated between the two snapshots around it."""
        cap = self.last_capture
        if cap is None:
            return None
        t_end, end = cap["start_ns"], cap["start"]
        with self.lock:
            ring = sorted(((t, tot) for t, tot in self._ring if t <= t_end), key=lambda x: x[0])
        if not ring:
            return None
        t0 = t_end - int(seconds * 1e9)
        before = [(t, tot) for t, tot in ring if t <= t0]
        after = [(t, tot) for t, tot in ring if t > t0]
        if not before:
            t_start, start = after[0]
        elif not after:
            t_start, start = before[-1]
        else:
            (ta, a), (tb, b) = before[-1], after[0]
            t_start, start = t0, _lerp(a, b, (t0 - ta) / (tb - ta))
        d = _delta(start, end)
        return {
            "seconds": (t_end - t_start) / 1e9,
            "spans": {k: {"s": v[0] / 1e9, "n": v[1], "cpu_s": v[2] / 1e9} for k, v in d["spans"].items()},
            "counters": d["counters"],
        }


def _lerp(a: dict, b: dict, f: float) -> dict:
    spans = {}
    for k, vb in b["spans"].items():
        va = a["spans"].get(k, (0, 0, 0))
        spans[k] = tuple(x + (y - x) * f for x, y in zip(va, vb))
    counters = {k: a["counters"].get(k, 0) + (v - a["counters"].get(k, 0)) * f for k, v in b["counters"].items()}
    return {"spans": spans, "counters": counters}


def _delta(a: dict, b: dict) -> dict:
    spans = {}
    for k, vb in b["spans"].items():
        va = a["spans"].get(k, (0, 0, 0))
        spans[k] = tuple(y - x for x, y in zip(va, vb))
    counters = {k: v - a["counters"].get(k, 0) for k, v in b["counters"].items()}
    return {"spans": spans, "counters": counters}


REGISTRY = Registry()


_close = REGISTRY.closed.append
_cpu = threading.local()  # a thread's cpu_span exits (n) and last CPU clock reading (last)


class _Span:
    """A host span of REGISTRY (see `trace`).  The class itself is the
    factory; with no capture running its exit reads the clock and appends
    to the registry's queue, and nothing else."""

    __slots__ = ("name", "detail", "t0", "rf")

    def __init__(self, name: str, detail=None):
        self.name = name
        self.detail = detail

    def __enter__(self):
        if REGISTRY.capturing:
            d = self.detail
            self.rf = torch.profiler.record_function(self.name if d is None else f"{self.name}[{'/'.join(map(str, d))}]")
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = _perf_ns()
        return self

    def __exit__(self, et, ev, tb):
        t1 = _perf_ns()
        _close((self.name, t1 - self.t0, 0))
        if self.rf is not None:
            self.rf.__exit__(et, ev, tb)
        if t1 >= REGISTRY.next_snap:
            REGISTRY.snap(t1)
        return False


class _CpuSpan(_Span):
    """A span that also totals its thread's CPU time (see `cpu_span`)."""

    __slots__ = ()

    def __exit__(self, et, ev, tb):
        t1 = _perf_ns()
        c = _cpu
        try:
            c.n += 1
        except AttributeError:
            c.n, c.last = 0, _thread_ns()
        cpu_ns = 0
        if c.n % CPU_EVERY == 0:
            now = _thread_ns()
            cpu_ns, c.last = now - c.last, now
        _close((self.name, t1 - self.t0, cpu_ns))
        if self.rf is not None:
            self.rf.__exit__(et, ev, tb)
        if t1 >= REGISTRY.next_snap:
            REGISTRY.snap(t1)
        return False


# trace(name[, detail]): a host span `name`, totals always, a profiler
# range during a capture only (named `name[d0/d1/...]` from the tuple
# `detail`).  Modules import it by name (benchmark_torch/tracing.py's
# SpanTimer swaps the attribute to time a restart's spans).
trace = _Span
# cpu_span(name): trace(name) that also totals the thread's CPU time: on
# one exit in CPU_EVERY, the thread's CPU time since its previous reading.
cpu_span = _CpuSpan


counters = REGISTRY.counters
bump = REGISTRY.bump
add_source = REGISTRY.add_source
remove_source = REGISTRY.remove_source
totals = REGISTRY.totals
window = REGISTRY.window


@contextlib.contextmanager
def capture(log_dir: str):
    """Capture a programmatic trace of the block into `log_dir` as a Chrome
    trace (trace-<ns>.json); yields the profiler.  Every thread is
    recorded: the searcher dispatches from its own thread.  The
    registry's spans enter the profiler's ranges while it records."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    REGISTRY.capture_started()
    try:
        with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
            with REGISTRY.lock:
                REGISTRY.capturing += 1
            try:
                yield prof
            finally:
                with REGISTRY.lock:
                    REGISTRY.capturing -= 1
    finally:
        REGISTRY.capture_stopped()
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


MAX_CAPTURE_MS = 60_000


class _CaptureHandler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str = "text/plain") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 -- http.server's name
        url = urllib.parse.urlsplit(self.path)
        if url.path != "/capture":
            return self._send(404, b"GET /capture?ms=N\n")
        try:
            ms = float(urllib.parse.parse_qs(url.query).get("ms", ["1000"])[0])
        except ValueError:
            ms = -1.0
        if not 0 < ms <= MAX_CAPTURE_MS:
            return self._send(400, f"ms must be in (0, {MAX_CAPTURE_MS}]\n".encode())
        if not self.server.capturing.acquire(blocking=False):
            return self._send(409, b"a capture is already running\n")
        try:
            with tempfile.TemporaryDirectory(prefix="aitpu-capture-") as d:
                with capture(d):
                    time.sleep(ms / 1e3)
                (path,) = glob.glob(os.path.join(d, "*.json"))
                with open(path, "rb") as f:
                    body = f.read()
        finally:
            self.server.capturing.release()
        self._send(200, body, "application/json")

    def log_message(self, fmt, *args):
        log.debug("profiler server: " + fmt, *args)


def start_profiler_server(port: int) -> ThreadingHTTPServer:
    """Serve `GET /capture?ms=N` on 127.0.0.1:`port` (0 picks a free port:
    the returned server's `server_address[1]`) from a daemon thread; a
    request during a capture gets 409.  Stop with `.shutdown()`."""
    server = ThreadingHTTPServer(("127.0.0.1", port), _CaptureHandler)
    server.daemon_threads = True
    server.capturing = threading.Lock()
    threading.Thread(target=server.serve_forever, name="aitpu-profiler", daemon=True).start()
    log.info("profiler capture server on 127.0.0.1:%d", server.server_address[1])
    return server

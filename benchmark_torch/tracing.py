"""Reduction of a profiler capture to the run's device numbers, and the
timing of the program's own spans during set-up.

`reduce_trace` reads a Chrome trace as torch.profiler exports it (what the
program's utils/profiling.capture writes): the device's operations
(kernels, copies, fills) give the busy time as the union of their
intervals, the kernel time of named kernels, the operations that took
most time, and the idle gaps between them, each gap named by the innermost
host operation or CUDA call that the thread which launched the next device
operation was inside at the gap's middle.

`SpanTimer` wraps the program's `utils.profiling.trace` so that every span
it opens during the restart is also timed on the host clock (open.read,
open.pack, tier.upload), with no profiler running; `uninstall` puts the
program's own `trace` back before the warm-up, so the window runs the
program as it is.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
TOP = 10
SCAN = 400  # host operations looked at, backwards from a gap's middle


def short_name(name: str) -> str:
    """A kernel's printed name without its argument list and template
    arguments' tail, at most 120 characters."""
    n = name.split("(")[0].strip()
    return n[:120]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def matches(name: str, kernels: Iterable[str]) -> bool:
    """Whether a printed kernel name is one of `kernels` (whole words)."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])", name) for k in kernels)


def reduce_trace(path: str, kernel_groups: Dict[str, List[str]]) -> dict:
    """busy_s, kernel_s (all kernels), kernel_s_by_group, device_ops and
    idle_gaps of the capture at `path`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev: List[Tuple[float, float, str, object]] = []
    host: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    launch_tid: Dict[object, object] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?") if cat == "kernel" else cat, (e.get("args") or {}).get("correlation")))
        elif cat in HOST_CATS:
            host[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
            corr = (e.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch_tid[corr] = e.get("tid")
    cats: Dict[str, int] = defaultdict(int)
    for e in events:
        cats[f"{e.get('ph')}:{e.get('cat')}"] += 1
    by_op: Dict[str, float] = defaultdict(float)
    by_group = {g: 0.0 for g in kernel_groups}
    kernel_us = 0.0
    for a, b, name, _ in dev:
        by_op[short_name(name)] += b - a
        if name not in DEVICE_CATS:
            kernel_us += b - a
            for g, names in kernel_groups.items():
                if matches(name, names):
                    by_group[g] += b - a
    busy = _union([(a, b) for a, b, _, _ in dev])
    gaps: Dict[str, float] = defaultdict(float)
    for ev in host.values():
        ev.sort()
    starts = {tid: [a for a, _, _ in ev] for tid, ev in host.items()}
    first_after = sorted((a, corr) for a, _, _, corr in dev)
    firsts = [a for a, _ in first_after]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) / 2
        i = bisect.bisect_left(firsts, nxt)
        corr = first_after[i][1] if i < len(first_after) else None
        tid = launch_tid.get(corr)
        label = "host: no launching thread found"
        if tid in host:
            ev, st = host[tid], starts[tid]
            best: Optional[Tuple[float, str]] = None
            hi = bisect.bisect_right(st, mid)
            for k in range(hi - 1, max(hi - SCAN, 0) - 1, -1):  # the innermost span started lately
                a, b, name = ev[k]
                if b >= mid and (best is None or b - a < best[0]):
                    best = (b - a, name)
            label = best[1] if best else "host: between operations"
        gaps[label] += (nxt - end) / 1e6
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "kernel_s_by_group": {g: v / 1e6 for g, v in by_group.items()},
        "device_ops": sorted(([n, v / 1e6] for n, v in by_op.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:TOP],
        "device_events": len(dev),
        "event_kinds": dict(cats),
    }


class SpanTimer:
    """Host-clock totals of the program's spans, by name."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._swapped: List[Tuple[object, object]] = []

    def wrap(self, trace):
        timer = self

        @contextlib.contextmanager
        def timed(name: str):
            t = time.perf_counter()
            try:
                with trace(name):
                    yield
            finally:
                dt = time.perf_counter() - t
                with timer._lock:
                    timer.seconds[name] += dt
                    timer.count[name] += 1

        timed.wrapped = trace
        return timed

    def install(self, package: str = "acoustid_index_tpu_torch") -> None:
        """Time every span the program opens from now on.  Modules that
        import `trace` by name get the timed one when they are imported
        after this, and those already imported are given it here."""
        import sys

        from acoustid_index_tpu_torch.utils import profiling

        prev = profiling.trace
        orig = getattr(prev, "wrapped", prev)
        timed = self.wrap(orig)
        self._swapped = [(profiling, prev)]
        profiling.trace = timed
        for name, mod in list(sys.modules.items()):
            if mod is not profiling and name.startswith(package + ".") and getattr(mod, "trace", None) in (orig, prev):
                self._swapped.append((mod, mod.trace))
                mod.trace = timed
        self._timed = timed
        self._package = package

    def uninstall(self) -> None:
        """Give every module the `trace` it had before `install`, also
        those imported since, which took the timed one."""
        import sys

        for mod, prev in self._swapped:
            mod.trace = prev
        orig = self._swapped[0][1] if self._swapped else None
        for name, mod in list(sys.modules.items()):
            if name.startswith(self._package + ".") and getattr(mod, "trace", None) is self._timed:
                mod.trace = orig
        self._swapped = []

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.seconds)

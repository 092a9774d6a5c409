"""Prometheus metrics (text exposition format 0.0.4).

Same metric surface as the reference (upstream fpindex's src/metrics.zig):
per-index counters (searches/hits/misses/updates), global counters
(checkpoints, memory/file merges), histograms (search seconds per index;
postings scanned per query), gauges (docs, version) refreshed at scrape
time.  Recording never fails the measured operation; series for an index
are removed when it is deleted.

The port's copy of acoustid_index_tpu/server/metrics.py: the same code, its relative
imports resolving to the port's own modules, plus the merge counters by
route (inc_merges: aitpu_merges_{device,host,fallback}_total), and, after
every series above, the span and counter registry (utils/profiling):
aitpu_span_seconds_total / aitpu_span_count_total{span=...} (and
aitpu_span_cpu_seconds_total for spans that total the thread's CPU time),
aitpu_program_counter_total{counter=...}, and the native front's claim
counters, aitpu_front_batches_total and the aitpu_front_queue_wait_seconds
histogram.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Tuple

from ..utils import profiling

_lock = threading.Lock()

SEARCH_SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
POSTINGS_BUCKETS = (1, 10, 100, 1000, 10_000, 100_000, 1_000_000)
# Per-hash scan work (the reference's scanned-docs-per-hash buckets span
# 1..1000, metrics.zig:96-101; ours extend past its per-hash cap since the
# kernel budget is configurable).
PER_HASH_BUCKETS = (1, 5, 10, 50, 100, 500, 1000, 5000)
# Blocks scanned per query hash (the reference's ScannedBlocks buckets are
# 1,2,3,5,10 — metrics.zig:10; its per-hash cap is 4 blocks, ours is a
# 2-block landing window, so the same range covers both).
BLOCKS_BUCKETS = (1, 2, 3, 5, 10)
# The native front's queue-wait histogram (csrc/aitpu_front.cc
# QUEUE_WAIT_BUCKETS_MS), in seconds; its last bin is +Inf.
FRONT_QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5)


class _Hist:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float, n: int = 1):
        # counts[i] is per-bucket (range (buckets[i-1], buckets[i]]);
        # render() accumulates into the cumulative le-series.  `n` records
        # n observations sharing one value (e.g. a batch whose members
        # share one wall time) without duplicating this insert loop.
        self.total += n
        self.sum += v * n
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += n
                break


_counters: Dict[Tuple[str, str], int] = defaultdict(int)  # (metric, index) -> n
_globals: Dict[str, int] = defaultdict(int)
_gauges: Dict[Tuple[str, str], float] = {}
_search_seconds: Dict[str, _Hist] = {}
_postings = _Hist(POSTINGS_BUCKETS)
_per_hash = _Hist(PER_HASH_BUCKETS)
_blocks_per_hash = _Hist(BLOCKS_BUCKETS)


def _inc(metric: str, index: str, n: int = 1):
    with _lock:
        _counters[(metric, index)] += n


def inc_searches(index: str, n: int = 1):
    _inc("searches", index, n)


def inc_search_hit(index: str, n: int = 1):
    _inc("search_hits", index, n)


def inc_search_miss(index: str, n: int = 1):
    _inc("search_misses", index, n)


def inc_updates(index: str):
    _inc("updates", index)


def inc_checkpoints():
    with _lock:
        _globals["checkpoints"] += 1


def inc_memory_merges():
    with _lock:
        _globals["memory_merges"] += 1


def inc_file_merges():
    with _lock:
        _globals["file_merges"] += 1


def inc_merges(route: str):
    """A segment merge by route (engine/device_merge.py): `device`, `host`,
    or `fallback` (a device merge that raised and ran on the host)."""
    with _lock:
        _globals[f"merges_{route}"] += 1


def inc_searches_abandoned(n: int = 1):
    """Requests resolved as expired BEFORE their batch launched — the
    analogue of the reference's mid-scan timeout cancellation
    (MultiIndex.zig:311-316); work the device never had to do."""
    if n:
        with _lock:
            _globals["searches_abandoned"] += n


def inc_search_launches_skipped():
    """Batches whose every member expired pre-launch: the device launch was
    skipped entirely."""
    with _lock:
        _globals["search_launches_skipped"] += 1


def observe_search_seconds(index: str, seconds: float, n: int = 1):
    """Record `n` requests that each took `seconds` (n>1: a batch whose
    members share one wall time, e.g. the native front's device fetch)."""
    with _lock:
        h = _search_seconds.get(index)
        if h is None:
            h = _search_seconds[index] = _Hist(SEARCH_SECONDS_BUCKETS)
        h.observe(seconds, n)


def observe_postings_scanned(n: int):
    with _lock:
        _postings.observe(n)


def _observe_many(h: "_Hist", values) -> None:
    # Vectorized bulk observe (numpy array of per-query values): one lock
    # take per batch, used by the native front end's pump.
    import numpy as np

    vals = np.asarray(values)
    h.total += int(vals.size)
    h.sum += float(vals.sum())
    prev = None
    for i, b in enumerate(h.buckets):
        le = np.count_nonzero(vals <= b)
        h.counts[i] += int(le) - int(prev or 0)
        prev = le


def observe_postings_scanned_many(values) -> None:
    with _lock:
        _observe_many(_postings, values)


def observe_max_postings_per_hash_many(values) -> None:
    with _lock:
        _observe_many(_per_hash, values)


def observe_max_postings_per_hash(n: int):
    """Per-query max of postings scanned for one hash — the load-skew
    signal (a hot hash shows up here long before it dominates totals)."""
    with _lock:
        _per_hash.observe(n)


def observe_scanned_blocks_per_hash(n: int):
    """Per-query max of postings BLOCKS touched for one hash (both tiers) —
    the reference's scanned-blocks-per-hash series (metrics.zig:96-101)."""
    with _lock:
        _blocks_per_hash.observe(n)


def observe_scanned_blocks_per_hash_many(values) -> None:
    with _lock:
        _observe_many(_blocks_per_hash, values)


def set_docs(index: str, n: int):
    with _lock:
        _gauges[("docs", index)] = n


def set_version(index: str, v: int):
    with _lock:
        _gauges[("version", index)] = v


def remove_index(index: str):
    with _lock:
        for d in (_counters, _gauges):
            for key in [k for k in d if k[1] == index]:
                del d[key]
        _search_seconds.pop(index, None)


def reset():
    with _lock:
        _counters.clear()
        _globals.clear()
        _gauges.clear()
        _search_seconds.clear()
        global _postings, _per_hash, _blocks_per_hash
        _postings = _Hist(POSTINGS_BUCKETS)
        _per_hash = _Hist(PER_HASH_BUCKETS)
        _blocks_per_hash = _Hist(BLOCKS_BUCKETS)


PREFIX = "aitpu"


def render() -> str:
    out: List[str] = []
    with _lock:
        per_index = sorted({m for m, _ in _counters})
        for metric in per_index:
            out.append(f"# TYPE {PREFIX}_{metric}_total counter")
            for (m, index), v in sorted(_counters.items()):
                if m == metric:
                    out.append(f'{PREFIX}_{metric}_total{{index="{index}"}} {v}')
        for metric, v in sorted(_globals.items()):
            out.append(f"# TYPE {PREFIX}_{metric}_total counter")
            out.append(f"{PREFIX}_{metric}_total {v}")
        gauge_names = sorted({m for m, _ in _gauges})
        for metric in gauge_names:
            out.append(f"# TYPE {PREFIX}_{metric} gauge")
            for (m, index), v in sorted(_gauges.items()):
                if m == metric:
                    out.append(f'{PREFIX}_{metric}{{index="{index}"}} {v:g}')
        if _search_seconds:
            out.append(f"# TYPE {PREFIX}_search_seconds histogram")
            for index, h in sorted(_search_seconds.items()):
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    out.append(f'{PREFIX}_search_seconds_bucket{{index="{index}",le="{b:g}"}} {cum}')
                out.append(f'{PREFIX}_search_seconds_bucket{{index="{index}",le="+Inf"}} {h.total}')
                out.append(f'{PREFIX}_search_seconds_sum{{index="{index}"}} {h.sum:g}')
                out.append(f'{PREFIX}_search_seconds_count{{index="{index}"}} {h.total}')
        out.append(f"# TYPE {PREFIX}_postings_scanned histogram")
        cum = 0
        for b, c in zip(_postings.buckets, _postings.counts):
            cum += c
            out.append(f'{PREFIX}_postings_scanned_bucket{{le="{b:g}"}} {cum}')
        out.append(f'{PREFIX}_postings_scanned_bucket{{le="+Inf"}} {_postings.total}')
        out.append(f"{PREFIX}_postings_scanned_sum {_postings.sum:g}")
        out.append(f"{PREFIX}_postings_scanned_count {_postings.total}")
        out.append(f"# TYPE {PREFIX}_scanned_postings_per_hash histogram")
        cum = 0
        for b, c in zip(_per_hash.buckets, _per_hash.counts):
            cum += c
            out.append(f'{PREFIX}_scanned_postings_per_hash_bucket{{le="{b:g}"}} {cum}')
        out.append(f'{PREFIX}_scanned_postings_per_hash_bucket{{le="+Inf"}} {_per_hash.total}')
        out.append(f"{PREFIX}_scanned_postings_per_hash_sum {_per_hash.sum:g}")
        out.append(f"{PREFIX}_scanned_postings_per_hash_count {_per_hash.total}")
        out.append(f"# TYPE {PREFIX}_scanned_blocks_per_hash histogram")
        cum = 0
        for b, c in zip(_blocks_per_hash.buckets, _blocks_per_hash.counts):
            cum += c
            out.append(f'{PREFIX}_scanned_blocks_per_hash_bucket{{le="{b:g}"}} {cum}')
        out.append(f'{PREFIX}_scanned_blocks_per_hash_bucket{{le="+Inf"}} {_blocks_per_hash.total}')
        out.append(f"{PREFIX}_scanned_blocks_per_hash_sum {_blocks_per_hash.sum:g}")
        out.append(f"{PREFIX}_scanned_blocks_per_hash_count {_blocks_per_hash.total}")
    _render_registry(out)
    return "\n".join(out) + "\n"


def _render_registry(out: List[str]) -> None:
    t = profiling.totals()
    spans = sorted(t["spans"].items())
    if spans:
        out.append(f"# TYPE {PREFIX}_span_seconds_total counter")
        out += [f'{PREFIX}_span_seconds_total{{span="{k}"}} {v[0] / 1e9:.9g}' for k, v in spans]
        out.append(f"# TYPE {PREFIX}_span_count_total counter")
        out += [f'{PREFIX}_span_count_total{{span="{k}"}} {v[1]}' for k, v in spans]
        cpu = [(k, v) for k, v in spans if v[2]]
        if cpu:
            out.append(f"# TYPE {PREFIX}_span_cpu_seconds_total counter")
            out += [f'{PREFIX}_span_cpu_seconds_total{{span="{k}"}} {v[2] / 1e9:.9g}' for k, v in cpu]
    c = t["counters"]
    program = sorted((k, v) for k, v in c.items() if not k.startswith("front."))
    if program:
        out.append(f"# TYPE {PREFIX}_program_counter_total counter")
        out += [f'{PREFIX}_program_counter_total{{counter="{k}"}} {v}' for k, v in program]
    if "front.batches" in c:
        out.append(f"# TYPE {PREFIX}_front_batches_total counter")
        out.append(f"{PREFIX}_front_batches_total {c['front.batches']}")
        out.append(f"# TYPE {PREFIX}_front_queue_wait_seconds histogram")
        cum = 0
        for i, b in enumerate(FRONT_QUEUE_WAIT_BUCKETS):
            cum += c.get(f"front.queue_wait_bin.{i}", 0)
            out.append(f'{PREFIX}_front_queue_wait_seconds_bucket{{le="{b:g}"}} {cum}')
        out.append(f'{PREFIX}_front_queue_wait_seconds_bucket{{le="+Inf"}} {c["front.queue_waits"]}')
        out.append(f"{PREFIX}_front_queue_wait_seconds_sum {c['front.queue_wait_ns'] / 1e9:.9g}")
        out.append(f"{PREFIX}_front_queue_wait_seconds_count {c['front.queue_waits']}")

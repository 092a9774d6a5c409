"""The headline benchmark on one card (counterpart of the root bench.py).

    python -m acoustid_index_tpu_torch.bench [--seconds S] [--no-134m]
        [--no-sharded] [--client native|python] [--out FILE] [...]

Runs the root bench's phases, in its order and at its widths, through the
port (needs a card unless AITPU_TORCH_DEVICE=cpu, which only the tests set):

  1. parity gate: the root bench's 3-segment snapshot (two file segments of
     2,000 docs, a memory segment with 3 re-inserts and a delete; seed 77)
     through Searcher, its file tier in the plain layout (the resident range
     path) and interleaved: the 6 targets' answers must equal tests/oracle.py,
     and on a card K1 and K2 must launch.
  2. the 134M scale point (bench_100m.build_timed + run, every check of
     it) first, on a clean card; the tier is freed and the card's allocated
     memory must come back within 64 MiB.
  3. kernel: the 10M-doc tier (measure.pack_10m: 10M docs x 24 hashes, 240M
     postings, interleaved) and B = 256 batches of ~120-hash queries (20
     target hashes + 100 noise; _params_for(128); limit 10, min_score 6,
     pct 10) through Searcher._launch / _fetch: self-retrieval > 0.95,
     ROUNDS batches by host clock (p50/p99), ROUNDS more with 4 in flight
     (pipeline_qps), then the device-only rate (below) at B = 256 and 1.
  4. sharded: the same corpus packed by ShardedBatchingSearcher at mesh 1,
     self-retrieval > 0.95, the device-only rate and the pipelined rate.
  5. end to end (--e2e-docs docs, 2M by default, through MultiIndex
     bulk_insert in steps of 250K docs, or in 8 steps below 2M;
     checkpoint(force=True), which must merge on the card with no host
     fallback): --e2e-threads closed-loop threads; the open loop (--inflight
     requests in flight through Index.search_async); the native front
     under --native-procs load processes x --native-conns connections;
     the same load with the device stubbed (canned outputs), then through
     the Python HTTP server; the open loop stubbed; HTTP bulk ingest into a
     fresh index (msgpack columnar bodies of 100K docs, a sample read back
     after); the open loop beside a writer (200-doc inserts over a closed
     6,400-doc window every 20 ms), then the device-only rate of that S > 1
     snapshot and of its S = 1 merge.  Each window lasts --seconds.

The device-only rate (`qps`, the headline `value`): B divided by the
card's kernel time per batch, summed under torch.profiler over
DEVICE_BATCHES batches.  The root bench timed K batches inside one
fori_loop; the port's program syncs with the host twice per batch, so it
cannot run K batches in one launch, and its served rate is `pipeline_qps`.
On the CPU no device rate is measured: those keys are null.

A stubbed window swaps the index's searcher's _launch for canned packed
outputs (Searcher._fetch passes numpy through): no search program runs and
no kernel launches inside it, which the bench checks.

Prints one compact JSON line of the root bench's headline keys (plus
pipeline_qps) as its last line; the whole detail goes to --out (rewritten
after every phase).  A failed 134M step, sharded phase or S > 1 device rate
becomes a `*_error` key, as in the root bench; the line is printed and the
exit code is then 1.  Every other failure ends the run.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import importlib.util
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np

from .measure import HASHES_PER_DOC, N_DOCS, NOISE_HASHES, doc_hashes, make_queries

REFERENCE_QPS_ESTIMATE = 2000.0  # the root bench's pinned estimate for fpindex (see BASELINE_NOTE)
BASELINE_NOTE = ("denominator is the root bench's pinned ESTIMATE of 2,000 QPS for upstream fpindex at 10M "
                 "fingerprints (the reference publishes no numbers); not a measurement of either system")
BATCH = 256
ROUNDS = 12
IN_FLIGHT = 4  # batches launched ahead in the pipelined rates
DEVICE_BATCHES = 20  # batches under torch.profiler per device-only rate
LIMIT, MIN_SCORE, PCT = 10, 6, 10  # the kernel phase's options
E2E_STEP, E2E_SOURCES = 250_000, 8  # docs per bulk_insert: 8 steps of 250K at the default 2M, 8 below it
HTTP_STEP = 100_000  # docs per _bulk body (9.6 MB < the 16 MiB body cap)
OPEN_LOOP_QUERIES = 8192
SUBMITTERS, REAPERS = 4, 6
RW_BATCH, RW_WINDOW, RW_PERIOD_S = 200, 6400, 0.02
READ_BACK = 64  # HTTP-ingested docs read back (8 of them also searched)
K1_K2 = ("block_count", "block_count_emit")
BRANCHES = ("direct", "matrix", "sort")

# The gate: the root bench's parity_gate snapshot.
GATE_DOCS, GATE_PER_DOC = 4000, 24
GATE_REDO, GATE_DELETE = (1, 7, 3999), 42
GATE_TARGETS = (1, 7, 42, 100, 2000, 3999)
GATE_OPTS = {"limit": 15, "min_score": 2, "pct": 10}

HEADLINE_KEYS = [
    "metric", "value", "unit", "vs_baseline",
    "qps_134M", "qps_134M_error", "hit_rate_134M", "n_docs_134M",
    "sharded_qps_mesh1", "sharded_qps_mesh1_error", "sharded_overhead_x",
    "parity_gate", "self_retrieval_hit_rate", "n_docs",
    "pipeline_qps",
    "e2e_pipeline_qps", "e2e_hostonly_qps", "e2e_native_hostonly_qps",
    "e2e_pyhttp_hostonly_qps",
    "e2e_native_qps", "e2e_rw_qps", "e2e_rw_device_qps", "e2e_rw_device_qps_s1",
    "e2e_rw_device_overhead_x", "e2e_rw_segments",
    "e2e_http_ingest_docs_per_s", "e2e_p50_ms", "e2e_p99_ms", "device",
]

VALUE_NOTE = (
    "value = qps = B / the card's kernel ms per B=256 batch of the 10M program, summed under torch.profiler over "
    f"{DEVICE_BATCHES} batches: a device-only rate, not the served one (the root bench's fori_loop slope is not "
    "ported: the port's program syncs with the host twice per batch); pipeline_qps is the served rate of the same "
    f"program by host clock with {IN_FLIGHT} batches in flight; device_batch1_ms, sharded_qps_mesh1 and "
    "e2e_rw_device_qps* follow the same rule as qps; null where no card was measured"
)
E2E_NOTE = (
    "e2e_qps is closed-loop (threads x per-request latency); e2e_pipeline_qps is open-loop through "
    "Index.search_async (the serving capacity); e2e_native_* is HTTP on sockets through the native front from "
    "separate load processes; *_hostonly_* are the same loads with the searcher's launch stubbed (canned outputs: "
    "no program, no kernel), the host path's ceiling; e2e_rw_* is the open loop beside a writer, and "
    "e2e_rw_device_qps(_s1) the device-only rate of the final S>1 snapshot and of its S=1 merge"
)

T0 = time.time()


def log(msg: str) -> None:
    print(f"[bench +{time.time() - T0:.0f}s] {msg}", file=sys.stderr, flush=True)


def _oracle():
    """tests/oracle.py of the repository this package sits in (the root
    bench imports it the same way); the package itself has no oracle."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "oracle.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"the parity gate needs the repository's tests/oracle.py ({path})")
    spec = importlib.util.spec_from_file_location("_bench_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counters() -> dict:
    """K1's and K2's launches and the search programs run so far."""
    from .ops import block_lookup as bl
    from .ops import search_kernel as sk

    return {**{k: bl.LAUNCHES[k] for k in K1_K2}, "programs": sum(sk.STATS[k] for k in BRANCHES)}


def _since(before: dict) -> dict:
    now = _counters()
    return {k: now[k] - before[k] for k in now}


def _options(limit=LIMIT, min_score=MIN_SCORE, pct=PCT):
    from .engine.model import SearchOptions

    return SearchOptions(max_results=limit, min_score=min_score, min_score_pct=pct)


def _pack(qs, lens, limit=LIMIT, min_score=MIN_SCORE, pct=PCT) -> np.ndarray:
    from .ops.search_kernel import pack_inputs_np

    b = qs.shape[0]
    return pack_inputs_np(qs, lens, *(np.full(b, v, np.int32) for v in (limit, min_score, pct)))


def _query(rng, target: int) -> list:
    """The bench's query for doc `target`: its first 20 hashes and
    NOISE_HASHES random ones, unique and sorted."""
    hs = doc_hashes(np.array([target], np.uint32))[0]
    return np.unique(np.concatenate([hs[:20], rng.integers(0, 2**32, NOISE_HASHES, dtype=np.uint32)])).tolist()


# ---------------------------------------------------------------- 1. parity gate


def gate_corpus():
    """The root bench's parity_gate data, drawn in its order from seed 77:
    (first hashes of docs 1..GATE_DOCS, the re-inserted docs' new hashes,
    one query per GATE_TARGETS entry)."""
    rng = np.random.default_rng(77)
    first = {i: rng.integers(0, 2**32, GATE_PER_DOC, dtype=np.uint32).tolist() for i in range(1, GATE_DOCS + 1)}
    redo = {i: rng.integers(0, 2**32, GATE_PER_DOC, dtype=np.uint32).tolist() for i in GATE_REDO}
    latest = {**first, **redo}
    queries = [
        np.unique(np.concatenate([np.asarray(latest[t][:20], np.uint32), rng.integers(0, 2**32, 100, dtype=np.uint32)])).tolist()
        for t in GATE_TARGETS
    ]
    return first, redo, queries


def gate_segments(model, build_segment, first, redo):
    """The gate's segments (file 1, file 2, memory), oldest first, built by
    one package's build_segment and model (the port's, or the reference's
    in the tests)."""
    half = GATE_DOCS // 2
    f1 = build_segment([model.Insert(id=i, hashes=first[i]) for i in range(1, half + 1)], model.SegmentInfo(commit_id=1))
    f2 = build_segment([model.Insert(id=i, hashes=first[i]) for i in range(half + 1, GATE_DOCS + 1)],
                       model.SegmentInfo(commit_id=2))
    changes = [model.Insert(id=i, hashes=h) for i, h in redo.items()] + [model.Delete(id=GATE_DELETE)]
    return f1, f2, build_segment(changes, model.SegmentInfo(commit_id=3))


def gate_snapshots(dev):
    """The gate's snapshot twice: its file tier in the plain layout (hashes
    and docids apart, as pack_tier packs a tier of this size: the resident
    range path) and interleaved (the layout of the tiers the later phases
    serve).  Returns ({layout: snapshot}, segments)."""
    from .engine import model
    from .engine.memseg import build_segment
    from .engine.segments import _VIEW_TOKENS, FILE_SLOTS, MEMORY_SLOTS, Snapshot, pack_tier, pack_tier_np, tier_from_numpy
    from .ops.layout import BLOCK, interleave_np, postings_cap

    first, redo, _ = gate_corpus()
    f1, f2, m1 = gate_segments(model, build_segment, first, redo)
    mem_view = pack_tier([m1], MEMORY_SLOTS, device=dev)
    plain_np = pack_tier_np([f1, f2], FILE_SLOTS)
    if postings_cap(plain_np) < 64 * BLOCK:
        raise AssertionError("the parity table is too small for the blocked range path")
    if "inter" in plain_np:  # AITPU_RESIDENT_MAX_BYTES chose the interleaved layout
        blocks = plain_np.pop("inter").reshape(-1, 2, BLOCK)
        plain_np["hashes"], plain_np["docids"] = blocks[:, 0].reshape(-1), blocks[:, 1].reshape(-1)
    inter_np = {k: v for k, v in plain_np.items() if k not in ("hashes", "docids")}
    inter_np["inter"] = interleave_np(plain_np["hashes"], plain_np["docids"])
    snaps = {}
    for layout, view_np in (("plain", plain_np), ("interleaved", inter_np)):
        view = tier_from_numpy(view_np, dev, mentions=False)
        view["view_token"] = next(_VIEW_TOKENS)
        snaps[layout] = Snapshot(file=(f1, f2), memory=(m1,), file_view=view, mem_view=mem_view)
    return snaps, (f1, f2, m1)


def parity_gate(dev) -> dict:
    """Every gate answer in both layouts equal to tests/oracle.py; on a card
    K1 and K2 must have launched.  Raises on any difference."""
    from .engine.searcher import Searcher

    oracle = _oracle()
    snaps, segments = gate_snapshots(dev)
    oracle_segs = [
        oracle.OracleSegment(list(zip(s.hashes.tolist(), s.docids.tolist())), dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())))
        for s in segments
    ]
    _, _, queries = gate_corpus()
    searcher = Searcher(dev)
    opts = _options(GATE_OPTS["limit"], GATE_OPTS["min_score"], GATE_OPTS["pct"])
    before = _counters()
    for layout, snap in snaps.items():
        for t, q in zip(GATE_TARGETS, queries):
            got = [(r.id, r.score) for r in searcher.search(snap, q, opts)[0]]
            want = oracle.oracle_search(oracle_segs, q, **GATE_OPTS)
            if got != want:
                raise AssertionError(f"PARITY FAILURE ({layout}) target={t}: {got[:5]} != {want[:5]}")
    moved = _since(before)
    if dev.type == "cuda" and not all(moved[k] > 0 for k in K1_K2):
        raise AssertionError(f"the parity gate did not launch K1 and K2: {moved}")
    return {"parity_gate": "ok", "parity_gate_launches": moved,
            "parity_gate_searches": len(snaps) * len(GATE_TARGETS)}


# ---------------------------------------------------------------- timing


def _search(searcher, snap, params, packed) -> dict:
    from .ops.search_kernel import unpack_outputs_np

    return unpack_outputs_np(searcher._fetch(searcher._launch(snap, params, packed)), params.out_len)


def batch_ms(searcher, snap, params, packs) -> list:
    """Host ms of each batch, launched and fetched as the searcher serves one."""
    out = []
    for packed in packs:
        t0 = time.perf_counter()
        searcher._fetch(searcher._launch(snap, params, packed))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def pipelined_qps(searcher, snap, params, packs) -> float:
    """Searches per second by host clock with IN_FLIGHT batches launched ahead."""
    pending, t0 = [], time.perf_counter()
    for packed in packs:
        pending.append(searcher._launch(snap, params, packed))
        if len(pending) >= IN_FLIGHT:
            searcher._fetch(pending.pop(0))
    for h in pending:
        searcher._fetch(h)
    return sum(p.shape[0] for p in packs) / (time.perf_counter() - t0)


def device_rate(searcher, snap, params, packs) -> dict:
    """The card's kernel ms per batch over `packs` (each launched and
    fetched) under torch.profiler, its busy share, and B / that time.  On
    the CPU nothing is measured: nulls."""
    import torch

    from .measure import _device_ms

    b = packs[0].shape[0]
    if searcher.device.type != "cuda":
        return {"batches": 0, "batch": b, "kernel_ms_per_batch": None, "busy_share": None, "qps": None}
    _search(searcher, snap, params, packs[0])  # this shape's first batch stays out of the window
    torch.cuda.synchronize(searcher.device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for packed in packs:
            searcher._fetch(searcher._launch(snap, params, packed))
        torch.cuda.synchronize(searcher.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    ms = _device_ms(ev) / len(packs)
    if ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the search program")
    return {"batches": len(packs), "batch": b, "kernel_ms_per_batch": ms,
            "k1_ms_per_batch": _device_ms(ev, "block_count_kernel") / len(packs),
            "k2_ms_per_batch": _device_ms(ev, "block_count_emit_kernel") / len(packs),
            "busy_share": ms * len(packs) / wall_ms, "qps": b * 1e3 / ms}


def _hit_rate(searcher, snap, params, rng, n_docs: int) -> float:
    targets, qs, lens = make_queries(rng, BATCH, params.query_len, n_docs)
    return float(np.mean(_search(searcher, snap, params, _pack(qs, lens))["ids"][:, 0] == targets))


def _packs(rng, params, n_docs: int, n: int, b: int = BATCH, **opts) -> list:
    return [_pack(*make_queries(rng, b, params.query_len, n_docs)[1:], **opts) for _ in range(n)]


# ---------------------------------------------------------------- 2. 134M


def scale_134m(dev) -> dict:
    """bench_100m's tier and run (every check of it), then the device-only
    rate over DEVICE_BATCHES of its batches, whose self-retrieval is
    hit_rate_134M.  The tier is freed; the card's allocated memory must
    come back within 64 MiB of its level before."""
    import torch

    from . import bench_100m as b100
    from .engine.searcher import Searcher

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    snap, fig = b100.build_timed(dev, log)
    try:
        rep = b100.run(dev, snap, log=log)
        searcher, p = Searcher(dev), b100.params()
        rng = np.random.default_rng(13)
        batches = [b100.make_queries(rng) for _ in range(DEVICE_BATCHES)]
        packs = [b100.pack(qs, lens) for _, qs, lens in batches]
        rate = device_rate(searcher, snap, p, packs)
        hits = [np.mean(_search(searcher, snap, p, pk)["ids"][:, 0] == t) for (t, _, _), pk in zip(batches, packs)]
    finally:
        del snap
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) - base
    if left > 64 * 2**20:
        raise RuntimeError(f"{left / 2**20:.1f} MiB of the 134M step still allocated after it")
    return {
        "qps_134M": rate["qps"],
        "pipeline_qps_134M": rep["timed"]["searches_per_s"],
        "p50_batch_ms_134M": rep["timed"]["host_ms_p50"],
        "p99_batch_ms_134M": rep["timed"]["host_ms_p99"],
        "per_query_p50_ms_134M": rep["timed"]["host_ms_p50"] / b100.BATCH,
        "n_docs_134M": b100.N_DOCS,
        "n_postings_134M": b100.N_DOCS * b100.HASHES_PER_DOC,
        "hit_rate_134M": float(np.mean(hits)),
        "build_s_134M": fig["build_s"],
        "hbm_gb_134M": fig["tier_allocated_gib"] * 2**30 / 1e9,
        "device_134M": rate,
        "submit_qps_134M": rep["submit"]["searches_per_s"],
        "allocated_after_134M_mib": left / 2**20,
    }


# ---------------------------------------------------------------- 3-4. kernel, sharded


def kernel_bench(dev, n_docs: int):
    """The packed program over the 10M tier (module docstring, phase 3).
    Returns (figures, the snapshot, for the sharded phase's corpus)."""
    from .engine.searcher import Searcher, _params_for
    from .measure import pack_10m

    snap, build_s = pack_10m(dev, n_docs)
    if "inter" not in snap.file_view:
        raise AssertionError("the kernel phase's tier did not take the interleaved layout")
    log(f"kernel: {n_docs}-doc tier packed ({build_s:.1f} s)")
    searcher = Searcher(dev)
    params = _params_for(128)
    rngq = np.random.default_rng(17)
    t0 = time.perf_counter()
    hit = _hit_rate(searcher, snap, params, rngq, n_docs)
    first_s = time.perf_counter() - t0
    if hit <= 0.95:
        raise AssertionError(f"self-retrieval hit rate {hit}")
    log(f"kernel: first batch {first_s:.2f} s, hit rate {hit}")
    before = _counters()
    lat = batch_ms(searcher, snap, params, _packs(rngq, params, n_docs, ROUNDS))
    pipe = pipelined_qps(searcher, snap, params, _packs(rngq, params, n_docs, ROUNDS))
    dev256 = device_rate(searcher, snap, params, _packs(rngq, params, n_docs, DEVICE_BATCHES))
    dev1 = device_rate(searcher, snap, params, _packs(rngq, params, n_docs, DEVICE_BATCHES, b=1))
    return {
        "qps": dev256["qps"],
        "pipeline_qps": pipe,
        "p50_batch_ms": float(np.percentile(lat, 50)),
        "p99_batch_ms": float(np.percentile(lat, 99)),
        "device_batch1_ms": dev1["kernel_ms_per_batch"],
        "device_256": dev256,
        "device_1": dev1,
        "build_s": build_s,
        "first_batch_s": first_s,
        "hit_rate": hit,
        "kernel_launches": _since(before),
    }, snap


def sharded_bench(dev, snap, n_docs: int) -> dict:
    """The sharded program at mesh 1 over the kernel phase's corpus, packed
    by ShardedBatchingSearcher as --mesh-shards serving packs it."""
    from .engine.searcher import _params_for
    from .parallel.serving import ShardedBatchingSearcher
    from .parallel.sharded import make_mesh

    t0 = time.perf_counter()
    searcher = ShardedBatchingSearcher(make_mesh(1, dev))
    view = SimpleNamespace(file_view=searcher.pack_file_tier(list(snap.file)), mem_view=searcher.pack_mem_tier([]))
    build_s = time.perf_counter() - t0
    log(f"sharded: mesh-1 view packed ({build_s:.1f} s)")
    params = _params_for(128)
    rngq = np.random.default_rng(23)
    hit = _hit_rate(searcher, view, params, rngq, n_docs)
    if hit <= 0.95:
        raise AssertionError(f"sharded self-retrieval hit rate {hit}")
    before = _counters()
    pipe = pipelined_qps(searcher, view, params, _packs(rngq, params, n_docs, ROUNDS))
    rate = device_rate(searcher, view, params, _packs(rngq, params, n_docs, DEVICE_BATCHES))
    return {"sharded_qps_mesh1": rate["qps"], "sharded_pipeline_qps_mesh1": pipe, "sharded_hit_rate": hit,
            "sharded_build_s": build_s, "sharded_device": rate, "sharded_launches": _since(before)}


# ---------------------------------------------------------------- 5. end to end


@contextlib.contextmanager
def device_stubbed(idx, rng, label: str, record: dict):
    """idx's searcher with _launch replaced by canned packed outputs (doc 1's
    answer, per batch size) for the block: nothing runs on the device, which
    is checked on exit (record[label] = what moved, all 0)."""
    from .engine.searcher import BATCH_SIZES, _pack_rows, _params_for

    searcher = idx.searcher
    snapshot = idx.ensure_views(idx.acquire_reader())
    params = _params_for(128)
    row0 = searcher._row(*searcher.prepare_query(_query(rng, 1)), _options(40))[0]
    canned = {b: searcher._fetch(searcher._launch(snapshot, params, _pack_rows(params, [row0] * b, b))) for b in BATCH_SIZES}
    before = _counters()
    searcher._launch = lambda snap, p, packed_in: canned[packed_in.shape[0]]
    try:
        yield
    finally:
        del searcher._launch
    record[label] = _since(before)
    if any(record[label].values()):
        raise AssertionError(f"{label}: the stubbed window ran the device: {record[label]}")


def e2e_open_loop(args, idx, options, rng) -> dict:
    """--inflight requests kept in the batching pipeline through
    Index.search_async by SUBMITTERS threads, REAPERS threads checking each
    answer's first result; OPEN_LOOP_QUERIES queries made beforehand."""
    targets = rng.integers(1, args.e2e_docs + 1, OPEN_LOOP_QUERIES, dtype=np.uint32)
    hs_all = doc_hashes(targets)
    noise = rng.integers(0, 2**32, (OPEN_LOOP_QUERIES, NOISE_HASHES), dtype=np.uint32)
    qs = [(int(targets[i]), np.unique(np.concatenate([hs_all[i, :20], noise[i]])).tolist()) for i in range(OPEN_LOOP_QUERIES)]

    sem = threading.BoundedSemaphore(args.inflight)
    handles = queue.Queue()
    stop_t = time.time() + args.seconds
    done = [0] * REAPERS
    miss = [0] * REAPERS
    errors = []

    def submitter(k):
        r = np.random.default_rng(7000 + k)
        while time.time() < stop_t:
            sem.acquire()
            t, q = qs[int(r.integers(0, OPEN_LOOP_QUERIES))]
            handles.put((t, idx.search_async(q, options)))

    def reaper(k):
        while True:
            item = handles.get()
            if item is None:
                return
            t, h = item
            try:
                res, _ = h.result()
            except Exception as exc:  # noqa: BLE001 -- raised after the window
                errors.append(repr(exc))
                res = []
            sem.release()
            if not res or res[0].id != t:
                miss[k] += 1
            done[k] += 1

    subs = [threading.Thread(target=submitter, args=(k,)) for k in range(SUBMITTERS)]
    reaps = [threading.Thread(target=reaper, args=(k,)) for k in range(REAPERS)]
    before = _counters()
    t0 = time.time()
    for t in subs + reaps:
        t.start()
    for t in subs:
        t.join()
    for _ in reaps:
        handles.put(None)
    for t in reaps:
        t.join()
    wall = time.time() - t0
    if errors:
        raise RuntimeError(f"open loop: {len(errors)} searches failed: {errors[:3]}")
    total = sum(done)
    return {
        "e2e_pipeline_qps": total / wall,
        "e2e_pipeline_queries": total,
        "e2e_pipeline_miss_rate": sum(miss) / max(total, 1),
        "e2e_pipeline_inflight": args.inflight,
        "e2e_pipeline_launches": _since(before),
    }


def e2e_closed_loop(args, idx, options) -> dict:
    """--e2e-threads threads, each searching one query at a time."""
    counts = [0] * args.e2e_threads
    misses = [0] * args.e2e_threads
    lats = [[] for _ in range(args.e2e_threads)]
    errors = []
    stop = time.time() + args.seconds

    def worker(k):
        r = np.random.default_rng(1000 + k)
        try:
            while time.time() < stop:
                t = int(r.integers(1, args.e2e_docs + 1))
                q = _query(r, t)
                t_req = time.perf_counter()
                res, _ = idx.search(q, options)
                lats[k].append(time.perf_counter() - t_req)
                if not res or res[0].id != t:
                    misses[k] += 1
                counts[k] += 1
        except Exception as exc:  # noqa: BLE001 -- raised after the window
            errors.append(repr(exc))

    before = _counters()
    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(args.e2e_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errors:
        raise RuntimeError(f"closed loop: {len(errors)} threads failed: {errors[:3]}")
    total = sum(counts)
    all_lat = np.array([x for xs in lats for x in xs]) * 1e3
    return {
        "e2e_qps": total / wall,
        "e2e_queries": total,
        "e2e_miss_rate": sum(misses) / max(total, 1),
        "e2e_threads": args.e2e_threads,
        "e2e_launches": _since(before),
        "e2e_p50_ms": float(np.percentile(all_lat, 50)) if all_lat.size else None,
        "e2e_p99_ms": float(np.percentile(all_lat, 99)) if all_lat.size else None,
    }


def client_cmd(args, port: int, conns: int, blob_path: str, seed: int) -> list:
    """One load process: the native load generator (--client native, built
    from csrc/aitpu_loadgen.cc; a build failure raises) or bench_client.py
    (--client python).  Both print the same JSON line."""
    if args.client == "native":
        from .utils.native import loadgen_path

        base = [loadgen_path()]
    else:
        base = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_client.py")]
    return base + ["--port", str(port), "--seconds", str(args.seconds), "--conns", str(conns),
                   "--blobs", blob_path, "--seed", str(seed)]


def e2e_native(args, mi, idx, rng, tag: str, server: str = "native", stub_record=None) -> dict:
    """HTTP load on real sockets from --native-procs separate load
    processes of --native-conns connections each: through the native front
    (csrc/aitpu_front.cc + server/native_front.py, --native-pumps pumps) or,
    with server="pyhttp", the Python HTTP server (server/http.py + app.py).
    With stub_record the searcher's launch is stubbed for the window
    (device_stubbed): the front's host-path ceiling; canned answers make
    misses meaningless, so no miss rate is kept then."""
    import msgpack

    from .server.app import App
    from .server.http import HttpServer
    from .server.native_front import NativeFront

    stub = device_stubbed(idx, rng, tag, stub_record) if stub_record is not None else contextlib.nullcontext()
    with stub, contextlib.ExitStack() as stack:
        targets = rng.integers(1, args.e2e_docs + 1, OPEN_LOOP_QUERIES, dtype=np.uint32)
        hs_all = doc_hashes(targets)
        noise = rng.integers(0, 2**32, (OPEN_LOOP_QUERIES, NOISE_HASHES), dtype=np.uint32)
        blobs = []
        for i in range(OPEN_LOOP_QUERIES):
            q = np.unique(np.concatenate([hs_all[i, :20], noise[i]])).tolist()
            body = json.dumps({"query": q, "limit": 40, "min_score": 6, "score_pct": 10, "timeout": 10000}).encode()
            req = (b"POST /main/_search HTTP/1.1\r\nHost: b\r\n"
                   b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
            blobs.append((b'"results": [{"id": %d,' % int(targets[i]), req))
        fd, blob_path = tempfile.mkstemp(suffix=".blobs")
        stack.callback(os.unlink, blob_path)
        with os.fdopen(fd, "wb") as f:
            f.write(msgpack.packb(blobs))

        if server == "native":
            front = NativeFront(mi, 0, pumps=args.native_pumps, max_conns=2 * args.native_procs * args.native_conns)
            front.start()  # raises when the front's library does not build
            stack.callback(front.stop)
            port = front.port
        else:
            app = App(mi)
            pysrv = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
            thread = pysrv.serve_background()
            stack.callback(thread.join, 10)
            stack.callback(pysrv.server_close)
            stack.callback(pysrv.shutdown)
            port = pysrv.port
        cmds = [client_cmd(args, port, args.native_conns, blob_path, 100 + k) for k in range(args.native_procs)]
        procs = []
        stack.callback(lambda: [p.kill() for p in procs if p.poll() is None])
        before = _counters()
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=args.seconds + 120)
            if p.returncode != 0:
                raise RuntimeError(f"{tag}: load client exited {p.returncode}: {err.decode()[-500:]}")
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
        moved = _since(before)
    total = sum(o["count"] for o in outs)
    if total == 0:
        raise RuntimeError(f"{tag}: no request was answered")
    p50s = [o["p50_ms"] for o in outs if o["p50_ms"] is not None]
    p99s = [o["p99_ms"] for o in outs if o["p99_ms"] is not None]
    res = {
        f"{tag}_qps": sum(o["count"] / o["window_s"] for o in outs if o["window_s"] > 0),
        f"{tag}_queries": total,
        f"{tag}_inflight": args.native_procs * args.native_conns,
        f"{tag}_p50_ms": float(np.mean(p50s)) if p50s else None,
        f"{tag}_p99_ms": float(np.max(p99s)) if p99s else None,
        f"{tag}_client": args.client,
        f"{tag}_launches": moved,
    }
    if server == "native":
        res[f"{tag}_pumps"] = args.native_pumps
    if stub_record is None:
        res[f"{tag}_miss_rate"] = sum(o["miss"] for o in outs) / total
    return res


def _roundtrip(conn, method: bytes, path: bytes, body: bytes = b"", ctype: bytes = b"application/vnd.msgpack"):
    """One keep-alive HTTP exchange on `conn`: (status, body)."""
    conn.sendall(b"%s %s HTTP/1.1\r\nHost: b\r\nContent-Type: %s\r\nContent-Length: %d\r\n\r\n"
                 % (method, path, ctype, len(body)) + body)
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = conn.recv(65536)
        if not chunk:
            raise ConnectionError("the server closed the connection")
        buf += chunk
    head, rest = buf.split(b"\r\n\r\n", 1)
    clen = 0
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.partition(b":")
        if k.strip().lower() == b"content-length":
            clen = int(v)
    while len(rest) < clen:  # drain the body: keep-alive reuse
        rest += conn.recv(65536)
    return int(head.split(b" ", 2)[1]), rest[:clen]


def e2e_http_ingest(args, rng) -> dict:
    """Bulk ingest over HTTP into a fresh index: msgpack columnar _bulk
    bodies of HTTP_STEP docs (encoded before the window) on one keep-alive
    socket; then READ_BACK docs read back (GET /ing/:id) and 8 of them
    searched, each its own first result."""
    import msgpack

    from .multi.multi_index import MultiIndex
    from .server.app import App
    from .server.http import HttpServer

    with tempfile.TemporaryDirectory() as tmp:
        mi = MultiIndex.open(tmp, checkpoint_age=None, checkpoint_threshold=args.e2e_docs * HASHES_PER_DOC + 1, sync=False)
        app = App(mi)
        server = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
        thread = server.serve_background()
        try:
            conn = socket.create_connection(("127.0.0.1", server.port))
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            status, _ = _roundtrip(conn, b"PUT", b"/ing")
            if status != 200:
                raise RuntimeError(f"HTTP ingest: create status {status}")
            bodies = []
            for lo in range(1, args.e2e_docs + 1, HTTP_STEP):
                ids = np.arange(lo, min(lo + HTTP_STEP, args.e2e_docs + 1), dtype=np.uint32)
                bodies.append(msgpack.packb({"i": ids.tobytes(), "h": doc_hashes(ids).reshape(-1).tobytes(), "k": HASHES_PER_DOC}))
            t0 = time.time()
            for body in bodies:
                status, resp = _roundtrip(conn, b"POST", b"/ing/_bulk", body)
                if status != 200:
                    raise RuntimeError(f"HTTP ingest: status {status}: {resp[:200]!r}")
            ingest_s = time.time() - t0

            sample = rng.integers(1, args.e2e_docs + 1, READ_BACK)
            for i in sample:
                status, resp = _roundtrip(conn, b"GET", b"/ing/%d" % i)
                if status != 200:
                    raise AssertionError(f"HTTP ingest: doc {i} not read back (status {status}: {resp[:200]!r})")
            for i in sample[:8]:
                body = json.dumps({"query": _query(rng, int(i)), "limit": 10, "min_score": 6, "score_pct": 10,
                                   "timeout": 60_000}).encode()
                status, resp = _roundtrip(conn, b"POST", b"/ing/_search", body, b"application/json")
                results = json.loads(resp)["results"] if status == 200 else None
                if not results or results[0]["id"] != int(i):
                    raise AssertionError(f"HTTP ingest: doc {i} searched back as {status} {resp[:200]!r}")
            conn.close()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
            mi.close()
    return {"e2e_http_ingest_docs_per_s": args.e2e_docs / ingest_s, "e2e_http_ingest_s": ingest_s,
            "e2e_http_ingest_bodies": len(bodies), "e2e_http_ingest_read_back": READ_BACK}


def e2e_read_write(args, idx, options, rng) -> dict:
    """The open loop beside a writer (RW_BATCH-doc inserts over a closed
    RW_WINDOW-doc id window above the corpus, every RW_PERIOD_S), then the
    device-only rate of the final S > 1 snapshot and of the same postings
    merged into one file segment (S = 1)."""
    from .engine.device_merge import merge_segments_auto
    from .engine.model import Insert
    from .engine.searcher import Searcher, _params_for

    stop_rw = threading.Event()
    writes = [0]
    errors = []

    def writer():
        base, off = args.e2e_docs + 1, 0
        try:
            while not stop_rw.is_set():
                ids = np.arange(base + off, base + off + RW_BATCH, dtype=np.uint32)
                hs = doc_hashes(ids)
                idx.update([Insert(id=int(i), hashes=h.tolist()) for i, h in zip(ids, hs)])
                writes[0] += int(ids.shape[0])
                off = (off + RW_BATCH) % RW_WINDOW
                stop_rw.wait(RW_PERIOD_S)
        except Exception as exc:  # noqa: BLE001 -- raised after the window
            errors.append(repr(exc))

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        out = e2e_open_loop(args, idx, options, rng)
    finally:
        stop_rw.set()
        wt.join(timeout=30)
    if errors:
        raise RuntimeError(f"read/write: the writer failed: {errors[0]}")
    snap = idx.ensure_views(idx.acquire_reader())
    res = {
        "e2e_rw_qps": out["e2e_pipeline_qps"],
        "e2e_rw_queries": out["e2e_pipeline_queries"],
        "e2e_rw_miss_rate": out["e2e_pipeline_miss_rate"],
        "e2e_rw_writes": writes[0],
        "e2e_rw_launches": out["e2e_pipeline_launches"],
        "e2e_rw_segments": snap.num_segments(),
    }
    try:
        searcher, params = Searcher(idx.searcher.device), _params_for(128)
        packs = _packs(rng, params, args.e2e_docs, DEVICE_BATCHES, limit=40)
        rate = device_rate(searcher, snap, params, packs)
        one = merge_segments_auto(list(snap.file) + list(snap.memory), snap)
        s1 = SimpleNamespace(file_view=idx.searcher.pack_file_tier([one]), mem_view=idx.searcher.pack_mem_tier([]))
        rate1 = device_rate(searcher, s1, params, packs)
        res.update(e2e_rw_device_qps=rate["qps"], e2e_rw_device_qps_s1=rate1["qps"],
                   e2e_rw_device_overhead_x=rate1["qps"] / rate["qps"] if rate["qps"] else None,
                   e2e_rw_device=rate, e2e_rw_device_s1=rate1)
    except Exception as exc:  # noqa: BLE001 -- the root bench's *_error key; the run exits 1
        log(f"read/write device rates failed: {exc!r}")
        res["e2e_rw_device_qps_error"] = f"{type(exc).__name__}: {exc}"[:200]
    return res


def e2e_bench(args, detail: dict, phase_s: dict, write) -> None:
    """Phase 5 (module docstring); figures into `detail`, seconds per step
    into `phase_s`, `write()` after every step."""
    from .multi.multi_index import MultiIndex

    rng = np.random.default_rng(23)
    stubs = detail.setdefault("stubbed_windows", {})

    def step(name, fn):
        t0 = time.perf_counter()
        detail.update(fn())
        phase_s[name] = time.perf_counter() - t0
        log(f"{name}: {phase_s[name]:.1f} s")
        write()

    with tempfile.TemporaryDirectory() as tmp:
        mi = MultiIndex.open(tmp, checkpoint_age=None, checkpoint_threshold=args.e2e_docs * HASHES_PER_DOC + 1, sync=False)
        mi.create_index("main")
        ref = mi._get_ref("main")
        idx = ref.index
        try:
            def build():
                # Maintenance off while loading, so that no background memory
                # merge folds the sources of the one forced checkpoint, which
                # must merge them on the card.
                idx.stop()
                t0 = time.perf_counter()
                step_docs = min(E2E_STEP, -(-args.e2e_docs // E2E_SOURCES))
                for lo in range(1, args.e2e_docs + 1, step_docs):
                    ids = np.arange(lo, min(lo + step_docs, args.e2e_docs + 1), dtype=np.uint32)
                    idx.bulk_insert(ids, doc_hashes(ids))
                ingest_s = time.perf_counter() - t0
                sources = len(idx.acquire_reader().memory)
                merges0 = idx.merge_counts.as_dict()
                t1 = time.perf_counter()
                idx.checkpoint(force=True)
                checkpoint_s = time.perf_counter() - t1
                merges = {k: v - merges0.get(k, 0) for k, v in idx.merge_counts.as_dict().items()}
                if merges.get("device", 0) < 1 or merges.get("fallback", 0) or idx.acquire_reader().memory:
                    raise AssertionError(f"the checkpoint of {sources} sources did not merge on the card: {merges}")
                idx.start()
                res, _ = idx.search(_query(rng, 1), _options(40))
                if not res or res[0].id != 1:
                    raise AssertionError(f"e2e self-retrieval of doc 1: {res[:3]}")
                return {"e2e_docs": args.e2e_docs, "e2e_ingest_docs_per_s": args.e2e_docs / ingest_s,
                        "e2e_ingest_s": ingest_s, "e2e_checkpoint_s": checkpoint_s, "e2e_checkpoint_sources": sources,
                        "e2e_checkpoint_merges": merges, "e2e_build_s": time.perf_counter() - t0}

            options = _options(40)
            step("e2e_build", build)
            step("e2e_closed", lambda: e2e_closed_loop(args, idx, options))
            step("e2e_open", lambda: e2e_open_loop(args, idx, options, rng))
            step("e2e_native", lambda: e2e_native(args, mi, idx, rng, "e2e_native"))
            step("e2e_native_hostonly", lambda: e2e_native(args, mi, idx, rng, "e2e_native_hostonly", stub_record=stubs))
            step("e2e_pyhttp_hostonly",
                 lambda: e2e_native(args, mi, idx, rng, "e2e_pyhttp_hostonly", server="pyhttp", stub_record=stubs))

            def host_only():
                with device_stubbed(idx, rng, "e2e_hostonly", stubs):
                    out = e2e_open_loop(args, idx, options, rng)
                return {"e2e_hostonly_qps": out["e2e_pipeline_qps"], "e2e_hostonly_queries": out["e2e_pipeline_queries"]}

            step("e2e_hostonly", host_only)
            step("e2e_http_ingest", lambda: e2e_http_ingest(args, rng))
            step("e2e_read_write", lambda: e2e_read_write(args, idx, options, rng))
        finally:
            mi._release_ref(ref)
            mi.close()


# ---------------------------------------------------------------- main


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=20.0, help="each end-to-end window (the root bench's E2E_SECONDS)")
    ap.add_argument("--no-134m", dest="scale", action="store_false", help="skip the 134M scale point")
    ap.add_argument("--no-sharded", dest="sharded", action="store_false", help="skip the mesh-1 sharded phase")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "bench_detail.json"), help="the detail JSON")
    ap.add_argument("--client", choices=("native", "python"), default="native",
                    help="load processes: csrc/aitpu_loadgen.cc or bench_client.py")
    ap.add_argument("--docs", type=int, default=N_DOCS, help="docs of the kernel and sharded phases' corpus")
    ap.add_argument("--e2e-docs", type=int, default=2_000_000, help="AITPU_BENCH_E2E_DOCS")
    ap.add_argument("--e2e-threads", type=int, default=128, help="AITPU_BENCH_E2E_THREADS")
    ap.add_argument("--native-pumps", type=int, default=8, help="AITPU_BENCH_NATIVE_PUMPS")
    ap.add_argument("--native-procs", type=int, default=6, help="AITPU_BENCH_NATIVE_PROCS")
    ap.add_argument("--native-conns", type=int, default=384, help="AITPU_BENCH_NATIVE_CONNS")
    ap.add_argument("--inflight", type=int, default=2048, help="AITPU_BENCH_INFLIGHT")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks

    import torch

    from .measure import smi
    from .utils.device import device

    dev = device()
    if args.scale and dev.type != "cuda":
        raise SystemExit(f"the 134M step needs a card; the port's device is {dev} (pass --no-134m)")
    device_line = smi("name,power.limit") if dev.type == "cuda" else str(dev)
    log(f"device: {device_line}; torch {torch.__version__}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    phase_s = {}
    detail = {
        "metric": "search_qps_10M_fp_1chip", "unit": "qps", "baseline_note": BASELINE_NOTE, "value_note": VALUE_NOTE,
        "e2e_note": E2E_NOTE, "device": device_line, "torch_device": str(dev), "batch": BATCH, "query_hashes": 120,
        "n_docs": args.docs, "n_postings": args.docs * HASHES_PER_DOC, "settings": vars(args), "phase_s": phase_s,
    }

    def write():
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)

    def phase(name, fn, error_key=None):
        t0 = time.perf_counter()
        try:
            detail.update(fn())
        except Exception as exc:  # noqa: BLE001 -- only where the root bench keeps the line (error_key)
            if error_key is None:
                raise
            log(f"{name} failed: {exc!r}")
            detail[error_key] = f"{type(exc).__name__}: {exc}"[:200]
        phase_s[name] = time.perf_counter() - t0
        log(f"{name}: {phase_s[name]:.1f} s")
        write()

    phase("parity_gate", lambda: parity_gate(dev))
    if args.scale:
        phase("scale_134m", lambda: scale_134m(dev), "qps_134M_error")
    held = {}

    def kernel():
        k, held["snap"] = kernel_bench(dev, args.docs)
        return {**k, "self_retrieval_hit_rate": k.pop("hit_rate")}

    phase("kernel", kernel)
    if args.sharded:
        phase("sharded", lambda: sharded_bench(dev, held["snap"], args.docs), "sharded_qps_mesh1_error")
        if "sharded_qps_mesh1" in detail:  # the root bench's ratio: qps / sharded_qps_mesh1
            sq = detail["sharded_qps_mesh1"]
            detail["sharded_overhead_x"] = detail["qps"] / sq if sq and detail["qps"] else None
    held.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if args.e2e_docs:
        e2e_bench(args, detail, phase_s, write)

    detail["value"] = detail["qps"]
    detail["vs_baseline"] = detail["qps"] / REFERENCE_QPS_ESTIMATE if detail["qps"] else None
    detail["per_query_p50_ms"] = detail["p50_batch_ms"] / BATCH
    detail["total_s"] = time.time() - T0
    write()
    log(f"detail: {json.dumps(detail, default=str)}")
    headline = {k: detail[k] for k in HEADLINE_KEYS if k in detail}
    headline["detail"] = args.out
    print(json.dumps(headline), flush=True)

    from .engine import searcher as searcher_mod

    if searcher_mod._default_searcher is not None:
        searcher_mod._default_searcher.close()
    errors = sorted(k for k in detail if k.endswith("_error"))
    if errors:
        log(f"failed: {errors}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

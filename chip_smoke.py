#!/usr/bin/env python3
"""Smoke run of acoustid_index_tpu_torch on one CUDA card.

    python3 chip_smoke.py    # one card, ~12 minutes; exits 2 without CUDA

Phases, each fatal on failure:
  0. device: the card's name and power limit (nvidia-smi), CUDA present;
     the host libraries (csrc/*.cc: codecs, the native search front, the
     load generator) start building with g++ in the background, and the three
     kernel libraries (csrc/block_lookup.cu, csrc/probe_lookup.cu, and the
     designs not taken: csrc/block_lookup_designs.cu with
     csrc/probe_lookup_designs.cu) with nvcc, one process each, all at once.
  1. kernels: build every kernel of acoustid_index_tpu_torch/csrc (K1
     block_count, K1m block_count_masked, K2 block_count_emit, and K1's and
     K2's first, scanning designs block_count_scan / block_count_emit_scan)
     and run them at the shapes the main path gives them (measure.py's
     kernel cases): (a) K1 over a 1 MiB top index with a B=256 batch's
     32,768 lookups; (b) K1 over a table of the live memory tier's size, two
     lookups per query; (c) K1 stride 2 and K2 over a 2 GiB interleaved tier
     (262,144 blocks, 240M live postings) with 32,768 + 2,048 lookups; (d)
     the first 64K-block table (all four kernels; K1m with random
     [lo_b, hi_b) spans); and K1 at L = 1, the launch floor.  Every kernel,
     scan and torch.searchsorted yardstick must equal the plain PyTorch
     version bit for bit on every input set; then they run in turns (new,
     scan, yardstick, yardstick, scan, new), 5 rounds of 50 launches, cold
     (cycling through input sets that together exceed the 50 MB L2 four
     times: fresh lookups, and for (a) and (b) fresh table copies, as a
     batch of the main path finds them) and warm (one set repeated), with
     the SM clock and power draw read around each round, and each call's
     bound is worked out from its inputs.
  1b. the device merge (engine/device_merge.py): runs of 8 sources holding
     10^5, 10^6 and 10^7 postings (re-inserts and deletes across sources,
     tombstones, a newer source outside the run, hash and doc id
     0xFFFFFFFF) merged on the card must equal the host merger's Segment
     in every field, bit for bit; then both merge each run in turns, 3
     rounds, and the size from which the card is faster is logged.
  1c. the probes (acoustid_index_tpu_torch/probes.py, the counterpart of
     the reference's probes/): with every launch counter at 0, `python -m
     acoustid_index_tpu_torch.probes --check-only` in this process runs the
     probes' own parity checks and every variant of the sixteen sites'
     functions once at the probes' shapes (2^26-2^28-entry tables, 32,768
     lookups), each bit-equal to its plain version; K3 block_count_pair, K4
     block_count_emit_docids and K5 block_count_staged (csrc/probe_lookup.cu)
     must each have launched; K3's and K4's sites also run their kernel's
     first design (thread11), bit-equal too.  Then each alone at one probe shape
     (measure.probe_kernel_cases): K3's window at strides 1 and 2, K4 at E =
     2 and 4, R = 1024 and 128, each beside the designs it did not take (PR
     5's thread11, the other sector arities), K5 at (G, NBUF) = (8, 4) and
     (16, 2) beside K1's scan, search and torch.searchsorted; bit-equal to
     the plain version on every input set, then timed cold and warm as phase
     1 times, with the bytes each K3/K4 design reads.
  1d. the 134M scale point (acoustid_index_tpu_torch/bench_100m.py, the
     counterpart of the reference's bench_100m.py): 2^27 docs x 8 hashes =
     2^30 postings built on the card as one interleaved tier of 2^31
     entries (8 GiB; build time and peak allocation logged).  K1 at shape
     (e) (its 4 MiB top index, a B=256 batch's 16,384 landing lookups) and
     K1 stride 2 and K2 at (f) (the 8 GiB tier, 16,384 + 2,048 lookups) and
     at (g) (the same tier with shape (c)'s lookup mix, 32,768 + 2,048, every
     lane live), each bit-equal to its plain version on every input set,
     then timed as phase 1 times.  Then, with every launch counter at 0,
     bench_100m.run: two batches of 256 through Searcher._launch / _fetch
     and a boundary batch (the last 1,024 positions, bands 2-7, hashes
     0xFFFFFFFC-0xFFFFFFFF), self-retrieval 1.0 at score 6 and every
     answer equal to tests/oracle.py over the analytic sub-oracle
     (bench_100m.oracle_postings); 100 timed batches, 100 pipelined, a profiled capture; 512 queries
     through BatchingSearcher.submit from 32 threads, each checked the same
     way, with digests of the packed outputs.  K1 and K2 must have launched
     on this path, the scans never (launches_by_path "scale_134m").  Then
     the stage split at 134M (measure.stage_split).
  1e. the 134M tier over 4 hash-range shards (bench_100m.shard_tier: two
     whole bands, 2^28 postings, per shard), driven by
     bench_100m.run_sharded through ShardedBatchingSearcher with the
     launch counters at 0, twice: (a) one slot per visible card up to 4
     (on one card: four views of phase 1d's tier, no copy); (b) four slots,
     one per visible card and cuda:0 again (on one card: four 2 GiB copies,
     four streams, the joins).  Each: every answer equal to the oracle, the
     packed outputs' digests equal to phase 1d's single program's (the
     same batches from the same seed), K1 and K2 4 launches per batch, <= 2
     host syncs per batch, host ms p50/p99 and the card span beside phase
     1d's, each card's peak, each card freed after it (launches_by_path
     "scale_134m_mesh4").  With two cards or more, K1 and K2 on the last
     card from a thread whose current device is cuda:0, bit-equal to their
     plain versions.  Last phase 1d's tier is freed: every card's allocated
     memory must come back within 64 MiB of its level before phase 1d.
  2. serving at the reference bench's scale (bench.py: 10M docs x 24 hashes
     = 240M postings): bulk-load through the port's MultiIndex, checkpoint
     to disk through merge_segments_auto (it must take the device merge,
     with no fallback to the host), then reopen and serve through the CLI's
     own entry
     (acoustid_index_tpu_torch.main.build_server) in this process, so the
     launch counters can be read, and send >= 256 searches from 32 client
     threads; every answer must equal tests/oracle.py over the corpus, which
     this script sorts itself.  Then writes over HTTP (1,000 new docs,
     re-inserts, deletes): every acknowledged write must read back and
     deleted docs must vanish.  Then docs that share one hot hash, and
     queries for them that must take the search program's matrix branch and
     its sort branch.  K1's and K2's launch counters must grow during this
     phase, and the scanning designs' must stay 0.  Then the same 512
     searches through the native search front
     (csrc/aitpu_front.cc + server/native_front.py, started by build_server
     with a search port) on the same index: every answer equal to the
     oracle and every body byte-equal to the Python server's; then ~10 s of
     load from the native load generator (csrc/aitpu_loadgen.cc) in a
     separate process, every response holding its expected first result;
     K1's and K2's launch counters must grow during this path too.  Last, the
     same load against fronts of 1, 2, 4 and 8 pumps.
  2c. mesh serving: a copy of phase 2's checkpointed directory (taken before
     its writes) served through build_server with --mesh-shards 8 and a
     search port (parallel/: 8 shards over the visible cards, one slot per
     card up to 8; the shard -> card map logged).  With the
     launch counters at 0: the same 512 searches through the Python front
     and the native front, every answer equal to the oracle and every body
     byte-equal to phase 2's Python server's; phase 2's write mix (every
     acknowledged write reads back, deleted docs vanish); the hot-hash
     groups, which must take the sharded program's P_SMALL path and its
     full-budget path (parallel.sharded.STATS).  K1 and K2 must launch at
     least 8 times per sharded batch, the scans never, with at most 2 host
     syncs per batch.  Then dryrun_multichip(8) over the visible cards.
  2d. the replicated deployment: a durable coordinator through the CLI
     (`python -m acoustid_index_tpu_torch.main --coordinator --coordinator-dir
     D --port 0`) and replicas A and B through build_server in this process
     (--coordinator-url).  500K docs of the bench's shape go in as msgpack
     `POST /main/_update` entries of 50K docs through A (each acknowledged
     once A has applied it); A's checkpoints must merge on the card with no
     host fallback.  512 queries of phase 2's shape on A equal the oracle.
     The coordinator's retention is truncated below its head, and B starts
     with --peers A: it must bootstrap from A's /_snapshot (answering 503 /
     LOADING while it fills, timed by its spans under a capture), catch up
     from the changelog and answer the 512 queries equal to the oracle and
     byte-equal to A.  Phase 2's write mix goes through B: every write reads
     back on B at once and on A once A's watermark reaches it, deleted docs
     vanish on both; 10 single writes time the lag from B's acknowledgement
     to A.  The coordinator is SIGKILLed and restarted on its directory: a
     write through A reads back on both.  K1 and K2 must launch in A's and in
     B's search rounds, counted apart, the scans never.
  2b. the model wrapper at the same width: FingerprintSearchModel.ingest of
     the 240M postings on the card, then one B=256 forward under a
     profiler capture (utils/profiling.py; its trace must hold the
     kernels): every answer equal to the oracle, K1's and K2's launch
     counters grown; then entry() once.
  3. the CLI entry: `python -m acoustid_index_tpu_torch.main --port 0
     --search-port -1 --legacy-port N --mesh-shards 4 --profile-port -1`
     over a directory holding a checkpointed 12,000-doc index serves a PUT
     and a search on its HTTP and native ports, a begin/insert/commit/search
     session on its legacy port whose answer equals the HTTP search, one
     capture on its profiler port whose trace holds K1 and K2 (searches of
     the 12,000-doc index run meanwhile), and stops on SIGTERM.
  4. the headline bench (acoustid_index_tpu_torch/bench.py, the counterpart
     of the root bench.py): with every launch counter at 0,
     bench.main(["--seconds", "3", "--no-134m", "--out",
     "chiprun_out/bench_smoke.json"]) at the root bench's widths (its 134M
     step is phase 1d's): the parity gate on the card, the 10M-doc kernel
     phase, mesh 1, 2M docs end to end through both fronts, the stubbed
     host-only windows, HTTP bulk ingest, the read/write mix.  It must exit
     0 with no *_error key; its hit rates >= 0.95, its miss rates 0,
     e2e_rw_segments > 1; its stubbed windows may launch no K1/K2 and run no
     program, and K1 and K2 must launch on its path (launches_by_path
     "bench").
  5. the 134M corpus through the front door (bench_100m.load_through_server):
     the CLI's server (main.build_server; --checkpoint-threshold one below
     the 2^30 postings, --checkpoint-age-ms 0, --search-port -1) takes
     PUT /main and the corpus as 299 msgpack POST /main/_bulk bodies of
     450K docs in position order from 4 clients; its maintenance thread's
     threshold checkpoint must write one file segment, every merge of the
     load on the card (device >= 1, fallback 0; a host short of RAM for
     the load fails it with the amount it needs); then the server is
     stopped and started again on its directory, timed to its first
     answered _search, and must serve the file tier interleaved on the card
     with 2^31 entries.  The restart builds that tier on the card
     (engine/card_tier.py): its counters must read one card segment, no host
     segment and no copy-back, and csrc/varint_decode.cu's five kernels
     (count, decode, sums, carries, apply) two launches each.  Then
     (varint_at_scale) the served tier and its top index, and the segment's
     lazy columns, must equal the host decoder's 2^30 postings
     (filefmt.read_segment); the segment's stream, read onto the card again,
     must give them through varint.decode_columns and, into a fresh
     interleaved tier, the served tier's bytes through varint.decode; the
     kernels must equal the plain version on the stream's first 2^22 pairs;
     each kernel's device time at the restart's launches is timed by CUDA
     events around it alone, beside the bytes it needs.  With every launch
     counter at 0: two batches of 256 (6 of a target's 8 hashes + 4
     random) and the boundary batch through
     the Python server, every answer equal to tests/oracle.py over the
     analytic corpus (bench_100m.OracleCorpus) with self-retrieval 1.0, and
     through the native front, every body byte-equal; then phase 2's write
     mix (1,000 new docs above 2^27, 5 rewrites, 5 deletes) read back and
     searched against the oracle with the changes applied.  K1 and K2 must
     launch (launches_by_path "front_door_134m"), no varint kernel, the
     scans never, with at most 2 host syncs per batch; the seconds of the load, the checkpoint
     and the restart, their spans, peak host RSS and the card's peak are
     logged; the card's memory must come back within 64 MiB.

Each phase's seconds are logged.  The run fails if jax, any module of
acoustid_index_tpu or of probes/ was imported.
The last three lines of stdout are the card's nvidia-smi line, a JSON
object of per-kernel results, and {"ok": true, "device": {...}}; every
phase's figures also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 512  # phase-2 searches of the read phase (>= 256)
THREADS = 32
QUERY_OPTS = {"limit": 10, "min_score": 6, "score_pct": 10, "timeout": 10_000}
LOADGEN_S, LOADGEN_SWEEP_S = 10, 5  # seconds of load on the native front
LOADGEN_CONNS = 256  # the load generator's keep-alive connections
PUMPS_SWEEP = (1, 2, 4, 8)  # fronts of these pump counts (the default is 1), outside the counted window
MERGE_SOURCES = 8  # phase 1b: sources of each merged run (plus one newer source outside it)
MERGE_SIZES = (100_000, 1_000_000, 10_000_000)  # phase 1b: postings of the runs, each checked bit for bit and timed
MERGE_ROUNDS = 3
MODEL_BATCH = 256  # phase 2b: queries of the model wrapper's forward
MESH_SHARDS = 8  # phase 2c: shards of the sharded server (over the visible cards, one slot per card)
CLI_SHARDS, CLI_DOCS = 4, 12_000  # phase 3: the CLI's --mesh-shards, and the docs of its pre-built index
CLI_RESIDENT_MAX_BYTES = 64 * 1024  # phase 3: its file tier interleaves (~73K entries per shard)
# Phase 2d: docs written through the changelog (the bench's 10M cut to
# 500K: every doc passes the host's change path -- decode, the
# coordinator's append, the consumer's reads, a commit that repacks the
# memory tier -- at ~13-17 s per 100K docs, and phase 4 needs the time the
# cut from 1M frees); docs per _update entry (6.8 MB of msgpack: a
# 100K-doc entry took 29.5 s to acknowledge when the coordinator compacted
# its log under it, against the 30 s read-your-writes deadline); A's and
# B's checkpoint threshold in postings (each checkpoint merges >= 10^6
# postings on the card); single writes timed from B's acknowledgement to A.
REPLICA_DOCS, REPLICA_ENTRY_DOCS = 500_000, 50_000
REPLICA_CHECKPOINT = 1_200_000
REPLICA_LAG_WRITES = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def profiled(fn):
    """fn() under utils.profiling.capture; returns (fn's result, ms per
    span name and on the card by kind, names of the card's kernels), read
    from the capture's Chrome trace (its `dur` is in microseconds)."""
    from acoustid_index_tpu_torch.utils import profiling

    kinds = {"kernel": "card:kernels", "gpu_memcpy": "card:memcpy", "gpu_memset": "card:memset"}
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profiling.capture(trace_dir):
            result = fn()
        (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    totals = {}
    for e in events:
        key = e["name"] if e.get("cat") == "user_annotation" else kinds.get(e.get("cat"))
        if key:
            totals[key] = totals.get(key, 0.0) + e["dur"] / 1e3
    return result, totals, {e["name"] for e in events if e.get("cat") == "kernel"}


# ---------------------------------------------------------------- phase 1


def phase1_kernels(dev):
    """The kernels at the main path's shapes (measure.py's cases) on
    synthetic tables made from a seed; one record per case."""
    import torch

    from acoustid_index_tpu_torch import measure as m
    from acoustid_index_tpu_torch.ops import _build
    from acoustid_index_tpu_torch.ops.layout import BLOCK, to_storage

    t0 = time.perf_counter()
    _build.library()
    log(f"phase1: kernels ready after {time.perf_counter() - t0:.3f} s more "
        f"(nvcc {_build.build_seconds.get('kernels', 'cached')} s, started in phase 0)")

    # The serving tier's shape: 262,144 interleaved blocks (2 GiB) holding
    # the 10M-doc corpus's 240M postings, then padding; a B=256 batch of
    # ~120-hash queries, 20 of each 120 hashes stored ones; QUERY_SETS such
    # batches, so that the cold turns find fresh lookups.
    g = torch.Generator(device=dev).manual_seed(1)
    nblk, n_live = 262_144, m.N_DOCS * m.HASHES_PER_DOC
    h = m.sorted_table(nblk * BLOCK, n_live, g, dev)
    inter = m.interleave(h, torch.randint(1, 0xFFFFFFFF, h.shape, generator=g, device=dev, dtype=torch.int64))
    qpool = torch.randint(0, 0xFFFFFFFF, (m.QUERY_SETS, m.LOOKUPS), generator=g, device=dev, dtype=torch.int64)
    qpool[:, ::6] = h[torch.randint(0, n_live, qpool[:, ::6].shape, generator=g, device=dev)]
    del h
    mem = to_storage(m.sorted_table(m.MEM_TIER_CAP, m.MEM_TIER_LIVE, g, dev))
    log(f"phase1: shape (b)'s table: {m.MEM_TIER_CAP} entries, {m.MEM_TIER_LIVE} live (the phase-2 memory tier)")
    results = [m.run_case(c, log) for c in m.main_path_cases(inter, n_live, qpool, mem, g)]
    del inter, mem
    torch.cuda.empty_cache()
    results += [m.run_case(c, log) for c in m.phase1_cases(dev, g)]
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 1b


def merge_run(total: int, seed: int):
    """A run of MERGE_SOURCES sources holding ~`total` postings of 24-hash
    docs (commit ids 1..8), and the collection it lives in: the run plus
    one newer source.  Consecutive sources overlap by a quarter of their
    docs (re-inserts with new hashes); every source deletes docs of earlier
    ones and some never inserted (tombstones); every 97th doc carries hash
    0xFFFFFFFF; doc 0xFFFFFFFF is inserted, deleted and inserted again; the
    newer source re-inserts and deletes docs of the run."""
    import numpy as np

    from acoustid_index_tpu_torch.engine.memseg import build_segment
    from acoustid_index_tpu_torch.engine.model import BulkInsert, Delete, Insert, SegmentInfo
    from acoustid_index_tpu_torch.engine.segments import Snapshot
    from acoustid_index_tpu_torch.measure import HASHES_PER_DOC, doc_hashes

    rng = np.random.default_rng(seed)
    per = max(total // MERGE_SOURCES // HASHES_PER_DOC, 8)
    step = per * 3 // 4
    segs = []
    for k in range(MERGE_SOURCES + 1):
        lo = 1 + k * step
        if k == MERGE_SOURCES:  # newer than the run: re-inserts the middle sources' docs
            lo = 1 + 3 * step
        ids = np.arange(lo, lo + per, dtype=np.uint32)
        h = doc_hashes(ids) ^ np.uint32((k * 0x9E3779B9) & 0xFFFFFFFF)
        h[::97, 0] = 0xFFFFFFFF
        offsets = np.arange(0, (per + 1) * HASHES_PER_DOC, HASHES_PER_DOC, dtype=np.uint32)
        changes = [BulkInsert(ids=ids, hashes=h.reshape(-1), offsets=offsets)]
        dels = rng.integers(1, lo + per + step, max(per // 50, 2))
        changes += [Delete(id=int(i)) for i in dels if not lo <= i < lo + per]
        if k in (2, 6):
            changes.append(Insert(id=0xFFFFFFFF, hashes=[0xFFFFFFFF, 5 + k, 0xFFFFFFFF]))
        elif k == 4:
            changes.append(Delete(id=0xFFFFFFFF))
        segs.append(build_segment(changes, SegmentInfo(commit_id=k + 1)))
    return segs[:MERGE_SOURCES], Snapshot(file=tuple(segs))


def phase1b_merge(dev):
    """The device merge against the host merger at each of MERGE_SIZES:
    bit-equal, then both timed in turns, then one device merge profiled."""
    import numpy as np
    import torch

    from acoustid_index_tpu_torch.engine.device_merge import merge_segments_device
    from acoustid_index_tpu_torch.engine.memseg import merge_segments

    out = {"sizes": {}}
    for total in MERGE_SIZES:
        run, collection = merge_run(total, seed=total % 1000 + 1)
        postings = sum(s.num_items for s in run)
        t0 = time.perf_counter()
        want = merge_segments(run, collection)
        host_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = merge_segments_device(run, collection, device=dev)
        device_first = time.perf_counter() - t0
        for f in ("info", "min_doc_id", "max_doc_id", "metadata"):
            check(getattr(got, f) == getattr(want, f), f"device merge at {postings} postings: {f} differs")
        for f in ("hashes", "docids", "docs_ids", "docs_alive"):
            a, b = getattr(got, f), getattr(want, f)
            check(a.dtype == b.dtype and np.array_equal(a, b), f"device merge at {postings} postings: {f} differs")
        ffff = int(np.searchsorted(want.docs_ids, np.uint32(0xFFFFFFFF)) < want.num_docs)
        check(ffff and (want.hashes == 0xFFFFFFFF).any(), f"the run at {postings} postings lost its 0xFFFFFFFF cases")
        times = {"host": [], "device": []}
        for r in range(MERGE_ROUNDS):  # in turns: host, device, device, host, ...
            for route in (("host", "device") if r % 2 == 0 else ("device", "host")):
                t0 = time.perf_counter()
                if route == "host":
                    merge_segments(run, collection)
                else:
                    merge_segments_device(run, collection, device=dev)
                times[route].append(time.perf_counter() - t0)
        rec = {"postings": postings, "sources": len(run), "kept": want.num_items, "docs": want.num_docs,
               "doc_ffff_kept": ffff, "host_first_s": host_first, "device_first_s": device_first,
               "host_s": times["host"], "device_s": times["device"],
               "host_median_s": float(np.median(times["host"])), "device_median_s": float(np.median(times["device"]))}
        # Where the device merge's time goes: one more call, profiled.
        _, spans, _ = profiled(lambda: merge_segments_device(run, collection, device=dev))
        rec["device_spans_ms"] = spans
        out["sizes"][str(total)] = rec
        log(f"phase1b: {len(run)} sources, {postings} postings -> {want.num_items} kept, {want.num_docs} docs; "
            f"device merge bit-equal to the host merge; host {rec['host_median_s'] * 1e3:.3f} ms, device "
            f"{rec['device_median_s'] * 1e3:.3f} ms (medians of {MERGE_ROUNDS} in turns; first calls "
            f"{host_first * 1e3:.3f} / {device_first * 1e3:.3f} ms); one more device merge under the profiler, ms: "
            + json.dumps({k: round(v, 3) for k, v in sorted(spans.items())}))
        del run, collection, want, got
        torch.cuda.empty_cache()
    faster = [int(t) for t, r in out["sizes"].items() if r["device_median_s"] < r["host_median_s"]]
    out["crossover"] = min(faster) if faster else None
    log(f"phase1b: the device merge is faster from {out['crossover']} postings on "
        f"(sizes {list(MERGE_SIZES)}; DEVICE_MERGE_MIN_POSTINGS routes from 1,000,000)")
    return out


# ---------------------------------------------------------------- phase 1c


def phase1c_probes(dev):
    """The probes path with the counters from 0, then K3-K5 alone at the
    probes' shapes; returns (launches on the path, kernel records)."""
    import torch

    from acoustid_index_tpu_torch import measure as m
    from acoustid_index_tpu_torch import probes
    from acoustid_index_tpu_torch.ops import _build
    from acoustid_index_tpu_torch.ops import block_lookup as bl

    t_phase = t0 = time.perf_counter()
    _build.library("probes")
    _build.library("designs")
    log(f"phase1c: probe kernels and designs ready after {time.perf_counter() - t0:.3f} s more "
        f"(nvcc {_build.build_seconds.get('probes', 'cached')} s and {_build.build_seconds.get('designs', 'cached')} s, "
        f"started in phase 0)")
    for k in bl.LAUNCHES:
        bl.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:  # its lines, prefixed, below
        rc = probes.main(["--check-only", "--seed", "5", "--out", os.path.join(HERE, "chiprun_out", "probes_check.json")])
    torch.cuda.synchronize()
    launches = dict(bl.LAUNCHES)
    for line in out.getvalue().splitlines():
        log(f"phase1c: {line}")
    check(rc == 0, f"the probes path failed a check (exit {rc}): chiprun_out/probes_check.json")
    log(f"phase1c: probes --check-only in {time.perf_counter() - t0:.1f} s: every parity check and every site "
        f"variant bit-equal to its plain version; launches {launches}")
    for k in ("block_count", "block_count_emit", "block_count_pair", "block_count_emit_docids", "block_count_staged"):
        check(launches[k] > 0, f"{k} never launched on the probes path")
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(6)
    t = probes.build_tables(dev, g)
    results = [m.run_case(c, log) for c in m.probe_kernel_cases(t, g)]
    del t
    torch.cuda.empty_cache()
    log(f"phase1c: done in {time.perf_counter() - t_phase:.1f} s")
    return launches, results


# ---------------------------------------------------------------- phase 1d


def phase1d_scale(dev):
    """The 134M scale point (acoustid_index_tpu_torch/bench_100m.py): the
    tier built on the card; K1 and K2 at shapes (e)-(g) bit-equal to
    their plain versions, then timed; with the launch counters at 0, the
    bench's run checked against the analytic oracle; the stage split.
    Returns (launches on the path, kernel records, figures, the tier and
    each card's allocation before it, for phase 1e, which frees it)."""
    import numpy as np
    import torch

    from acoustid_index_tpu_torch import bench_100m
    from acoustid_index_tpu_torch import measure as m
    from acoustid_index_tpu_torch.engine.searcher import Searcher
    from acoustid_index_tpu_torch.ops import block_lookup as bl

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = {d: torch.cuda.memory_allocated(d) for d in range(torch.cuda.device_count())}
    snap, fig = bench_100m.build_timed(dev, lambda msg: log(f"phase1d: {msg}"))
    check(snap.file_view["inter"].numel() == 2**31 and snap.file_view["inter"].is_cuda,
          f"the 134M tier holds {snap.file_view['inter'].numel()} entries on {snap.file_view['inter'].device}")

    rng = np.random.default_rng(12)
    g = torch.Generator(device=dev).manual_seed(12)
    cases = m.scale_cases(snap.file_view["inter"], m.scale_qpool(rng, dev), g)
    results = [m.run_case(c, log) for c in cases]  # each bit-equal to the plain version first
    del cases
    torch.cuda.empty_cache()

    for k in bl.LAUNCHES:
        bl.LAUNCHES[k] = 0
    fig.update(bench_100m.run(dev, snap, scale_oracle, lambda msg: log(f"phase1d: {msg}")))
    torch.cuda.synchronize()
    launches = dict(bl.LAUNCHES)
    check_launches(launches, "phase1d")
    log(f"phase1d: launches on the 134M path {launches}")

    packs = [bench_100m.pack(*bench_100m.make_queries(rng)[1:]) for _ in range(m.STAGE_BATCHES)]
    fig["stages"] = m.stage_split(Searcher(dev), snap, bench_100m.params(), packs, log=lambda msg: log(f"phase1d: {msg}"),
                                  label="134M")
    fig["phase_s"] = time.perf_counter() - t_phase
    log(f"phase1d: done in {fig['phase_s']:.1f} s; the tier goes on to phase 1e")
    return launches, results, fig, {"snap": snap, "base": base}


def scale_oracle(q):
    """tests/oracle.py over the 134M corpus's postings of the query's
    hashes (bench_100m.oracle_postings), at the bench's limit, min_score
    and pct."""
    from acoustid_index_tpu_torch import bench_100m
    from oracle import OracleSegment, oracle_search

    return oracle_search([OracleSegment(bench_100m.oracle_postings(q), {})], q, limit=bench_100m.LIMIT,
                         min_score=bench_100m.MIN_SCORE, pct=bench_100m.PCT)


# ---------------------------------------------------------------- phase 1e


def phase1e_mesh_134m(held, single):
    """Phase 1d's 134M tier over MESH_SHARDS hash-range shards
    (bench_100m.shard_tier), run by bench_100m.run_sharded twice: (a) one
    slot per visible card up to 4 (on one card: views of the tier, no
    copy), (b) four slots, one per visible card and then cuda:0 again (on
    one card: four copies, four streams, the joins).  Each with the launch
    counters at 0: every answer equal to the oracle, the packed outputs'
    digests equal to phase 1d's single program's, K1 and K2 4 launches per
    batch, <= 2 host syncs per batch, each card freed after it.  With two
    cards or more, K1 and K2 on the last card from a thread whose current
    device is card 0, against their plain versions.  Last, phase 1d's tier
    is freed: every card back within 64 MiB of its level before phase 1d.
    Returns (launches on the path, figures)."""
    import torch

    from acoustid_index_tpu_torch import bench_100m
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.parallel import sharded as sh

    count = torch.cuda.device_count()
    n = bench_100m.MESH_SHARDS
    cards = [torch.device("cuda", i) for i in range(min(n, count))]
    placements = {"cards": sh.make_mesh(n), "slots": sh.make_mesh(n, cards + [cards[0]] * (n - len(cards)))}
    check(placements["cards"].slots == tuple(cards), f"make_mesh({n}) took {placements['cards'].slots}, not {cards}")
    launches = dict.fromkeys(bl.LAUNCHES, 0)
    figs = {"visible_cards": count}
    for label, mesh in placements.items():
        log(f"phase1e: {label}: {torch.cuda.device_count()} visible cards; {sh.describe_mesh(mesh)}")
        for d in range(count):
            torch.cuda.synchronize(d)
        level = [torch.cuda.memory_allocated(d) for d in range(count)]
        t0 = time.perf_counter()
        sharded = bench_100m.shard_tier(held["snap"], mesh)
        shard_s = time.perf_counter() - t0
        for k in bl.LAUNCHES:
            bl.LAUNCHES[k] = 0
        fig = bench_100m.run_sharded(sharded, mesh, scale_oracle, lambda msg: log(f"phase1e {label}: {msg}"))
        for d in range(count):
            torch.cuda.synchronize(d)
        got = dict(bl.LAUNCHES)
        for k in launches:
            launches[k] += got[k]
        check_launches(got, f"phase1e {label}")
        per = fig["timed"]["launches_per_batch"]
        check(per == {"block_count": float(n), "block_count_emit": float(n)},
              f"phase1e {label}: K1/K2 launches per batch {per}, not {n} each")
        check(fig["timed"]["host_syncs_per_batch"] <= 2, f"phase1e {label}: {fig['timed']['host_syncs_per_batch']} host syncs per batch")
        check(fig["digests"] == single["digests"],
              f"phase1e {label}: packed outputs differ from phase 1d's single program: {fig['digests']} against {single['digests']}")
        del sharded
        torch.cuda.empty_cache()
        left = [(torch.cuda.memory_allocated(d) - level[d]) / 2**20 for d in range(count)]
        check(max(left) <= 64, f"phase1e {label}: MiB still allocated per card after the run: {left}")
        fig.update(shard_tier_s=shard_s, allocated_after_mib=left)
        t, t1 = fig["timed"], single["timed"]
        log(f"phase1e {label}: every answer equal to the oracle; outputs byte-equal to phase 1d's; host ms per batch p50 "
            f"{t['host_ms_p50']:.3f} p99 {t['host_ms_p99']:.3f} (single {t1['host_ms_p50']:.3f} / {t1['host_ms_p99']:.3f}); "
            f"card span p50 {t['card_span_ms_p50']:.3f} ms (single {t1['card_span_ms_p50']:.3f}); launches per batch {per}; "
            f"host syncs per batch {t['host_syncs_per_batch']}; peak GiB per card {fig['peak_allocated_gib']}")
        figs[label] = fig
    if count >= 2:
        figs["cross_card_kernels"] = cross_card_kernels(count)

    snap = held.pop("snap")
    del snap
    torch.cuda.empty_cache()
    left = {d: (torch.cuda.memory_allocated(d) - held["base"][d]) / 2**20 for d in range(count)}
    check(max(left.values()) <= 64, f"phase1e: MiB of the 134M phases still allocated per card after them: {left}")
    figs["allocated_after_mib"] = left
    log(f"phase1e: the 134M tier freed ({left} MiB above each card's level before phase 1d)")
    return launches, figs


def cross_card_kernels(count: int) -> dict:
    """K1 and K2 on the last card, launched from a thread whose current
    device is card 0 (as a front's pump thread may be), each bit-equal to
    its plain version on the same inputs."""
    import torch

    from acoustid_index_tpu_torch import measure as m
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.ops.layout import BLOCK, to_storage

    last = torch.device("cuda", count - 1)
    out, errors = {}, []

    def work():
        try:
            torch.cuda.set_device(0)
            g = torch.Generator(device=last).manual_seed(21)
            nblk = 8192
            h = m.sorted_table(nblk * BLOCK, nblk * BLOCK - 3000, g, last)
            inter = m.interleave(h, torch.randint(1, 0xFFFFFFFF, h.shape, generator=g, device=last, dtype=torch.int64))
            table = to_storage(h)
            blk = torch.randint(0, nblk, (32768,), generator=g, device=last, dtype=torch.int64)
            q = h[blk * BLOCK + torch.randint(0, BLOCK, blk.shape, generator=g, device=last)]
            q[::3] = torch.randint(0, 0xFFFFFFFF, q[::3].shape, generator=g, device=last, dtype=torch.int64)
            k1, k2 = bl.block_count(table, blk, q), bl.block_count_emit(inter, blk, q)
            torch.cuda.synchronize(last)
            k1_plain, k2_plain = bl.block_count_plain(table, blk, q), bl.block_count_emit_plain(inter, blk, q)
            out.update(current_device=torch.cuda.current_device(), card=str(k1[0].device),
                       k1_equal=all(torch.equal(a, b) for a, b in zip(k1, k1_plain)),
                       k2_equal=all(torch.equal(a, b) for a, b in zip(k2, k2_plain)))
        except Exception as exc:  # noqa: BLE001 -- fatal, reported below
            errors.append(repr(exc))

    t = threading.Thread(target=work)
    t.start()
    t.join()
    check(not errors, f"phase1e: K1/K2 on {last} from a thread on cuda:0 failed: {errors}")
    check(out["current_device"] == 0 and out["card"] == str(last) and out["k1_equal"] and out["k2_equal"],
          f"phase1e: K1/K2 on {last} from a thread on cuda:0: {out}")
    log(f"phase1e: K1 and K2 on {last} launched from a thread whose current device is cuda:0, bit-equal to their plain versions")
    return out


# ---------------------------------------------------------------- phase 2


class BaseSegment:
    """The bulk-loaded corpus as one oracle segment: (hash, docid) sorted,
    every doc 1..n_docs alive (duck-typed for tests/oracle.py)."""

    def __init__(self, hashes, docids, n_docs):
        self.hashes, self.docids, self.n_docs = hashes, docids, n_docs
        self.docs = self  # `docid in seg.docs`

    def __contains__(self, docid):
        return 1 <= docid <= self.n_docs

    def postings(self, h):
        import numpy as np

        lo = np.searchsorted(self.hashes, np.uint32(h), side="left")
        hi = np.searchsorted(self.hashes, np.uint32(h), side="right")
        return self.docids[lo:hi].tolist()


def run_searches(base: str, queries):
    """POST every query from THREADS client threads; returns (responses in
    query order as (status, parsed body, raw body), wall seconds,
    per-request seconds)."""
    import requests

    out = [None] * len(queries)
    lat = [0.0] * len(queries)
    nxt = [0]
    lock = threading.Lock()
    errors = []

    def worker():
        s = requests.Session()
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(queries):
                return
            try:
                t0 = time.perf_counter()
                r = s.post(f"{base}/main/_search", json={"query": queries[i], **QUERY_OPTS}, timeout=60)
                lat[i] = time.perf_counter() - t0
                out[i] = (r.status_code, r.json(), r.content)
            except Exception as exc:  # noqa: BLE001 -- reported below
                errors.append(repr(exc))
                return

    ts = [threading.Thread(target=worker) for _ in range(THREADS)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"search requests failed: {errors[:3]}")
    return out, wall, lat


def check_answers(queries, answers, segments, label):
    from oracle import oracle_search

    for q, (status, body, _) in zip(queries, answers):
        check(status == 200, f"{label}: HTTP {status}: {body}")
        got = [(r["id"], r["score"]) for r in body["results"]]
        want = oracle_search(segments, q, limit=QUERY_OPTS["limit"], min_score=QUERY_OPTS["min_score"], pct=QUERY_OPTS["score_pct"])
        check(got == want, f"{label}: query answer {got[:3]} != oracle {want[:3]}")


def post_updates(base: str, changes) -> None:
    import requests

    for lo in range(0, len(changes), 100):
        r = requests.post(f"{base}/main/_update", json={"changes": changes[lo : lo + 100]}, timeout=60)
        check(r.status_code == 200, f"_update failed: {r.status_code} {r.text}")


N_NEW = 1000  # new docs of the write mix


def write_mix(base: str, n_docs: int, targets, queries, rng, base_seg, label: str):
    """Writes over HTTP (N_NEW new docs, 5 re-inserts, 5 deletes of
    targets), then searches for the new and the re-inserted docs and some
    old ones: every answer equal to the oracle, every acknowledged write
    read back first, deleted docs gone.  Returns (the oracle's segments
    after the writes, figures, verify): verify(url, label) repeats those
    checks against another server of the same index."""
    import numpy as np
    import requests

    from acoustid_index_tpu_torch.measure import doc_hashes, make_query
    from oracle import OracleSegment

    new_ids = np.arange(n_docs + 1, n_docs + 1 + N_NEW, dtype=np.uint32)
    new_h = doc_hashes(new_ids)
    reins = [int(t) for t in targets[:5]]
    reins_h = doc_hashes(np.asarray(reins, np.uint32) + np.uint32(3_000_000_000))
    dels = [int(t) for t in targets[5:10]]
    t1 = time.perf_counter()
    post_updates(base, [{"insert": {"id": int(i), "hashes": new_h[k].tolist()}} for k, i in enumerate(new_ids)])
    for k, i in enumerate(reins):
        r = requests.put(f"{base}/main/{i}", json={"hashes": reins_h[k].tolist()}, timeout=60)
        check(r.status_code == 200, f"PUT failed: {r.status_code} {r.text}")
    for i in dels:
        r = requests.delete(f"{base}/main/{i}", timeout=60)
        check(r.status_code == 200, f"DELETE failed: {r.status_code} {r.text}")
    writes_s = time.perf_counter() - t1

    latest = {int(i): new_h[k].tolist() for k, i in enumerate(new_ids)}
    latest.update({i: reins_h[k].tolist() for k, i in enumerate(reins)})
    items = [(h, d) for d, hs in latest.items() for h in hs]
    segments = [base_seg, OracleSegment(items, {**{d: True for d in latest}, **{d: False for d in dels}})]

    q_new = [make_query(rng, new_h[k]) for k in range(N_NEW)]
    q_old = queries[:10] + [make_query(rng, reins_h[k]) for k in range(5)]

    def verify(url: str, where: str) -> None:
        answers_new, _, _ = run_searches(url, q_new + q_old)
        check_answers(q_new + q_old, answers_new, segments, f"{where}: after writes")
        for k, i in enumerate(new_ids):
            top = answers_new[k][1]["results"]
            check(top and top[0]["id"] == int(i), f"{where}: new doc {i} does not read back first: {top[:2]}")
        for (_, body, _) in answers_new[N_NEW : N_NEW + 10]:
            check(not any(r["id"] in dels for r in body["results"]), f"{where}: a deleted doc was returned")
        for i in dels:
            check(requests.get(f"{url}/main/{i}", timeout=60).status_code == 404, f"{where}: deleted doc {i} still found")
        for i in list(new_ids[:20]) + reins:
            check(requests.head(f"{url}/main/{int(i)}", timeout=60).status_code == 200, f"{where}: doc {i} not found")

    verify(base, label)
    log(f"{label}: {N_NEW} new docs, {len(reins)} re-inserts, {len(dels)} deletes in {writes_s:.2f} s; "
        f"{len(q_new) + len(q_old)} searches equal the oracle; every write reads back; deleted docs gone")
    return segments, {"writes_s": writes_s, "searches": len(q_new) + len(q_old)}, verify


def hot_hash_groups(base: str, next_id: int, segments, rng, counts, groups, label: str) -> dict:
    """For each (branch, n_hot, hot_hash) of `groups`: n_hot docs that share
    hot_hash, then searches for them, sent alone so that every batch takes
    `branch` (a key of `counts()`, the program's branch counters).  A query
    gathers the hot hash's whole memory-tier run: over P_MEM_DIRECT
    postings rules out the direct path; with at most P_SMALL in all the
    batch takes the P_SMALL gather, above it the full budget.  Every answer
    equals the oracle and ranks its doc first.  Appends to `segments`."""
    import numpy as np

    from acoustid_index_tpu_torch.measure import doc_hashes, make_query
    from oracle import OracleSegment

    out = {}
    for branch, n_hot, hot_hash in groups:
        hot_ids = np.arange(next_id, next_id + n_hot, dtype=np.uint32)
        next_id += n_hot
        hot_h = doc_hashes(hot_ids)
        hot_h[:, 0] = hot_hash
        post_updates(base, [{"insert": {"id": int(i), "hashes": hot_h[k].tolist()}} for k, i in enumerate(hot_ids)])
        segments.append(OracleSegment([(h, int(d)) for d, hs in zip(hot_ids, hot_h.tolist()) for h in hs],
                                      {int(d): True for d in hot_ids}))
        q_hot = [make_query(rng, hot_h[k]) for k in range(min(n_hot, 64))]
        before = counts()
        answers_hot, _, _ = run_searches(base, q_hot)
        ran = {k: v - before[k] for k, v in counts().items()}
        check_answers(q_hot, answers_hot, segments, f"{label}: hot hash, {branch} branch")
        for k, (_, body, _) in enumerate(answers_hot):
            check(body["results"] and body["results"][0]["id"] == int(hot_ids[k]),
                  f"{label}: hot doc {hot_ids[k]} not first: {body['results'][:2]}")
        check(ran[branch] > 0 and sum(ran.values()) == ran[branch], f"{label}: {branch} queries ran the batches {ran}")
        out[f"hot_{branch}"] = {"docs": n_hot, "searches": len(q_hot), "batches": ran}
        log(f"{label}: {n_hot} docs sharing hash {hot_hash:#x}; {len(q_hot)} searches equal the oracle, "
            f"every batch on the {branch} branch {ran}")
    return out


def phase2_serving(n_docs: int, n_requests: int, native_built, base_seg):
    """Returns (figures, what phase 2c reuses: a copy of the checkpointed
    directory, the read phase's queries and the Python server's bodies)."""
    import numpy as np

    from acoustid_index_tpu_torch import main as cli
    from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
    from acoustid_index_tpu_torch.measure import HASHES_PER_DOC, MEM_TIER_CAP, doc_hashes, make_query
    from acoustid_index_tpu_torch.multi.multi_index import MultiIndex
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.ops import search_kernel as sk
    from acoustid_index_tpu_torch.ops.layout import postings_cap
    from acoustid_index_tpu_torch.utils.device import device

    dev = device()
    stats = {"docs": n_docs, "postings": n_docs * HASHES_PER_DOC}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    served = None
    try:
        # Bulk load with the index's maintenance thread stopped, so that no
        # background memory merge can abort the one forced checkpoint that
        # writes the whole load as one file segment: its ten sources merge
        # on the card (merge_segments_auto -> the device merge).
        # (Index.flush() would first fold the memory tier into one segment,
        # now also on the card, and then checkpoint that single segment,
        # which merge_segments_auto leaves to the host merger: one source.
        # With both merges on the host it took 527 s at this scale, against
        # ~115 s for the forced checkpoint; NVIDIA H100 80GB HBM3, 700 W.)
        t0 = time.perf_counter()
        loader = BatchingSearcher()
        mi = MultiIndex.open(tmp, searcher=loader, checkpoint_age=None,
                             checkpoint_threshold=n_docs * HASHES_PER_DOC + 1, sync=False)
        mi.create_index("main")
        ref = mi._get_ref("main")
        try:
            ref.index.stop()
            step = 1_000_000
            for lo in range(1, n_docs + 1, step):
                ids = np.arange(lo, min(lo + step, n_docs + 1), dtype=np.uint32)
                ref.index.bulk_insert(ids, doc_hashes(ids))
            stats["bulk_insert_s"] = time.perf_counter() - t0
            stats["checkpoint_sources"] = len(ref.index.acquire_reader().memory)
            t1 = time.perf_counter()
            _, stats["checkpoint_spans_ms"], _ = profiled(lambda: ref.index.checkpoint(force=True))
            stats["checkpoint_s"] = time.perf_counter() - t1
            check(not ref.index.acquire_reader().memory, "the checkpoint left memory segments")
            stats["checkpoint_merges"] = ref.index.merge_counts.as_dict()
        finally:
            mi._release_ref(ref)
        mi.close()
        loader.close()
        merges = stats["checkpoint_merges"]
        log(f"phase2: ingested {n_docs} docs in {stats['bulk_insert_s']:.1f} s, checkpointed "
            f"{stats['checkpoint_sources']} memory segments to disk in {stats['checkpoint_s']:.3f} s "
            f"(under the profiler, its export included); merges by route {merges}; spans, ms: "
            + json.dumps({k: round(v, 3) for k, v in sorted(stats["checkpoint_spans_ms"].items())}))
        check(merges["device"] >= 1 and merges["fallback"] == 0, f"the checkpoint did not merge on the card: {merges}")
        # Phase 2c serves this checkpointed directory again, sharded: a copy
        # taken before phase 2's writes.
        t1 = time.perf_counter()
        mesh_dir = tmp + "_mesh"
        shutil.copytree(tmp, mesh_dir)
        stats["dir_copy_s"] = time.perf_counter() - t1

        # Reopen and serve as the CLI does, with a fresh process-wide searcher.
        t1 = time.perf_counter()
        native_built()  # the front's library, before build_server starts it
        args = cli.build_parser().parse_args(["--dir", tmp, "--host", "127.0.0.1", "--port", "0", "--checkpoint-age-ms", "0",
                                              "--search-port", "-1"])
        served = cli.build_server(args)
        server, mi, _, front, _ = served
        server.serve_background()  # at once: stop_server's shutdown() waits for a serving loop
        stats["reopen_s"] = time.perf_counter() - t1
        ref = mi._get_ref("main")
        index = ref.index
        mi._release_ref(ref)
        snap = index.ensure_views(index.acquire_reader())
        check(not snap.memory and len(snap.file) == 1, "reopened index is not one file segment")
        inter = snap.file_view.get("inter")
        check(inter is not None, "file tier did not take the interleaved layout")
        check(inter.device.type == dev.type, f"file tier on {inter.device}, expected {dev}")
        stats["file_tier_bytes"] = inter.numel() * 4
        log(f"phase2: reopened from disk in {stats['reopen_s']:.1f} s; file tier inter {inter.numel() * 4 / 2**30:.2f} GiB on {inter.device}")
        del snap, inter

        base = f"http://127.0.0.1:{server.port}"

        rng = np.random.default_rng(7)
        targets = rng.integers(1, n_docs + 1, n_requests, dtype=np.uint32)
        th = doc_hashes(targets)
        queries = [make_query(rng, th[i]) for i in range(n_requests)]

        # ---- the main path: counters from zero, then HTTP traffic ----
        for k in bl.LAUNCHES:
            bl.LAUNCHES[k] = 0
        stats0 = dict(sk.STATS)
        answers, wall, lat = run_searches(base, queries)
        check_answers(queries, answers, [base_seg], "read phase")
        handoff = {"dir": mesh_dir, "queries": queries, "targets": targets, "bodies": [a[2] for a in answers]}
        hits = sum(1 for (_, body, _), t in zip(answers, targets) if body["results"] and body["results"][0]["id"] == int(t))
        p50, p99 = (float(np.percentile(lat, p)) * 1e3 for p in (50, 99))
        stats.update(search_requests=n_requests, search_wall_s=wall, search_qps=n_requests / wall, target_top1=hits,
                     latency_p50_ms=p50, latency_p99_ms=p99, read_branches={k: sk.STATS[k] - stats0[k] for k in sk.STATS})
        log(f"phase2: {n_requests} searches from {THREADS} threads in {wall:.3f} s = {n_requests / wall:.1f} qps "
            f"(wall clock), latency p50 {p50:.2f} ms p99 {p99:.2f} ms; all equal the oracle; "
            f"target ranked first in {hits}/{n_requests}; batches {stats['read_branches']}")

        # ---- writes over HTTP, then docs that share one hot hash ----
        segments, stats["writes"], _ = write_mix(base, n_docs, targets, queries, rng, base_seg, "phase2")
        mem_view = index.ensure_views(index.acquire_reader()).mem_view
        mem_cap = int(mem_view["hashes"].shape[0]) if "hashes" in mem_view else None
        check(mem_cap is not None and mem_cap > 4096, f"memory tier cap {mem_cap}: not on the resident path")
        log(f"phase2: memory tier cap {mem_cap} (resident path)")
        stats.update(hot_hash_groups(
            base, n_docs + 1 + N_NEW, segments, rng, lambda: {k: sk.STATS[k] for k in ("direct", "matrix", "sort")},
            (("matrix", sk.P_MEM_DIRECT + 36, 0x5EED0001), ("sort", sk.P_SMALL + 44, 0x5EED0002)), "phase2",
        ))

        stats["launches"] = dict(bl.LAUNCHES)
        stats["branches"] = {k: sk.STATS[k] - stats0[k] for k in sk.STATS}

        # The memory tier the native path searches: phase 1's shape (b).
        mem_view = index.ensure_views(index.acquire_reader()).mem_view
        stats["mem_tier"] = {"cap": postings_cap(mem_view), "live": int(mem_view["seg_len"].sum())}
        check(stats["mem_tier"]["cap"] == MEM_TIER_CAP, f"memory tier {stats['mem_tier']}: phase 1's shape (b) assumed {MEM_TIER_CAP}")
        log(f"phase2: live memory tier {stats['mem_tier']} (phase 1's shape (b): {MEM_TIER_CAP} entries)")
        log(f"phase2: launches during serving {stats['launches']}; batches/branches/host syncs {stats['branches']}")

        stats["native"] = native_path(mi, front, base, queries, segments)
        stats["serving_merges"] = index.merge_counts.as_dict()
        check(stats["serving_merges"]["fallback"] == 0, f"a merge fell back to the host: {stats['serving_merges']}")
        return stats, handoff
    except BaseException:
        shutil.rmtree(tmp + "_mesh", ignore_errors=True)
        raise
    finally:
        if served is not None:
            cli.stop_server(*served)
        shutil.rmtree(tmp, ignore_errors=True)


def loadgen(port: int, blobs_path: str, seconds: float, conns: int) -> dict:
    """One run of the native load generator in its own process; its
    one-line JSON {count, miss, window_s, p50_ms, p99_ms}."""
    from acoustid_index_tpu_torch.utils.native import loadgen_path

    cmd = [loadgen_path(), "--port", str(port), "--seconds", str(seconds), "--conns", str(conns),
           "--blobs", blobs_path, "--seed", "1"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=seconds + 120)
    check(r.returncode == 0, f"aitpu_loadgen exited {r.returncode}: {r.stderr.strip()[-500:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["qps"] = out["count"] / out["window_s"] if out["window_s"] else 0.0
    out["conns"] = conns
    return out


def native_path(mi, front, py_base, queries, segments):
    """The native search front on the index the Python server serves: the
    main path read with the launch counters from zero (512 searches from
    THREADS client threads, then LOADGEN_S of load from a separate
    process), then the byte comparison with the Python server and the pumps
    sweep outside that window."""
    import msgpack
    import numpy as np

    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.ops import search_kernel as sk
    from acoustid_index_tpu_torch.server.native_front import NativeFront

    base = f"http://127.0.0.1:{front.port}"
    out = {"pumps": front.pumps}
    for k in bl.LAUNCHES:
        bl.LAUNCHES[k] = 0
    stats0 = dict(sk.STATS)
    answers, wall, lat = run_searches(base, queries)
    check_answers(queries, answers, segments, "native front")
    p50, p99 = (float(np.percentile(lat, p)) * 1e3 for p in (50, 99))
    out.update(searches=len(queries), wall_s=wall, qps=len(queries) / wall, latency_p50_ms=p50, latency_p99_ms=p99)
    log(f"phase2: native front on port {front.port}: {len(queries)} searches from {THREADS} threads in {wall:.3f} s "
        f"= {len(queries) / wall:.1f} qps (wall clock), latency p50 {p50:.2f} ms p99 {p99:.2f} ms; all equal the oracle")

    # The load generator's blobs: each request with the first result the
    # oracle-checked answer above holds, which every response must contain.
    blobs = []
    for q, (_, body, _) in zip(queries, answers):
        req = json.dumps({"query": q, **QUERY_OPTS}).encode()
        top = body["results"]
        expect = b'"results": [{"id": %d,' % top[0]["id"] if top else b'"results": []'
        blobs.append((expect, b"POST /main/_search HTTP/1.1\r\nHost: smoke\r\nContent-Type: application/json\r\n"
                              b"Content-Length: %d\r\n\r\n%s" % (len(req), req)))
    fd, blobs_path = tempfile.mkstemp(suffix=".blobs")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(msgpack.packb(blobs))
        load = loadgen(front.port, blobs_path, LOADGEN_S, LOADGEN_CONNS)
        check(load["count"] > 0 and load["miss"] == 0, f"native front under load: {load}")
        out["load"] = load
        out["launches"] = dict(bl.LAUNCHES)
        out["branches"] = {k: sk.STATS[k] - stats0[k] for k in sk.STATS}
        log(f"phase2: aitpu_loadgen, {LOADGEN_CONNS} connections, {LOADGEN_S} s: {json.dumps(load)}")
        log(f"phase2: launches during the native path {out['launches']}; batches/branches/host syncs {out['branches']}")

        # Outside the counted window: the Python server's bytes for the same
        # queries, and the same load against fronts of other pump counts.
        py_answers, _, _ = run_searches(py_base, queries)
        same = sum(a[2] == b[2] for a, b in zip(answers, py_answers))
        check(same == len(queries), f"native bodies byte-equal to the Python server's for {same}/{len(queries)} queries")
        log(f"phase2: all {len(queries)} native response bodies byte-equal to the Python server's")
        out["pumps_sweep"] = {}
        for pumps in PUMPS_SWEEP:
            other = NativeFront(mi, 0, pumps=pumps)
            other.start()
            try:
                load = loadgen(other.port, blobs_path, LOADGEN_SWEEP_S, LOADGEN_CONNS)
            finally:
                other.stop()
            check(load["count"] > 0 and load["miss"] == 0, f"native front of {pumps} pumps under load: {load}")
            out["pumps_sweep"][pumps] = load
            log(f"phase2: {pumps} pumps: {json.dumps(load)}")
    finally:
        os.unlink(blobs_path)
    return out


# ---------------------------------------------------------------- phase 2c


def phase2c_mesh(handoff, n_docs: int, native_built, base_seg):
    """Mesh serving: phase 2's checkpointed directory served again through
    build_server with --mesh-shards MESH_SHARDS and a search port.  The
    same searches through both fronts, equal to the oracle and byte-equal
    to phase 2's Python server; the write mix; the hot-hash groups on the
    sharded program's P_SMALL and full-budget paths; K1 and K2 launched at
    least MESH_SHARDS times per batch, at most 2 host syncs per batch;
    then dryrun_multichip(MESH_SHARDS) over the visible cards."""
    import numpy as np
    import torch

    from acoustid_index_tpu_torch import main as cli
    from acoustid_index_tpu_torch.entry import dryrun_multichip
    from acoustid_index_tpu_torch.measure import HASHES_PER_DOC
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.ops import search_kernel as sk
    from acoustid_index_tpu_torch.parallel import sharded as sh
    from acoustid_index_tpu_torch.parallel.serving import ShardedBatchingSearcher

    tmp, queries, py_bodies = handoff["dir"], handoff["queries"], handoff["bodies"]
    stats = {"shards": MESH_SHARDS, "searches": len(queries)}
    served = None
    try:
        t1 = time.perf_counter()
        native_built()
        args = cli.build_parser().parse_args(["--dir", tmp, "--host", "127.0.0.1", "--port", "0", "--checkpoint-age-ms", "0",
                                              "--search-port", "-1", "--mesh-shards", str(MESH_SHARDS)])
        served = cli.build_server(args)
        server, mi, _, front, _ = served
        server.serve_background()
        stats["reopen_s"] = time.perf_counter() - t1
        check(isinstance(mi.searcher, ShardedBatchingSearcher) and mi.searcher.n_shards == MESH_SHARDS,
              f"build_server did not shard search: {type(mi.searcher).__name__}")
        cards = tuple(torch.device("cuda", i) for i in range(min(MESH_SHARDS, torch.cuda.device_count())))
        check(mi.searcher.mesh.slots == cards, f"--mesh-shards {MESH_SHARDS} took {mi.searcher.mesh.slots}, not {cards}")
        stats["mesh"] = sh.describe_mesh(mi.searcher.mesh)
        log(f"phase2c: {torch.cuda.device_count()} visible cards; {stats['mesh']}")
        ref = mi._get_ref("main")
        index = ref.index
        mi._release_ref(ref)
        snap = index.ensure_views(index.acquire_reader())
        check(not snap.memory and len(snap.file) == 1, "reopened index is not one file segment")
        slots = snap.file_view["slots"]
        check(all("inter" in f and f["inter"].device == d for f, d in zip(slots, cards)),
              "the sharded file tier is not interleaved on the slots' cards")
        entries = sum(f["inter"].numel() for f in slots)
        shard_cap = entries // (2 * MESH_SHARDS)
        live = torch.cat([f["seg_len"].cpu() for f in slots]).reshape(MESH_SHARDS, -1).sum(1).tolist()
        check(sum(live) == n_docs * HASHES_PER_DOC, f"the shards hold {sum(live)} postings")
        stats.update(file_tier_bytes=entries * 4, shard_cap=shard_cap, shard_postings=live)
        log(f"phase2c: reopened phase 2's directory over {MESH_SHARDS} shards in {stats['reopen_s']:.1f} s: "
            f"{entries * 4 / 2**30:.2f} GiB interleaved, {shard_cap} entries per shard, postings per shard {live}")
        del snap, slots

        base = f"http://127.0.0.1:{server.port}"
        native = f"http://127.0.0.1:{front.port}"
        for k in bl.LAUNCHES:
            bl.LAUNCHES[k] = 0
        syncs0, branches0 = sk.STATS["host_syncs"], dict(sh.STATS)
        for label, url in (("Python HTTP", base), ("native front", native)):
            answers, wall, lat = run_searches(url, queries)
            check_answers(queries, answers, [base_seg], f"phase2c {label}")
            same = sum(a[2] == b for a, b in zip(answers, py_bodies))
            check(same == len(queries), f"phase2c {label}: {same}/{len(queries)} bodies byte-equal to phase 2's Python server")
            p50, p99 = (float(np.percentile(lat, p)) * 1e3 for p in (50, 99))
            stats[label] = {"wall_s": wall, "qps": len(queries) / wall, "latency_p50_ms": p50, "latency_p99_ms": p99}
            log(f"phase2c: {len(queries)} searches through the {label} in {wall:.3f} s = {len(queries) / wall:.1f} qps "
                f"(wall clock), latency p50 {p50:.2f} ms p99 {p99:.2f} ms; all equal the oracle and byte-equal to "
                f"phase 2's single-path bodies")

        rng = np.random.default_rng(8)
        segments, stats["writes"], _ = write_mix(base, n_docs, handoff["targets"], queries, rng, base_seg, "phase2c")
        stats.update(hot_hash_groups(
            base, n_docs + 1 + N_NEW, segments, rng,
            lambda: {k: sh.STATS[k] for k in ("direct_wide", "direct_narrow", "small", "full")},
            (("small", sk.P_MEM_DIRECT + 36, 0x5EED0001), ("full", sk.P_SMALL + 44, 0x5EED0002)), "phase2c",
        ))

        batches = sh.STATS["batches"] - branches0["batches"]
        syncs = sk.STATS["host_syncs"] - syncs0
        stats.update(launches=dict(bl.LAUNCHES), batches=batches, host_syncs=syncs,
                     branches={k: sh.STATS[k] - branches0[k] for k in sh.STATS})
        log(f"phase2c: {batches} sharded batches; launches {stats['launches']}; host syncs {syncs}; "
            f"branches {stats['branches']}")
        for k in ("block_count", "block_count_emit"):
            check(stats["launches"][k] >= MESH_SHARDS * batches > 0,
                  f"{k} launched {stats['launches'][k]} times in {batches} batches of {MESH_SHARDS} shards")
        for k in ("block_count_scan", "block_count_emit_scan"):
            check(stats["launches"][k] == 0, f"{k} launched on the sharded path")
        check(syncs <= 2 * batches, f"{syncs} host syncs in {batches} sharded batches")
        stats["serving_merges"] = index.merge_counts.as_dict()
        check(stats["serving_merges"]["fallback"] == 0, f"a merge fell back to the host: {stats['serving_merges']}")
    finally:
        if served is not None:
            cli.stop_server(*served)
        shutil.rmtree(tmp, ignore_errors=True)

    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        dryrun_multichip(MESH_SHARDS)
    stats["dryrun_s"] = time.perf_counter() - t1
    log(f"phase2c: {out.getvalue().strip()} ({stats['dryrun_s']:.1f} s)")
    return stats


# ---------------------------------------------------------------- phase 2d


def announced(proc, words, timeout: float, what: str) -> dict:
    """The ports a CLI process prints as `<WORD> <port>` lines, one per
    word.  A thread reads them: two lines can arrive in one read, and the
    second then waits in the pipe's buffer, where select() never sees it."""
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True).start()
    ports, deadline = {}, time.time() + timeout
    while len(ports) < len(words):
        left = deadline - time.time()
        check(left > 0 and proc.poll() is None, f"{what} announced only {ports} (rc {proc.poll()})")
        try:
            word, _, port = lines.get(timeout=min(left, 1.0)).partition(" ")
        except queue.Empty:
            continue
        if word in words:
            ports[word] = int(port)
    return ports


def start_coordinator(cdir: str, port: int = 0):
    """`python -m acoustid_index_tpu_torch.main --coordinator --coordinator-dir
    cdir` (the durable FileCoordinator) in a subprocess; returns (process,
    its port) once it announces `LISTENING <port>`."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "acoustid_index_tpu_torch.main", "--coordinator", "--coordinator-dir", cdir,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        return proc, announced(proc, ("LISTENING",), 60, "the coordinator")["LISTENING"]
    except SystemExit:
        proc.kill()
        proc.wait()
        raise


def wait_for(fn, timeout: float, what: str, poll: float = 0.01):
    """Poll fn() until it returns a truthy value; that value, or fail."""
    import requests

    deadline = time.perf_counter() + timeout
    while True:
        try:
            got = fn()
            if got:
                return got
        except requests.RequestException:
            pass
        if time.perf_counter() > deadline:
            fail(f"timed out after {timeout} s waiting for {what}")
        time.sleep(poll)


def status(url: str) -> dict:
    import requests

    r = requests.get(f"{url}/main/_status", timeout=60)
    check(r.status_code == 200, f"{url}/main/_status: HTTP {r.status_code} {r.text[:200]}")
    return r.json()


def check_launches(launches: dict, label: str) -> None:
    """K1 and K2 launched, the scanning designs never."""
    for k in ("block_count", "block_count_emit"):
        check(launches[k] > 0, f"{label}: {k} never launched")
    for k in ("block_count_scan", "block_count_emit_scan"):
        check(launches[k] == 0, f"{label}: {k} launched {launches[k]} times")


def search_round(url: str, queries, segments, label: str, stats: dict):
    """The queries from THREADS clients with the launch counters from 0:
    every answer equal to the oracle; figures into stats[label]; returns
    the raw bodies."""
    import numpy as np

    from acoustid_index_tpu_torch.ops import block_lookup as bl

    for k in bl.LAUNCHES:
        bl.LAUNCHES[k] = 0
    answers, wall, lat = run_searches(url, queries)
    launches = dict(bl.LAUNCHES)
    check_answers(queries, answers, segments, label)
    check_launches(launches, label)
    p50, p99 = (float(np.percentile(lat, p)) * 1e3 for p in (50, 99))
    stats[label] = {"searches": len(queries), "wall_s": wall, "qps": len(queries) / wall, "latency_p50_ms": p50,
                    "latency_p99_ms": p99, "launches": launches}
    log(f"phase2d: {label}: {len(queries)} searches from {THREADS} threads in {wall:.3f} s = {len(queries) / wall:.1f} qps "
        f"(wall clock), latency p50 {p50:.2f} ms p99 {p99:.2f} ms; all equal the oracle; launches {launches}")
    return [a[2] for a in answers]


def on_card(mi, label: str, dev) -> dict:
    """The replica's tiers live on the card; returns its index's merge counts."""
    ref = mi._get_ref("main")
    index = ref.index
    mi._release_ref(ref)
    snap = index.ensure_views(index.acquire_reader())
    for tier, view in (("file", snap.file_view), ("memory", snap.mem_view)):
        table = view.get("inter", view.get("hashes"))
        check(table is not None and table.device.type == dev.type, f"{label}: its {tier} tier is on {getattr(table, 'device', None)}")
    return {"file_segments": len(snap.file), "memory_segments": len(snap.memory), "merges": index.merge_counts.as_dict()}


def phase2d_replicas(dev, n_docs: int, entry_docs: int, n_requests: int):
    """The replicated deployment: a durable coordinator through the CLI, and
    replicas A and B through build_server in this process.  The corpus goes
    in as _update entries through A; after a retention truncation, B
    bootstraps from A's snapshot; both answer the queries as the oracle does,
    B's bodies byte-equal to A's; B takes the write mix, which reads back
    on B at once and on A by its applied watermark; the coordinator survives
    a SIGKILL."""
    import msgpack
    import numpy as np
    import requests

    from acoustid_index_tpu_torch import main as cli
    from acoustid_index_tpu_torch.measure import HASHES_PER_DOC, doc_hashes, make_query, sorted_corpus
    from oracle import OracleSegment

    t_phase = time.perf_counter()
    stats = {"docs": n_docs, "postings": n_docs * HASHES_PER_DOC, "entry_docs": entry_docs,
             "checkpoint_threshold": REPLICA_CHECKPOINT}
    log(f"phase2d: docs={n_docs} ({n_docs * HASHES_PER_DOC} postings) through the changelog in entries of {entry_docs}; "
        f"cut from the bench's 10M because every doc crosses the host's change path (decode, the coordinator's "
        f"append, the consumer's reads, a commit that repacks the memory tier) at ~13-17 s per 100K docs: 10M "
        f"would outlast the smoke's time limit")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    cdir = os.path.join(tmp, "coordinator")
    coord, cport = start_coordinator(cdir)
    curl = f"http://127.0.0.1:{cport}"
    replicas = {}

    def replica(name: str, peers=()):
        argv = ["--dir", os.path.join(tmp, name), "--host", "127.0.0.1", "--port", "0", "--coordinator-url", curl,
                "--checkpoint-threshold", str(REPLICA_CHECKPOINT), "--checkpoint-age-ms", "0"]
        if peers:
            argv += ["--peers", ",".join(peers)]
        served = cli.build_server(cli.build_parser().parse_args(argv))
        served[0].serve_background()
        replicas[name] = served
        return served[1], f"http://127.0.0.1:{served[0].port}"

    try:
        mi_a, a = replica("a")
        check(requests.put(f"{a}/main", timeout=60).status_code == 200, "phase2d: PUT /main on A failed")

        # ---- the corpus through the changelog: _update entries on A ----
        entries = []
        for lo in range(1, n_docs + 1, entry_docs):
            ids = np.arange(lo, min(lo + entry_docs, n_docs + 1), dtype=np.uint32)
            h = doc_hashes(ids).tolist()
            body = msgpack.packb({"c": [{"i": {"i": int(i), "h": h[k]}} for k, i in enumerate(ids.tolist())]})
            check(len(body) < 16 * 1024 * 1024, f"phase2d: an entry of {len(ids)} docs is {len(body)} bytes")
            t1 = time.perf_counter()
            r = requests.post(f"{a}/main/_update", data=body, timeout=120,
                              headers={"Content-Type": "application/vnd.msgpack", "Accept": "application/json"})
            dt = time.perf_counter() - t1
            check(r.status_code == 200, f"phase2d: _update of docs {lo}.. on A: HTTP {r.status_code} {r.text[:300]}")
            entries.append({"docs_before": lo - 1, "docs": len(ids), "bytes": len(body), "apply_s": dt,
                            "version": r.json()["version"]})
            log(f"phase2d: entry of {len(ids)} docs ({len(body)} bytes) over {lo - 1} stored: acknowledged by A "
                f"(appended and applied) in {dt:.3f} s")
        stats["entries"] = entries
        stats["write_s"] = sum(e["apply_s"] for e in entries)
        head = entries[-1]["version"]
        st_a = status(a)
        check(st_a["version"] >= head, f"phase2d: A's version {st_a['version']} < its acknowledged {head}")
        stats["a_after_writes"] = on_card(mi_a, "A", dev)
        merges = stats["a_after_writes"]["merges"]
        log(f"phase2d: {n_docs} docs ({n_docs * HASHES_PER_DOC} postings) in {len(entries)} entries in "
            f"{stats['write_s']:.1f} s; A {stats['a_after_writes']}, file_version {st_a['file_version']}")
        check(merges["device"] >= 1 and merges["fallback"] == 0, f"phase2d: A's checkpoints did not merge on the card: {merges}")

        # ---- A answers the queries ----
        t1 = time.perf_counter()
        base_seg = BaseSegment(*sorted_corpus(n_docs, dev), n_docs)
        stats["oracle_sort_s"] = time.perf_counter() - t1
        rng = np.random.default_rng(9)
        targets = rng.integers(1, n_docs + 1, n_requests, dtype=np.uint32)
        th = doc_hashes(targets)
        queries = [make_query(rng, th[i]) for i in range(n_requests)]
        bodies_a = search_round(a, queries, [base_seg], "A", stats)

        # ---- truncate below the head; B bootstraps from A's snapshot ----
        floor = st_a["file_version"]
        check(0 < floor < head, f"phase2d: A's file_version {floor} is not below the head {head}")
        r = requests.post(f"{curl}/_truncate/main/{st_a['generation']}", params={"floor": floor}, timeout=60)
        check(r.status_code == 200, f"phase2d: truncate: HTTP {r.status_code} {r.text[:200]}")
        seen = set()

        def bootstrap():
            t1 = time.perf_counter()
            mi_b, b = replica("b", peers=[a])

            def caught_up():
                r = requests.post(f"{b}/main/_search", json={"query": queries[0], **QUERY_OPTS}, timeout=60)
                h = requests.get(f"{b}/main/_health", timeout=60)
                seen.add((r.status_code, h.status_code, h.text.strip()[:16]))
                return r.status_code == 200 and h.status_code == 200 and status(b)["version"] >= head

            wait_for(caught_up, 600, "B to bootstrap and catch up", poll=0.05)
            return mi_b, b, time.perf_counter() - t1

        (mi_b, b, stats["bootstrap_s"]), spans, _ = profiled(bootstrap)
        stats["bootstrap_spans_ms"] = {k: v for k, v in spans.items() if k.startswith(("bootstrap.", "tier.", "card:"))}
        stats["bootstrap_seen"] = sorted(map(list, seen))
        st_b = status(b)
        stats["b_after_bootstrap"] = on_card(mi_b, "B", dev)
        check(stats["b_after_bootstrap"]["file_segments"] >= 1 and "bootstrap.transfer" in spans,
              f"phase2d: B did not install a snapshot: {stats['b_after_bootstrap']}, spans {sorted(spans)}")
        log(f"phase2d: truncated the changelog below {floor} (head {head}); B bootstrapped from A's snapshot and "
            f"caught up to {st_b['version']} in {stats['bootstrap_s']:.3f} s (under the profiler); spans, ms: "
            + json.dumps({k: round(v, 3) for k, v in sorted(stats["bootstrap_spans_ms"].items())})
            + f"; B's answers while it filled {stats['bootstrap_seen']}; B {stats['b_after_bootstrap']}")
        bodies_b = search_round(b, queries, [base_seg], "B", stats)
        same = sum(x == y for x, y in zip(bodies_a, bodies_b))
        check(same == len(queries), f"phase2d: {same}/{len(queries)} of B's bodies byte-equal to A's")
        log(f"phase2d: all {len(queries)} of B's bodies byte-equal to A's")

        # ---- the write mix through B: read-your-writes on B, then on A ----
        segments, stats["writes"], verify = write_mix(b, n_docs, targets, queries, rng, base_seg, "phase2d B")
        v_b = status(b)["version"]
        t1 = time.perf_counter()
        wait_for(lambda: status(a)["version"] >= v_b, 120, "A to apply B's writes")
        stats["a_watermark_wait_s"] = time.perf_counter() - t1
        verify(a, "phase2d A")
        log(f"phase2d: A applied B's writes (version {v_b}) {stats['a_watermark_wait_s']:.3f} s after B's checks; "
            f"every write reads back on A, deleted docs gone")

        # Replica lag: single writes through B, each from B's acknowledgement
        # to the doc's visibility on A.
        lag_ids = np.arange(n_docs + 5001, n_docs + 5001 + REPLICA_LAG_WRITES, dtype=np.uint32)
        lag_h = doc_hashes(lag_ids)
        lags = []
        for k, i in enumerate(lag_ids.tolist()):
            r = requests.put(f"{b}/main/{i}", json={"hashes": lag_h[k].tolist()}, timeout=60)
            t_ack = time.perf_counter()
            check(r.status_code == 200, f"phase2d: PUT through B: HTTP {r.status_code} {r.text[:200]}")
            wait_for(lambda: requests.head(f"{a}/main/{i}", timeout=60).status_code == 200, 60, f"doc {i} on A", poll=0.001)
            lags.append(time.perf_counter() - t_ack)
        segments.append(OracleSegment([(h, d) for d, hs in zip(lag_ids.tolist(), lag_h.tolist()) for h in hs],
                                      {d: True for d in lag_ids.tolist()}))
        stats["lag_s"] = lags
        log(f"phase2d: replica lag, B's acknowledgement to visibility on A, {len(lags)} writes: median "
            f"{float(np.median(lags)) * 1e3:.1f} ms, max {max(lags) * 1e3:.1f} ms")

        # ---- the coordinator survives a SIGKILL ----
        head_before = status(a)["version"]
        gen = status(a)["generation"]
        coord.kill()
        coord.wait()
        t1 = time.perf_counter()
        coord, _ = start_coordinator(cdir, cport)
        stats["coordinator_restart_s"] = time.perf_counter() - t1
        last_id = n_docs + 9001
        last_h = doc_hashes(np.array([last_id], np.uint32))[0].tolist()
        wait_for(lambda: requests.put(f"{a}/main/{last_id}", json={"hashes": last_h}, timeout=60).status_code == 200,
                 60, "a write through A after the restart", poll=0.2)
        v_last = status(a)["version"]
        check(v_last > head_before and status(a)["generation"] == gen,
              f"phase2d: after the restart A is at version {v_last} (was {head_before}), generation {status(a)['generation']} ({gen})")
        segments.append(OracleSegment([(h, last_id) for h in last_h], {last_id: True}))
        wait_for(lambda: status(b)["version"] >= v_last, 60, "B to apply the write after the restart")
        q_last = [make_query(rng, np.asarray(last_h, np.uint32))] + [make_query(rng, lag_h[k]) for k in range(len(lag_ids))]
        for label, url in (("A", a), ("B", b)):
            answers, _, _ = run_searches(url, q_last + queries[:64])
            check_answers(q_last + queries[:64], answers, segments, f"phase2d {label} after the coordinator restart")
            check(answers[0][1]["results"][:1] and answers[0][1]["results"][0]["id"] == last_id,
                  f"phase2d: {label} does not rank the write after the restart first")
        log(f"phase2d: coordinator SIGKILLed and restarted on its directory in {stats['coordinator_restart_s']:.2f} s; "
            f"a write through A (version {v_last} > {head_before}, generation {gen}) reads back on A and B, and "
            f"{len(q_last) + 64} searches on each equal the oracle")
        stats["merges"] = {"A": on_card(mi_a, "A", dev)["merges"], "B": on_card(mi_b, "B", dev)["merges"]}
        for name, m in stats["merges"].items():
            check(m["fallback"] == 0, f"phase2d: a merge on {name} fell back to the host: {m}")
    finally:
        for served in replicas.values():
            cli.stop_server(*served)
        if coord.poll() is None:
            coord.kill()
            coord.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"phase2d: done in {stats['phase_s']:.1f} s")
    return stats


# ---------------------------------------------------------------- phase 2b


def phase2b_model(dev, n_docs: int, base_seg):
    """The model wrapper at the bench's width: ingest phase 2's corpus on
    the card, one B = MODEL_BATCH forward under a profiler capture, every
    answer equal to the oracle; then entry() once."""
    import numpy as np
    import torch

    from acoustid_index_tpu_torch.engine.searcher import _params_for
    from acoustid_index_tpu_torch.entry import entry
    from acoustid_index_tpu_torch.measure import HASHES_PER_DOC, doc_hashes, make_query
    from acoustid_index_tpu_torch.models.fingerprint_search import FingerprintSearchModel
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from oracle import oracle_search

    stats = {}
    ids = np.arange(1, n_docs + 1, dtype=np.uint32)
    hashes = doc_hashes(ids).reshape(-1)
    doc_ids = np.repeat(ids, HASHES_PER_DOC)
    params = _params_for(128)
    model = FingerprintSearchModel(params, device=dev)
    t0 = time.perf_counter()
    table = model.ingest(hashes, doc_ids)
    torch.cuda.synchronize()
    stats["ingest_s"] = time.perf_counter() - t0
    del hashes, doc_ids
    check("inter" in table.file_tier and table.file_tier["inter"].device.type == "cuda",
          "the model's table is not the interleaved tier on the card")
    check((table.n_postings, table.n_docs) == (n_docs * HASHES_PER_DOC, n_docs), f"table of {table.n_postings} postings")
    log(f"phase2b: FingerprintSearchModel.ingest of {table.n_postings} postings on the card in {stats['ingest_s']:.3f} s "
        f"(device sort + the port's packing: {table.file_tier['inter'].numel() * 4 / 2**30:.2f} GiB interleaved tier)")

    rng = np.random.default_rng(17)
    targets = rng.integers(1, n_docs + 1, MODEL_BATCH, dtype=np.uint32)
    th = doc_hashes(targets)
    queries = [make_query(rng, th[i]) for i in range(MODEL_BATCH)]
    qs = np.zeros((MODEL_BATCH, params.query_len), np.uint32)
    lens = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        qs[i, : len(q)] = q
    opts = dict(limit=QUERY_OPTS["limit"], min_score=QUERY_OPTS["min_score"], score_pct=QUERY_OPTS["score_pct"])
    model(table, qs, lens, **opts)  # first use of this shape
    torch.cuda.synchronize()
    for k in bl.LAUNCHES:
        bl.LAUNCHES[k] = 0

    def forward():
        t0 = time.perf_counter()
        out = model(table, qs, lens, **opts)
        count = out["count"].cpu().numpy()
        stats["forward_ms"] = (time.perf_counter() - t0) * 1e3
        return out, count

    (out, count), stats["forward_spans_ms"], kernels = profiled(forward)
    stats["launches"] = dict(bl.LAUNCHES)
    stats["traced_kernels"] = sorted(k for k in kernels if "block_count" in k)
    check(stats["traced_kernels"], f"the profiler trace of forward holds no block_count kernel: {sorted(kernels)[:8]}")
    ids_out, scores = out["ids"].cpu().numpy(), out["scores"].cpu().numpy()
    for i, q in enumerate(queries):
        got = list(zip(ids_out[i, : count[i]].tolist(), scores[i, : count[i]].tolist()))
        want = oracle_search([base_seg], q, limit=opts["limit"], min_score=opts["min_score"], pct=opts["score_pct"])
        check(got == want, f"model forward, query {i}: {got[:3]} != oracle {want[:3]}")
    for k in ("block_count", "block_count_emit"):
        check(stats["launches"][k] > 0, f"{k} never launched by the model's forward")
    log(f"phase2b: forward of B={MODEL_BATCH} in {stats['forward_ms']:.3f} ms (host clock, under the profiler; "
        f"card time, ms: {json.dumps({k: round(v, 3) for k, v in stats['forward_spans_ms'].items()})}); "
        f"every answer equals the oracle; launches {stats['launches']}; traced kernels {stats['traced_kernels']}")
    del table, out
    torch.cuda.empty_cache()

    forward, args = entry()
    res = forward(*args)
    check(args[2].device.type == "cuda" and int(res["count"]) >= 1, f"entry() forward: {res}")
    stats["entry_top"] = [int(res["ids"][0]), int(res["scores"][0])]
    log(f"phase2b: entry() forward on the card: top result {stats['entry_top']}")
    return stats


# ---------------------------------------------------------------- phase 3


def cli_corpus(path: str) -> None:
    """The index "big" under `path`: CLI_DOCS docs of 24 hashes, checkpointed
    into one file segment, so that the CLI's search reaches K2 (the file
    tier interleaves at CLI_RESIDENT_MAX_BYTES) and K1."""
    import numpy as np

    from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
    from acoustid_index_tpu_torch.measure import doc_hashes
    from acoustid_index_tpu_torch.multi.multi_index import MultiIndex

    searcher = BatchingSearcher()
    mi = MultiIndex.open(path, searcher=searcher, checkpoint_age=None)
    try:
        mi.create_index("big")
        ref = mi._get_ref("big")
        try:
            ids = np.arange(1, CLI_DOCS + 1, dtype=np.uint32)
            ref.index.bulk_insert(ids, doc_hashes(ids))
            ref.index.checkpoint(force=True)
            check(not ref.index.acquire_reader().memory, "phase3: the checkpoint left memory segments")
        finally:
            mi._release_ref(ref)
    finally:
        mi.close()
        searcher.close()


def phase3_cli():
    import socket

    import numpy as np
    import requests

    from acoustid_index_tpu_torch.measure import doc_hashes, make_query

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cli_corpus(tmp)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               AITPU_RESIDENT_MAX_BYTES=str(CLI_RESIDENT_MAX_BYTES))
    with socket.socket() as probe:  # --legacy-port takes a port number (0 = off)
        probe.bind(("127.0.0.1", 0))
        legacy_port = probe.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "acoustid_index_tpu_torch.main", "--dir", tmp, "--port", "0", "--search-port", "-1",
         "--legacy-port", str(legacy_port), "--mesh-shards", str(CLI_SHARDS), "--profile-port", "-1"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        # LISTENING <http port>, SEARCHPLANE <native port>, PROFILER <capture port>
        ports = announced(proc, ("LISTENING", "SEARCHPLANE", "PROFILER"), 180, "the CLI server")
        base = f"http://127.0.0.1:{ports['LISTENING']}"
        check(requests.put(f"{base}/cli", timeout=60).status_code == 200, "CLI: PUT index failed")
        check(requests.put(f"{base}/cli/9", json={"hashes": [11, 22, 33, 44]}, timeout=60).status_code == 200, "CLI: PUT doc failed")
        for label, url in (("HTTP", base), ("native", f"http://127.0.0.1:{ports['SEARCHPLANE']}")):
            r = requests.post(f"{url}/cli/_search", json={"query": [22, 33, 44, 55], "timeout": 10_000}, timeout=60)
            check(r.status_code == 200 and r.json()["results"] == [{"id": 9, "score": 3}],
                  f"CLI search on its {label} port: {r.status_code} {r.text}")

        # The legacy line protocol writes to and searches the fixed "main"
        # index; its answer must be the HTTP search's.
        with socket.create_connection(("127.0.0.1", legacy_port), timeout=60) as sock:
            f = sock.makefile("rwb")
            replies = []
            for line in ("begin", "insert 10 11,22,33,44", "insert 12 22,33,-1", "commit", "search 22,33,44,55,-1"):
                f.write(line.encode() + b"\r\n")
                f.flush()
                replies.append(f.readline().decode())
        r = requests.post(f"{base}/main/_search", json={"query": [22, 33, 44, 55, 0xFFFFFFFF], "limit": 500, "min_score": 1}, timeout=60)
        http = "OK " + " ".join(f"{x['id']}:{x['score']}" for x in r.json()["results"]) + "\r\n"
        check(replies[:4] == ["OK \r\n"] * 4 and replies[4] == http == "OK 10:3 12:3\r\n",
              f"CLI legacy session {replies} against the HTTP search {http!r}")

        # One profiler capture while searches of the pre-built index run
        # (one every 0.1 s until it returns: the profiler's start-up takes
        # a moment of the window); its trace must hold K1's and K2's
        # kernels, launched by the sharded program in the server process.
        target = 7
        query = make_query(np.random.default_rng(3), doc_hashes(np.array([target]))[0])
        got = {}
        t_cap = threading.Thread(target=lambda: got.update(
            r=requests.get(f"http://127.0.0.1:{ports['PROFILER']}/capture?ms=3000", timeout=120)))
        t_cap.start()
        searches = 0
        while t_cap.is_alive():
            r = requests.post(f"{base}/big/_search", json={"query": query, **QUERY_OPTS}, timeout=60)
            check(r.status_code == 200 and r.json()["results"][:1] == [{"id": target, "score": 20}],  # its 20 hashes
                  f"CLI search of the pre-built index: {r.status_code} {r.text[:200]}")
            searches += 1
            time.sleep(0.1)
        t_cap.join()
        check(got["r"].status_code == 200, f"CLI capture: HTTP {got['r'].status_code} {got['r'].text[:200]}")
        events = json.loads(got["r"].content)["traceEvents"]
        names = {e.get("name", "") for e in events}
        traced = sorted({k for k in ("block_count_kernel", "block_count_emit_kernel") for n in names if k in n})
        check(traced == ["block_count_emit_kernel", "block_count_kernel"],
              f"the CLI's capture over {searches} searches holds {traced} of K1/K2: kernels "
              f"{sorted(n for n in names if 'kernel' in n)[:8]}, categories {sorted({e.get('cat', '') for e in events})}, "
              f"spans {sorted(n for n in names if n.startswith('search_dispatch'))[:4]}")
        stats = {"shards": CLI_SHARDS, "capture_bytes": len(got["r"].content), "searches_in_capture": searches,
                 "traced_kernels": traced}

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"CLI server exited {rc} on SIGTERM")
        log(f"phase3: CLI entry (--mesh-shards {CLI_SHARDS}) served PUT + a search on its HTTP port and on its native "
            f"search port, a legacy-protocol begin/insert/commit/search on its legacy port ({replies[4].strip()!r}, "
            f"equal to the HTTP search), a capture on its profiler port whose trace holds {traced} over {searches} "
            f"searches of {CLI_DOCS} docs, and stopped on SIGTERM")
        return stats
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 4


BENCH_ARGS = ["--seconds", "3", "--no-134m"]  # phase 1d ran the 134M step at full size
BENCH_MISS_RATES = ("e2e_miss_rate", "e2e_pipeline_miss_rate", "e2e_native_miss_rate", "e2e_rw_miss_rate")
BENCH_STUBBED = ("e2e_native_hostonly", "e2e_pyhttp_hostonly", "e2e_hostonly")


def phase4_bench():
    """The headline bench (acoustid_index_tpu_torch/bench.py, the counterpart
    of the root bench.py) at its widths, its windows cut to 3 s, with the
    launch counters at 0.  Returns (launches on its path, its detail)."""
    from acoustid_index_tpu_torch import bench
    from acoustid_index_tpu_torch.ops import block_lookup as bl

    out = os.path.join(HERE, "chiprun_out", "bench_smoke.json")
    for k in bl.LAUNCHES:
        bl.LAUNCHES[k] = 0
    rc = bench.main(BENCH_ARGS + ["--out", out])
    launches = dict(bl.LAUNCHES)
    with open(out) as f:
        detail = json.load(f)
    errors = sorted(k for k in detail if k.endswith("_error"))
    check(rc == 0 and not errors, f"phase4: the bench exited {rc}: {[(k, detail[k]) for k in errors]}")
    check(detail.get("parity_gate") == "ok", "phase4: the parity gate did not pass")
    for k in ("self_retrieval_hit_rate", "sharded_hit_rate"):
        check(detail[k] >= 0.95, f"phase4: {k} {detail[k]} < 0.95")
    for k in BENCH_MISS_RATES:
        check(detail[k] == 0, f"phase4: {k} {detail[k]}")
    check(detail["e2e_rw_segments"] > 1, f"phase4: e2e_rw_segments {detail['e2e_rw_segments']}: no S > 1 state")
    stubbed = detail["stubbed_windows"]
    check(sorted(stubbed) == sorted(BENCH_STUBBED), f"phase4: stubbed windows {sorted(stubbed)}")
    for label, moved in stubbed.items():
        check(not any(moved.values()), f"phase4: the stubbed window {label} ran the card: {moved}")
    check_launches(launches, "phase4")
    log(f"phase4: the bench passed its checks; launches on its path {launches}; seconds per phase "
        + json.dumps({k: round(v, 1) for k, v in detail["phase_s"].items()}))
    return launches, detail


# ---------------------------------------------------------------- phase 5


VARINT_KERNELS = ("count", "decode", "sums", "carries", "apply")
VARINT_STEP = 1 << 26  # postings per step of a comparison with host arrays
VARINT_PLAIN_PAIRS = 1 << 22  # pairs of the stream's prefix that the plain version decodes
VARINT_ROUNDS = 5  # timed launches of each kernel


def varint_at_scale(served, dev, log5):
    """The restart's file tier and csrc/varint_decode.cu's five kernels at
    the main path's shape: phase 5's one file segment, 2^30 postings.  The
    served tier (interleaved, its top index) equals the host decoder's
    columns (filefmt.read_segment: native.decode_postings) with SENTINEL
    padding; the segment's lazy columns, copied back from that tier, equal
    them too.  The segment's postings stream is read onto the card again:
    ops/varint.decode_columns gives the host decoder's columns, decode
    straight into a fresh interleaved tier with its top index gives the
    served tier's bytes, and on the stream's first VARINT_PLAIN_PAIRS pairs
    the kernels equal the plain version (whose int64 temporaries take ~90
    bytes a posting: the whole stream would not fit).  Then each kernel's
    device time at the restart's launches (a scan of the stream, a decode
    into the interleaved tier) by CUDA events around it, beside the bytes
    it needs and torch.cumsum of both columns as the scans' yardstick.
    Returns the figures."""
    import numpy as np
    import torch

    from acoustid_index_tpu_torch import bench_100m
    from acoustid_index_tpu_torch.engine import card_tier, filefmt
    from acoustid_index_tpu_torch.measure import HBM_BYTES_PER_S
    from acoustid_index_tpu_torch.ops import varint
    from acoustid_index_tpu_torch.ops.layout import BLOCK

    sentinel = np.uint32(0xFFFFFFFF)
    out = {}
    index = bench_100m._index(served[1])
    snap = index.acquire_reader()
    check(len(snap.file) == 1 and isinstance(snap.file[0], card_tier.CardSegment),
          f"phase5: the restart served {[type(s).__name__ for s in snap.file]}, not one CardSegment")
    seg = snap.file[0]
    check(seg.file_bytes is None, "phase5: the segment packed alone still holds its file bytes on the card")
    inter, top = snap.file_view["inter"], snap.file_view["block_index"]
    n, cap = seg.num_items, inter.shape[0] // 2
    del snap

    t0 = time.perf_counter()
    host = filefmt.read_segment(index.data_dir, seg.info)
    want_h, want_d = host.hashes, host.docids
    del host
    out["host_read_s"] = time.perf_counter() - t0

    def padded(col, s, e):
        w = np.full(e - s, sentinel, np.uint32)
        k = max(0, min(e, n) - s)
        w[:k] = col[s : s + k]
        return w

    def equals_host(label, hashes, docids):
        """An interleaved tier of cap postings (docids None) or plain int32
        columns of n on the card against the host columns, SENTINEL past n."""
        end = cap if docids is None else n
        for s in range(0, end, VARINT_STEP):
            e = min(s + VARINT_STEP, end)
            if docids is None:
                blk = hashes[2 * s : 2 * e].view(-1, 2, BLOCK).cpu().numpy().view(np.uint32)
                gh, gd = blk[:, 0].reshape(-1), blk[:, 1].reshape(-1)
            else:
                gh = hashes[s:e].cpu().numpy().view(np.uint32)
                gd = docids[s:e].cpu().numpy().view(np.uint32)
            check(np.array_equal(gh, padded(want_h, s, e)) and np.array_equal(gd, padded(want_d, s, e)),
                  f"phase5: {label} differs from the host decoder in postings [{s}, {e})")

    equals_host("the served tier", inter, None)
    check(np.array_equal(top.cpu().numpy().view(np.uint32), padded(want_h, 0, cap)[::BLOCK]),
          "phase5: the served tier's top index differs from the host decoder's hashes")

    fetched = card_tier.COLUMNS["columns_fetched"]
    t0 = time.perf_counter()
    lazy_h, lazy_d = seg.hashes, seg.docids
    out["lazy_fetch_s"] = time.perf_counter() - t0
    check(card_tier.COLUMNS["columns_fetched"] == fetched + 1, "phase5: the lazy columns did not fetch exactly once")
    check(np.array_equal(lazy_h, want_h) and np.array_equal(lazy_d, want_d),
          "phase5: the lazy columns differ from the host decoder's")
    del lazy_h, lazy_d

    # The same stream read onto the card again, and the kernels held to it.
    again = card_tier.read_segment_card(index.data_dir, seg.info, dev)
    fb = again.file_bytes
    data, starts = fb.data, fb.starts
    nbytes = data.shape[0]
    h, d = varint.decode_columns(data, n, True)
    equals_host("decode_columns", h, d)
    del h, d
    inter2 = torch.empty(2 * cap, dtype=torch.int32, device=dev)
    top2 = torch.empty(cap // BLOCK, dtype=torch.int32, device=dev)
    varint.decode(data, starts, n, True, inter2, inter2[BLOCK:], 2 * BLOCK, cap, top2)
    check(torch.equal(inter2, inter) and torch.equal(top2, top),
          "phase5: decode into an interleaved tier differs from the served tier")
    del inter2, top2
    k = min(VARINT_PLAIN_PAIRS, n)
    prefix = data[: min(nbytes, 10 * k)].cpu().numpy()  # a pair takes at most 10 bytes
    cut = int(np.flatnonzero(prefix < 0x80)[2 * k - 1]) + 1
    t0 = time.perf_counter()
    ph, pd = varint.decode_columns(torch.from_numpy(prefix[:cut].copy()), k, True)
    plain_s = time.perf_counter() - t0
    kh, kd = varint.decode_columns(data[:cut], k, True)
    for got, plain, want in ((kh, ph, want_h), (kd, pd, want_d)):
        check(np.array_equal(got.cpu().numpy(), plain.numpy()) and np.array_equal(plain.numpy().view(np.uint32), want[:k]),
              f"phase5: the kernels, the plain version and the host decoder differ on the stream's first {k} pairs")
    del ph, pd, kh, kd, prefix, want_h, want_d
    out["plain"] = {"pairs": k, "bytes": cut, "ms": plain_s * 1e3}
    log5(f"varint: the served tier, its top index and the lazy columns ({out['lazy_fetch_s']:.2f} s to copy back) "
         f"equal the host decoder's {n} postings ({out['host_read_s']:.1f} s to read); decode_columns and decode into "
         f"an interleaved tier, on the stream read again, equal them; the kernels equal the plain version on the first "
         f"{k} pairs ({plain_s:.2f} s on the host)")

    # Device time of each kernel at the restart's launches (a scan of the
    # stream, a decode into the interleaved tier), each launched alone
    # between two CUDA events, in the wrappers' order, VARINT_ROUNDS times;
    # and the yardstick.
    nchunks, ntiles = -(-nbytes // varint.CHUNK), -(-n // varint.TILE)
    inter2 = torch.empty(2 * cap, dtype=torch.int32, device=dev)
    top2 = torch.empty(cap // BLOCK, dtype=torch.int32, device=dev)
    counts = torch.empty(nchunks, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(6 * ntiles, dtype=torch.int32, device=dev)
    hp, dp, stride = inter2.data_ptr(), inter2[BLOCK:].data_ptr(), 2 * BLOCK
    lib = varint._lib()
    stream = torch.cuda.current_stream(dev)
    launch = {
        "count": lambda: lib.aitpu_varint_count(data.data_ptr(), nbytes, counts.data_ptr(), bad.data_ptr(),
                                                stream.cuda_stream),
        "decode": lambda: lib.aitpu_varint_decode(data.data_ptr(), nbytes, starts.data_ptr(), 1, hp, dp, stride, 2 * n,
                                                  stream.cuda_stream),
        "sums": lambda: lib.aitpu_varint_sums(hp, dp, stride, n, 1, scratch.data_ptr(), stream.cuda_stream),
        "carries": lambda: lib.aitpu_varint_carries(n, scratch.data_ptr(), stream.cuda_stream),
        "apply": lambda: lib.aitpu_varint_apply(hp, dp, stride, n, cap, 1, scratch.data_ptr(), top2.data_ptr(),
                                                stream.cuda_stream),
    }
    cols = torch.zeros(2, n, dtype=torch.int32, device=dev)

    def cumsums():
        torch.cumsum(cols[0], 0, dtype=torch.int32)
        torch.cumsum(cols[1], 0, dtype=torch.int32)

    def event_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        rc = fn()
        b.record(stream)
        b.synchronize()
        check(not rc, f"phase5: a varint launch returned cudaError {rc}")
        return a.elapsed_time(b)

    kernel_ms = {name: [] for name in VARINT_KERNELS}
    lib_ms = []
    with torch.cuda.device(dev):
        for _ in range(VARINT_ROUNDS):
            for name in VARINT_KERNELS:
                kernel_ms[name].append(event_ms(launch[name]))
            lib_ms.append(event_ms(cumsums))
        check(torch.equal(inter2, inter) and torch.equal(top2, top),
              "phase5: the kernels launched one by one differ from the served tier")
    del inter2, top2, counts, bad, scratch, cols, data, starts, fb, again
    needed = {
        "count": nbytes + 4 * nchunks,
        "decode": nbytes + 8 * nchunks + 8 * n,
        "sums": 8 * n + 12 * ntiles,
        "carries": 24 * ntiles,
        "apply": 8 * n + 12 * ntiles + 8 * cap + 4 * (cap // BLOCK),
    }
    out["kernels"] = {
        name: {"ms": sorted(ms)[VARINT_ROUNDS // 2], "ms_all": ms, "needed_bytes": needed[name],
               "bound_ms": needed[name] / HBM_BYTES_PER_S * 1e3}
        for name, ms in kernel_ms.items()
    }
    # The yardstick of sums, carries and apply: torch.cumsum of both
    # columns (unsegmented), median of its rounds.
    out["scans_library_ms"] = sorted(lib_ms)[VARINT_ROUNDS // 2]
    out["shape"] = {"postings": n, "stream_bytes": nbytes, "cap": cap, "chunks": nchunks, "tiles": ntiles}
    log5(f"varint: device ms per kernel {json.dumps({k: round(v['ms'], 3) for k, v in out['kernels'].items()})} "
         f"against byte bounds {json.dumps({k: round(v['bound_ms'], 3) for k, v in out['kernels'].items()})}; "
         f"torch.cumsum of both columns {out['scans_library_ms']:.3f} ms")
    return out


def phase5_front_door(dev, native_built):
    """The 134M corpus through the front door: bench_100m.load_through_server
    bulk-loads it over HTTP _bulk into the CLI's server, whose maintenance
    thread checkpoints it on the card as one file segment, then restarts the
    server on its directory.  With the launch counters at 0: two batches of
    256 and the boundary batch through both fronts (every answer equal to
    the analytic oracle, every native body byte-equal to the Python one),
    then the write mix over the served 2^30 postings.  K1 and K2 must have
    launched, the scans never, with at most 2 host syncs per batch; the
    card's memory comes back within 64 MiB.  Returns the figures."""
    import gc

    import numpy as np
    import torch

    from acoustid_index_tpu_torch import bench_100m
    from acoustid_index_tpu_torch import main as cli
    from acoustid_index_tpu_torch.engine import card_tier
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.ops import search_kernel as sk
    from acoustid_index_tpu_torch.ops import varint
    from oracle import oracle_search

    t_phase = time.perf_counter()
    native_built()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()  # earlier phases' pinned host blocks
    base = torch.cuda.memory_allocated(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_door_")
    served = None
    try:
        for k in varint.LAUNCHES:
            varint.LAUNCHES[k] = 0
        opened = {**card_tier.OPEN, **card_tier.COLUMNS}
        served, fig = bench_100m.load_through_server(dev, tmp, log=lambda msg: log(f"phase5: {msg}"))
        check(fig["file_tier_entries"] == 2**31, f"phase5: the restarted file tier holds {fig['file_tier_entries']} entries")
        # The restart read its one segment onto the card and built the tier
        # there: each kernel twice (the postings, the mentioned docs).
        fig["restart_launches"] = dict(varint.LAUNCHES)
        fig["restart_counters"] = {k: {**card_tier.OPEN, **card_tier.COLUMNS}[k] - v for k, v in opened.items()}
        check(fig["restart_launches"] == dict.fromkeys(VARINT_KERNELS, 2),
              f"phase5: the restart's varint launches {fig['restart_launches']}, not two of each kernel")
        check(fig["restart_counters"] == {"card_segments": 1, "host_segments": 0, "columns_fetched": 0},
              f"phase5: the restart's counters {fig['restart_counters']}")
        log(f"phase5: the restart's varint launches {fig['restart_launches']}, counters {fig['restart_counters']}")
        fig["varint"] = varint_at_scale(served, dev, lambda msg: log(f"phase5: {msg}"))
        corpus = bench_100m.OracleCorpus()

        def oracle(q):
            return oracle_search([corpus], q, limit=bench_100m.LIMIT, min_score=bench_100m.MIN_SCORE, pct=bench_100m.PCT)

        rng = np.random.default_rng(13)
        batches = [bench_100m.make_queries(rng) for _ in range(2)] + [bench_100m.boundary_queries(rng)]

        # ---- the main path: counters from zero, reads on both fronts, then writes ----
        for k in bl.LAUNCHES:
            bl.LAUNCHES[k] = 0
        for k in varint.LAUNCHES:
            varint.LAUNCHES[k] = 0
        stats0 = dict(sk.STATS)
        fig["serve"] = bench_100m.serve_fronts(served, batches, oracle, lambda msg: log(f"phase5: {msg}"))
        targets, qs, lens = batches[0]
        queries = [qs[b, : lens[b]].tolist() for b in range(qs.shape[0])]
        _, fig["writes"], _ = write_mix(f"http://127.0.0.1:{served[0].port}", bench_100m.N_DOCS, targets, queries, rng,
                                        corpus, "phase5")
        fig["launches"] = dict(bl.LAUNCHES)
        fig["branches"] = {k: sk.STATS[k] - stats0[k] for k in sk.STATS}
        n_batches = sum(fig["branches"][k] for k in ("direct", "matrix", "sort"))
        check_launches(fig["launches"], "phase5")
        check(not any(varint.LAUNCHES.values()), f"phase5: the served path launched varint kernels {dict(varint.LAUNCHES)}")
        check(fig["branches"]["host_syncs"] <= 2 * n_batches,
              f"phase5: {fig['branches']['host_syncs']} host syncs in {n_batches} batches")
        log(f"phase5: launches on the front-door path {fig['launches']}; batches/branches/host syncs {fig['branches']}")
    finally:
        if served is not None:
            cli.stop_server(*served)
        shutil.rmtree(tmp, ignore_errors=True)
    del served
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) - base
    check(left <= 64 * 2**20, f"phase5: {left / 2**20:.1f} MiB of the front-door phase still allocated after it")
    fig["allocated_after_mib"] = left / 2**20
    fig["phase_s"] = time.perf_counter() - t_phase
    log(f"phase5: the server stopped and its tiers freed ({left / 2**20:.1f} MiB above the level before the phase); "
        f"done in {fig['phase_s']:.1f} s")
    return fig


# ---------------------------------------------------------------- main


def start_native_builds():
    """Start g++ on every host source (codecs, native front, load
    generator) at once, in the background; returns a function that waits
    for them and fails the run if one did not build."""
    from concurrent.futures import ThreadPoolExecutor

    from acoustid_index_tpu_torch.utils import native

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(3)
    jobs = {src: pool.submit(native.build, src, kind)
            for src, kind in (("aitpu_front.cc", "so"), ("aitpu_loadgen.cc", "exe"), ("aitpu_native.cc", "so"))}
    pool.shutdown(wait=False)

    def wait():
        for src, job in jobs.items():
            try:
                job.result()
            except Exception as exc:  # noqa: BLE001 -- fatal, reported
                fail(f"{src} did not build: {exc}")
        log(f"phase2: host libraries built (g++ started {time.perf_counter() - t0:.1f} s ago)")

    return wait


def start_kernel_builds():
    """Start nvcc on every kernel library the run needs, one process each,
    all at once, in the background (ops/_build.py: a caller of a library
    waits for its build)."""
    from acoustid_index_tpu_torch.ops import _build

    for name in ("kernels", "probes", "designs"):
        threading.Thread(target=_build.library, args=(name,), daemon=True).start()


def kernel_entry(name, variant, replaces, also, records, main_shape, launches,
                 source="acoustid_index_tpu_torch/csrc/block_lookup.cu", design=None):
    """One kernel's entry of the final `kernels` line: `variant` ("new" or
    "scan") of the phase-1 records of one kernel contract.  The top-level
    times are those at `main_shape`, the shape of its heaviest main-path
    call, cold (fresh input sets, as the main path finds them); "shapes"
    holds every shape it ran at, with its warm time beside.  Where the
    records time designs the kernel did not take (K3, K4: measure.EMIT_DESIGNS),
    "designs" holds their cold and warm times from the same turns, and
    "read_bytes" what each design reads."""
    from acoustid_index_tpu_torch import measure as m

    def summary(r):
        v = r["variants"][variant]
        lib = r["variants"].get("searchsorted")
        out = {"L": r["L"], "timed": r["timed"], "ms": v["median_ms"], "ms_min": v["min_ms"], "ms_max": v["max_ms"],
               "ms_warm": v.get("warm", v)["median_ms"],
               "plain_ms": r["plain_ms"], "library_ms": lib["median_ms"] if lib else None,
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "needed_bytes": r["needed_bytes"],
               "scan_bytes": r["scan_bytes"], "scan_bound_ms": r["scan_bound_ms"]}
        designs = {k: {"ms": d["median_ms"], "ms_warm": d.get("warm", d)["median_ms"]}
                   for k, d in r["variants"].items() if k in m.EMIT_DESIGNS}
        if designs:
            out["designs"] = designs
        if "read_bytes" in r:
            out["read_bytes"] = r["read_bytes"]
        return out

    shapes = {f"{r['shape']}-stride{r['stride']}": summary(r) for r in records}
    top = shapes[main_shape]
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "also_replaces": also,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records), "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "lookups": top["L"], "main_shape": main_shape, "shapes": shapes,
    }
    if design:
        entry["design"] = design
        entry["designs_not_taken"] = top["designs"]
    return entry


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "acoustid_index_tpu_torch")):
        print("FAIL: run chip_smoke.py from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is unavailable: chip_smoke.py needs a card", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    from acoustid_index_tpu_torch.measure import HASHES_PER_DOC, N_DOCS, kernel_design, sorted_corpus
    from acoustid_index_tpu_torch.utils.device import device

    dev = device()
    check(dev.type == "cuda", f"the port's device is {dev}, not the card")
    smi = nvidia_smi_line()
    log(f"phase0: nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    native_built = start_native_builds()
    start_kernel_builds()

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"{name}: {phase_s[name]:.1f} s")
        return out

    kern = timed("phase1", phase1_kernels, dev)
    merge = timed("phase1b", phase1b_merge, dev)
    probe_launches, probe_kern = timed("phase1c", phase1c_probes, dev)
    kern += probe_kern
    scale_launches, scale_kern, scale, held = timed("phase1d", phase1d_scale, dev)
    kern += scale_kern
    mesh134_launches, mesh134 = timed("phase1e", phase1e_mesh_134m, held, scale)
    del held
    log(f"phase2: docs={N_DOCS} ({N_DOCS * HASHES_PER_DOC} postings; the reference bench scale, no cut)")
    t0 = time.perf_counter()
    base_seg = BaseSegment(*sorted_corpus(N_DOCS, dev), N_DOCS)
    oracle_sort_s = time.perf_counter() - t0
    serving, handoff = timed("phase2", phase2_serving, N_DOCS, N_REQUESTS, native_built, base_seg)
    serving["oracle_sort_s"] = oracle_sort_s
    mesh = timed("phase2c", phase2c_mesh, handoff, N_DOCS, native_built, base_seg)
    del handoff
    replica = timed("phase2d", phase2d_replicas, dev, REPLICA_DOCS, REPLICA_ENTRY_DOCS, N_REQUESTS)
    model = timed("phase2b", phase2b_model, dev, N_DOCS, base_seg)
    del base_seg
    paths = (("Python HTTP", serving["launches"]), ("native front", serving["native"]["launches"]),
             ("mesh serving", mesh["launches"]), ("model forward", model["launches"]), ("134M scale", scale_launches),
             ("134M over 4 shards", mesh134_launches))
    for path, launches in paths:
        check(launches["block_count"] > 0, f"K1 block_count never launched on the {path} path")
        check(launches["block_count_emit"] > 0, f"K2 block_count_emit never launched on the {path} path")
        for scan in ("block_count_scan", "block_count_emit_scan"):
            check(launches[scan] == 0, f"{scan} launched {launches[scan]} times on the {path} path")
    cli_stats = timed("phase3", phase3_cli)
    bench_launches, bench_detail = timed("phase4", phase4_bench)
    front_door = timed("phase5", phase5_front_door, dev, native_built)
    check("jax" not in sys.modules, "jax was imported")
    ref_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("acoustid_index_tpu", "probes"))
    check(not ref_mods, f"modules of the JAX package or of probes/ were imported: {ref_mods}")

    total = time.perf_counter() - t_start
    detail = {"phase1": kern, "phase1b": merge, "phase1c_launches": probe_launches, "phase1d": scale, "phase1e": mesh134,
              "phase2": serving, "phase2c": mesh,
              "phase2d": replica, "phase2b": model, "phase3": cli_stats, "phase4": bench_detail, "phase5": front_door,
              "phase_s": phase_s,
              "total_s": total, "nvidia_smi": smi}
    print(f"detail: {json.dumps(detail, default=str)}", file=sys.stderr, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, default=str)
    log(f"total {total:.1f} s")

    def launches(name):
        return {"python_http": serving["launches"][name], "native_front": serving["native"]["launches"][name],
                "mesh_serving": mesh["launches"][name],
                "replica": replica["A"]["launches"][name] + replica["B"]["launches"][name],
                "model_forward": model["launches"][name],
                "probes": probe_launches[name], "scale_134m": scale_launches[name],
                "scale_134m_mesh4": mesh134_launches[name], "bench": bench_launches[name],
                "front_door_134m": front_door["launches"][name]}

    def of(kernel):
        return [r for r in kern if r["kernel"] == kernel]

    k1_also = ["acoustid_index_tpu/ops/pallas_lookup.py:172", "acoustid_index_tpu/ops/pallas_lookup.py:484"]
    k1_probes = ["probes/_probe_kernelvariants.py:78", "probes/_probe_kernelvariants.py:131", "probes/_probe_fused.py:66",
                 "probes/_probe_fused2.py:98"]  # the last at E = 0, "plain" and "rm"
    k2_also = ["acoustid_index_tpu/ops/pallas_lookup.py:86"]
    probe_cu = "acoustid_index_tpu_torch/csrc/probe_lookup.cu"
    design = "{} (csrc/sector_search.cuh)".format
    kernels = [
        kernel_entry("block_count", "new", "acoustid_index_tpu/ops/pallas_lookup.py:256", k1_also + k1_probes,
                     of("block_count"), "a-stride1", launches("block_count")),
        # Masked mode has no caller on either path (nor in the JAX package):
        # its launches there are 0 by design; phase 1 checks it.
        kernel_entry("block_count_masked", "new", "acoustid_index_tpu/ops/pallas_lookup.py:496", [],
                     of("block_count_masked"), "d-stride1", launches("block_count_masked")),
        kernel_entry("block_count_emit", "new", "acoustid_index_tpu/ops/pallas_lookup.py:347",
                     k2_also + ["probes/_probe_fused3.py:79", "probes/_probe_dma2.py:321"],
                     of("block_count_emit"), "c-stride2", launches("block_count_emit")),
        # K1's and K2's first designs, timed beside them; no main-path caller
        # (K5's cases on the probes path time K1's scan beside it).
        kernel_entry("block_count_scan", "scan", "acoustid_index_tpu/ops/pallas_lookup.py:256", k1_also + k1_probes,
                     of("block_count"), "a-stride1", launches("block_count_scan")),
        kernel_entry("block_count_emit_scan", "scan", "acoustid_index_tpu/ops/pallas_lookup.py:347", k2_also,
                     of("block_count_emit"), "c-stride2", launches("block_count_emit_scan")),
        # K3-K5: the probes' kernels, launched on the probes path (phase 1c);
        # K3 and K4 name their design and carry the designs they did not
        # take (thread11, the first design; the other sector arities), timed in the
        # same turns.
        kernel_entry("block_count_pair", "new", "probes/_pairkernel.py:93",
                     ["probes/_probe_dma.py:73", "probes/_probe_smem.py:60", "probes/_probe_floor.py:63"],
                     of("block_count_pair"), "probe-window-stride1", launches("block_count_pair"), probe_cu,
                     design(kernel_design("block_count_pair"))),
        kernel_entry("block_count_emit_docids", "new", "probes/_probe_fused.py:115", ["probes/_probe_fused2.py:98"],
                     of("block_count_emit_docids"), "probe-E2-R1024-stride2", launches("block_count_emit_docids"), probe_cu,
                     design(kernel_design("block_count_emit_docids"))),
        kernel_entry("block_count_staged", "G8xNBUF4", "probes/_probe_dma2.py:79",
                     ["probes/_probe_dma2.py:149", "probes/_probe_dma2.py:215", "probes/_probe_ceiling.py:119",
                      "probes/_probe_wavemm.py:108"],
                     of("block_count_staged"), "probe-stride1", launches("block_count_staged"), probe_cu),
    ]
    # The restart's decode (csrc/varint_decode.cu): no TPU kernel; the
    # reference decodes the segment file on the host.  Timed and held to
    # the host decoder and the plain version in phase 5.
    vfig = front_door["varint"]
    for name in VARINT_KERNELS:
        k = vfig["kernels"][name]
        kernels.append({
            "name": f"varint_{name}", "route": "cuda", "source": "acoustid_index_tpu_torch/csrc/varint_decode.cu",
            "replaces": None, "replaces_host": "acoustid_index_tpu_torch/csrc/aitpu_native.cc:82",
            "also_replaces": [], "launches": front_door["restart_launches"][name],
            "launches_by_path": {"restart_134m": front_door["restart_launches"][name]},
            "max_abs_err": 0, "ms": k["ms"], "ms_all": k["ms_all"], "plain_ms": None,
            "plain_at": vfig["plain"], "bound_ms": k["bound_ms"], "bound_by": "hbm_bytes",
            "needed_bytes": k["needed_bytes"],
            "library_ms": None if name in ("count", "decode") else vfig["scans_library_ms"],
            "library": "none" if name in ("count", "decode") else "torch.cumsum of both columns, for sums+carries+apply",
            "main_shape": "restart-134m-interleaved", "shape": vfig["shape"],
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

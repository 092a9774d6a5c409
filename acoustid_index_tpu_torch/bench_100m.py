"""The 134M-fingerprint scale point on one card (counterpart of the root
bench_100m.py).

    python -m acoustid_index_tpu_torch.bench_100m [--out FILE]

The corpus is the reference bench's, computed from its definition: 2^27
docs of 8 hashes, one per band of 2^29 hash values, so 2^30 postings and an
interleaved tier of 2^31 int32 entries (8 GiB).  Within band j the sorted
position p holds doc bitrev27(p) + 1 under hash j * 2^29 + f(p, j), f
monotone in p (_f_np), so the table is sorted by construction: pair runs
share a hash between neighbouring docs, and hot runs of 64 docs share one
every 2^21 positions.

  * build_tier computes the tier on the card as a pure function of the
    flat index (inter_chunk), in chunks of CHUNK entries, so the build's
    peak stays near its 8 GiB output; any window [p0, p1) of positions of
    every band gives a tier of the same layout (the CPU tests' sub-tier);
  * oracle_postings answers, for any query hashes, the (hash, docid)
    postings of the corpus analytically: a bisection over the monotone f.
    tests/oracle.py's oracle_search over one OracleSegment of those pairs
    gives exactly its answer over the whole corpus, with no host copy of
    the table;
  * run drives the port's search program over the tier as measure.py does
    (Searcher._launch / _fetch), with the reference bench's SearchParams
    (query_len 64, postings budget 512, candidate cap 256; limit 10,
    min_score 2, pct 10) and its queries (6 of a target doc's 8 hashes and
    4 random ones): two checked batches of 256 (self-retrieval 1.0 at score
    6, as the reference asserts, and every answer equal to the oracle when
    one is given), a boundary batch (targets at the last 1,024 positions,
    queried by their hashes of bands 2-7, the tier's last hashes up to
    0xFFFFFFFC, plus the hashes 0xFFFFFFFC-0xFFFFFFFF), ROUNDS timed
    batches (host clock per batch; CUDA events on the searcher's stream
    around each, the card's span from the batch's first work to its last,
    waits for the host included),
    PIPELINED batches with up to IN_FLIGHT launched ahead (searches per
    second), kernel launches, branches and host syncs per batch, the card's
    busy share under torch.profiler over PROFILED batches, and last
    SUBMIT_QUERIES queries through BatchingSearcher.submit from THREADS
    threads, each checked as above.

The module's command writes chiprun_out/bench_100m.json and prints it as
its last line.  It checks self-retrieval only: the oracle lives in the
repository's tests/, which the package does not import; chip_smoke.py
phase 1d and tests/test_torch_scale.py pass it in.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

DOC_BITS = 27
N_DOCS = 1 << DOC_BITS  # 134,217,728
HASHES_PER_DOC = 8  # 8 bands of 2^29 hash space
BAND = 1 << 29
BATCH = 256
QUERY_LEN = 64
TARGET_HASHES, NOISE_HASHES = 6, 4
LIMIT, MIN_SCORE, PCT = 10, 2, 10
BOUNDARY = 1024  # the boundary batch's targets: the last BOUNDARY positions
BOUNDARY_NOISE = (0xFFFFFFFC, 0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF)
CHUNK = 1 << 24  # inter entries per build step (int64 intermediates of 128 MiB)
ROUNDS, PIPELINED, IN_FLIGHT, PROFILED = 100, 100, 4, 5
SUBMIT_QUERIES, THREADS = 512, 32
# Through the server: docs per _bulk body (16,200,018 bytes of msgpack, under
# server/http.py's 16 MiB body cap), bulk clients (well under its listen
# backlog of 128), and the host RAM the load needs per posting.
BODY_DOCS, LOAD_THREADS = 450_000, 4
CHECKPOINT_WAIT_S = 1800  # the load's checkpoint must land within this after its last body
HOST_BYTES_PER_POSTING = 72  # the load's measured peak was 64.8 GiB at 2^30 postings


# ---- the corpus: bench_100m.py's functions, copied (tests/test_torch_scale.py
# holds them equal to the originals) ----


_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint32)


def np_bitrev27(x: np.ndarray) -> np.ndarray:
    """The low 27 bits of x reversed: bench_100m.py's bit loop, as four
    byte-table lookups of a 32-bit reversal shifted down by 5."""
    v = np.asarray(x).astype(np.uint64).astype(np.uint32)
    r = _REV8[v & 0xFF] << 24 | _REV8[(v >> 8) & 0xFF] << 16 | _REV8[(v >> 16) & 0xFF] << 8 | _REV8[v >> 24]
    return r >> np.uint32(32 - DOC_BITS)


def _f_np(p: np.ndarray, j: int) -> np.ndarray:
    """Band-j in-band hash offset for sorted position p (monotone
    nondecreasing in p, so the table stays sorted by construction):
      * hot: every 2^21 positions (band-offset), a 64-position run collapses
        to one hash;
      * pair: positions with (p + j) % 8 == 7 share the previous position's
        hash (a 2-doc run; exactly one band pairs any given p, so two docs
        never share more than one pair hash)."""
    p = p.astype(np.uint64)
    hot = ((p >> 6) + j) % (1 << 15) == 0
    pair = np.logical_and((p + j) % 8 == 7, p > 0)
    f = np.where(hot, (p & ~np.uint64(63)) * 4, np.where(pair, (p - 1) * 4, p * 4))
    return f


def doc_hashes_np(doc_ids: np.ndarray) -> np.ndarray:
    """The 8 hashes of each doc (doc ids are 1-based)."""
    return position_hashes(np_bitrev27(doc_ids - 1))


def position_hashes(p: np.ndarray) -> np.ndarray:
    """The 8 hashes of the doc at each sorted position p (its doc id is
    bitrev27(p) + 1)."""
    out = np.empty((p.shape[0], HASHES_PER_DOC), np.uint32)
    for j in range(HASHES_PER_DOC):
        out[:, j] = (np.uint64(j) * BAND + _f_np(p, j)).astype(np.uint32)
    return out


# ---- the tier, built on the card ----


def _bitrev27(v):
    """np_bitrev27 over an int64 tensor."""
    r = v.new_zeros(v.shape)
    for b in range(DOC_BITS):
        r |= ((v >> b) & 1) << (DOC_BITS - 1 - b)
    return r


def _hash_at(k, p0: int, width: int):
    """Hash (int64) of flat posting k of the tier of positions [p0, p0 +
    width) of every band, band-major: band j = k // width."""
    import torch

    j = torch.div(k, width, rounding_mode="floor")
    p = p0 + k - j * width
    hot = ((p >> 6) + j) % (1 << 15) == 0
    pair = ((p + j) % 8 == 7) & (p > 0)
    f = torch.where(hot, (p & ~63) * 4, torch.where(pair, (p - 1) * 4, p * 4))
    return j * BAND + f, p


def inter_chunk(i, p0: int = 0, p1: int = N_DOCS):
    """inter's values (int64 u32 values) at flat entries i (int64 tensor) of
    the tier of positions [p0, p1): bench_100m.py's make_tiers, entry by
    entry.  Entry i lies in block i >> 11; its low 11 bits pick the block's
    hash half (< 1024) or its docid half, of posting blk * 1024 + (i & 1023)."""
    import torch

    from .ops.layout import BLOCK

    w = i & (2 * BLOCK - 1)
    k = ((i >> 11) << 10) + (w & (BLOCK - 1))
    h, p = _hash_at(k, p0, p1 - p0)
    return torch.where(w < BLOCK, h, _bitrev27(p) + 1)


def build_tier(dev, p0: int = 0, p1: int = N_DOCS):
    """The corpus's positions [p0, p1) of every band as one packed file
    tier on `dev` beside an empty memory tier: a Snapshot that the port's
    Searcher serves.  The file view holds the fields tier_view_for_search
    passes (inter, block_index, seg_start, seg_len) in the layout
    engine/segments.pack_tier gives for the same postings, every posting
    live (no padding: 8 * (p1 - p0) is a multiple of BLOCK); the memory
    view is pack_tier's empty tier.  inter is filled CHUNK entries at a
    time."""
    import torch

    from .engine.segments import _VIEW_TOKENS, MEMORY_SLOTS, Snapshot, pack_tier
    from .ops.layout import BLOCK, to_storage

    width = p1 - p0
    n_postings = HASHES_PER_DOC * width
    if not (0 <= p0 < p1 <= N_DOCS) or n_postings % BLOCK:
        raise ValueError(f"window [{p0}, {p1}) must lie in [0, {N_DOCS}) and hold a multiple of {BLOCK} postings")
    inter = torch.empty(2 * n_postings, dtype=torch.int32, device=dev)
    for s in range(0, inter.shape[0], CHUNK):
        i = torch.arange(s, min(s + CHUNK, inter.shape[0]), dtype=torch.int64, device=dev)
        inter[s : s + i.shape[0]] = to_storage(inter_chunk(i, p0, p1))
        del i
    k = torch.arange(0, n_postings, BLOCK, dtype=torch.int64, device=dev)
    file_view = {
        "inter": inter,
        "block_index": to_storage(_hash_at(k, p0, width)[0]),
        "seg_start": torch.zeros(1, dtype=torch.int32, device=dev),
        "seg_len": torch.full((1,), n_postings, dtype=torch.int32, device=dev),
        "view_token": next(_VIEW_TOKENS),
    }
    return Snapshot(file_view=file_view, mem_view=pack_tier([], MEMORY_SLOTS, device=dev))


# ---- the analytic oracle ----


def _first_position(target, j, p0: int, p1: int):
    """Per element, the first p in [p0, p1) with _f_np(p, j) >= target (p1
    if none): a vectorized bisection over the monotone f."""
    lo = np.full(target.shape, p0, np.int64)
    count = np.full(target.shape, p1 - p0, np.int64)
    while count.any():
        step = count // 2
        mid = lo + step
        go = (count > 0) & (_f_np(mid.astype(np.uint64), j) < target)
        lo = np.where(go, mid + 1, lo)
        count = np.where(go, count - step - 1, step)
    return lo


def oracle_postings(query_hashes, p0: int = 0, p1: int = N_DOCS):
    """The (hash, docid) postings of the tier of positions [p0, p1) under
    the query's hashes, from the corpus's definition alone: hash h lives in
    band h >> 29 at the positions whose in-band offset is h & (BAND - 1)."""
    h = np.unique(np.asarray(query_hashes, dtype=np.uint64))
    j = h >> np.uint64(29)
    off = h & np.uint64(BAND - 1)
    lo = _first_position(off, j, p0, p1)
    hi = _first_position(off + np.uint64(1), j, p0, p1)
    return [(int(hh), int(d) + 1) for hh, a, b in zip(h, lo, hi) for d in np_bitrev27(np.arange(a, b))]


def _f(p: int, j: int) -> int:
    """_f_np at one position."""
    if ((p >> 6) + j) % (1 << 15) == 0:
        return (p & ~63) * 4
    if (p + j) % 8 == 7 and p > 0:
        return (p - 1) * 4
    return p * 4


class OracleCorpus:
    """The positions [p0, p1) of the corpus as one segment of
    tests/oracle.py's oracle_search (duck-typed: postings(h), and `docs`
    with membership), every doc alive: oracle_postings one hash at a time,
    in scalar arithmetic (a query's noise hashes cost microseconds: every
    hash of the corpus has an in-band offset divisible by 4)."""

    def __init__(self, p0: int = 0, p1: int = N_DOCS):
        self.p0, self.p1, self.docs = p0, p1, self

    def __contains__(self, docid) -> bool:
        return 1 <= docid <= N_DOCS and self.p0 <= int(np_bitrev27(np.asarray([docid - 1]))[0]) < self.p1

    def _first(self, target: int, j: int) -> int:
        lo, count = self.p0, self.p1 - self.p0
        while count > 0:
            step = count // 2
            if _f(lo + step, j) < target:
                lo, count = lo + step + 1, count - step - 1
            else:
                count = step
        return lo

    def postings(self, h):
        j, off = h >> 29, h & (BAND - 1)
        if off % 4:
            return []
        lo, hi = self._first(off, j), self._first(off + 1, j)
        return (np_bitrev27(np.arange(lo, hi)) + np.uint32(1)).tolist() if hi > lo else []


# ---- queries and checks ----


def _queries(hashes):
    """(qs (B, QUERY_LEN) u32, lens (B,) int32): each row of `hashes`,
    unique and sorted."""
    qs = np.zeros((hashes.shape[0], QUERY_LEN), np.uint32)
    lens = np.zeros(hashes.shape[0], np.int32)
    for b, row in enumerate(hashes):
        q = np.unique(row)
        qs[b, : q.shape[0]] = q
        lens[b] = q.shape[0]
    return qs, lens


def make_queries(rng, batch: int = BATCH, p0: int = 0, p1: int = N_DOCS):
    """The reference bench's batch: targets uniform over the docs of
    positions [p0, p1), each queried by 6 of its 8 hashes (bands 0-5) and 4
    random ones.  Returns (targets, qs, lens)."""
    targets = np_bitrev27(rng.integers(p0, p1, batch)) + np.uint32(1)
    noise = rng.integers(0, 2**32, (batch, NOISE_HASHES), dtype=np.uint32)
    return (targets, *_queries(np.concatenate([doc_hashes_np(targets)[:, :TARGET_HASHES], noise], 1)))


def boundary_queries(rng, batch: int = BATCH, p1: int = N_DOCS):
    """Targets at the last BOUNDARY positions below p1 (the last one among
    them), queried by their hashes of bands 2-7 -- band 7's reach
    0xFFFFFFFC at the last position, the top index's and the tier's last
    hashes -- and the hashes BOUNDARY_NOISE.  Returns (targets, qs, lens)."""
    p = p1 - 1 - rng.integers(0, BOUNDARY, batch)
    p[0] = p1 - 1
    targets = np_bitrev27(p) + np.uint32(1)
    noise = np.broadcast_to(np.asarray(BOUNDARY_NOISE, np.uint32), (batch, len(BOUNDARY_NOISE)))
    return (targets, *_queries(np.concatenate([doc_hashes_np(targets)[:, HASHES_PER_DOC - TARGET_HASHES :], noise], 1)))


def params():
    """The reference bench's program: SearchParams(query_len=64,
    postings_budget=512, candidate_cap=256)."""
    from .ops.search_kernel import SearchParams

    return SearchParams(query_len=QUERY_LEN, postings_budget=512, candidate_cap=256)


def pack(qs, lens) -> np.ndarray:
    """The batch as the program's packed input (limit, min_score, pct of the
    reference bench)."""
    from .ops.search_kernel import pack_inputs_np

    b = qs.shape[0]
    return pack_inputs_np(qs, lens, *(np.full(b, v, np.int32) for v in (LIMIT, MIN_SCORE, PCT)))


def check_answers(label: str, targets, qs, lens, ids, scores, counts, oracle=None) -> None:
    """Self-retrieval (every target first, at score 6) and, with `oracle`
    (query hashes -> [(id, score)] at limit 10, min_score 2, pct 10), every
    answer equal to it; raises AssertionError on the first difference."""
    hit = float(np.mean(ids[:, 0] == targets))
    if hit != 1.0 or not np.all(scores[:, 0] == TARGET_HASHES):
        raise AssertionError(f"{label}: self-retrieval hit rate {hit}, top scores {scores[:5, 0].tolist()}")
    for b in range(0 if oracle is None else qs.shape[0]):
        n = int(counts[b])
        got = list(zip(ids[b, :n].tolist(), scores[b, :n].tolist()))
        want = oracle(qs[b, : lens[b]].tolist())
        if got != want:
            raise AssertionError(f"{label}: query {b} answered {got[:3]}, the oracle {want[:3]}")


# ---- the run ----


def build_timed(dev, log=print):
    """build_tier(dev) with its wall time and the card's peak allocation
    during the build (both in the returned figures)."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    snap = build_tier(dev)
    torch.cuda.synchronize(dev)
    fig = {
        "build_s": time.perf_counter() - t0,
        "peak_allocated_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2**30,
        "tier_allocated_gib": (torch.cuda.memory_allocated(dev) - base) / 2**30,
        "inter_entries": int(snap.file_view["inter"].shape[0]),
    }
    log(f"bench_100m: built the {N_DOCS}-doc tier ({fig['inter_entries']} inter entries, "
        f"{fig['tier_allocated_gib']:.3f} GiB) in {fig['build_s']:.2f} s, peak {fig['peak_allocated_gib']:.3f} GiB")
    return snap, fig


def run(dev, snap, oracle=None, log=print) -> dict:
    """The search program over the 134M tier `snap` (build_tier), checked
    and timed as the module docstring says; returns the figures.  Raises
    on any check that fails."""
    import torch

    from .engine.model import SearchOptions
    from .engine.searcher import BatchingSearcher, Searcher
    from .measure import _device_ms, smi
    from .ops import block_lookup as bl
    from .ops import search_kernel as sk

    p = params()
    rep = {"nvidia_smi": smi("name,power.limit"), "device": torch.cuda.get_device_name(dev), "docs": N_DOCS,
           "postings": N_DOCS * HASHES_PER_DOC, "batch": BATCH, "params": vars(p)}
    searcher = Searcher(dev)
    rng = np.random.default_rng(11)

    def search(packed):
        out = searcher._fetch(searcher._launch(snap, p, packed))
        return sk.unpack_outputs_np(out, p.out_len)

    def checked(label, batch):
        targets, qs, lens = batch
        out = search(pack(qs, lens))
        check_answers(label, targets, qs, lens, out["ids"], out["scores"], out["count"], oracle)

    t0 = time.perf_counter()
    checked("batch 1", make_queries(rng))
    rep["first_batch_s"] = time.perf_counter() - t0
    checked("batch 2", make_queries(rng))
    checked("boundary batch", boundary_queries(rng))
    rep["checked"] = {"launched": 2 * BATCH, "boundary": BATCH, "oracle": oracle is not None}
    log(f"bench_100m: 2 batches of {BATCH} and the boundary batch: self-retrieval 1.0 at score {TARGET_HASHES}"
        + (", every answer equal to the oracle" if oracle else "") + f" (first batch {rep['first_batch_s']:.2f} s)")

    packs = [pack(*make_queries(rng)[1:]) for _ in range(ROUNDS)]
    stats0, launches0 = dict(sk.STATS), dict(bl.LAUNCHES)
    wall, marks = [], []
    for packed in packs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record(searcher._stream)
        handle = searcher._launch(snap, p, packed)
        end.record(searcher._stream)
        searcher._fetch(handle)
        wall.append((time.perf_counter() - t0) * 1e3)
        marks.append((start, end))
    torch.cuda.synchronize(dev)
    card = [a.elapsed_time(b) for a, b in marks]
    rep["timed"] = {
        "batches": ROUNDS,
        "host_ms_p50": float(np.percentile(wall, 50)), "host_ms_p99": float(np.percentile(wall, 99)),
        "card_span_ms_p50": float(np.percentile(card, 50)), "card_span_ms_p99": float(np.percentile(card, 99)),
        "launches_per_batch": {k: (bl.LAUNCHES[k] - launches0[k]) / ROUNDS for k in ("block_count", "block_count_emit")},
        "host_syncs_per_batch": (sk.STATS["host_syncs"] - stats0["host_syncs"]) / ROUNDS,
        "branches": {k: sk.STATS[k] - stats0[k] for k in ("direct", "matrix", "sort")},
    }

    pending, t0 = [], time.perf_counter()
    for packed in packs[:PIPELINED]:
        pending.append(searcher._launch(snap, p, packed))
        if len(pending) >= IN_FLIGHT:
            searcher._fetch(pending.pop(0))
    for h in pending:
        searcher._fetch(h)
    rep["timed"]["searches_per_s"] = PIPELINED * BATCH / (time.perf_counter() - t0)
    log(f"bench_100m: {json.dumps(rep['timed'])}")

    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for packed in packs[:PROFILED]:
            search(packed)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    dev_ms = _device_ms(ev)
    rep["profile"] = {"batches": PROFILED, "wall_ms_per_batch": wall_ms / PROFILED,
                      "device_ms_per_batch": dev_ms / PROFILED, "busy_share": dev_ms / wall_ms,
                      "k1_ms_per_batch": _device_ms(ev, "block_count_kernel") / PROFILED,
                      "k2_ms_per_batch": _device_ms(ev, "block_count_emit_kernel") / PROFILED}
    log(f"bench_100m: profile {json.dumps(rep['profile'])}")

    # The serving layer: BatchingSearcher.submit from THREADS threads.
    batching = BatchingSearcher(device=dev)
    opts = SearchOptions(max_results=LIMIT, min_score=MIN_SCORE, min_score_pct=PCT)
    targets, qs, lens = make_queries(rng, SUBMIT_QUERIES)
    ids = np.zeros((SUBMIT_QUERIES, LIMIT), np.int64)
    scores, counts, lat = np.zeros_like(ids), np.zeros(SUBMIT_QUERIES, np.int64), np.zeros(SUBMIT_QUERIES)
    nxt, lock, errors = [0], threading.Lock(), []

    def worker():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= SUBMIT_QUERIES:
                return
            try:
                t = time.perf_counter()
                results, _stats = batching.submit(snap, qs[i, : lens[i]].tolist(), opts).result()
                lat[i] = time.perf_counter() - t
            except Exception as exc:  # noqa: BLE001 -- raised below
                errors.append(repr(exc))
                return
            counts[i] = len(results)
            ids[i, : len(results)] = [r.id for r in results]
            scores[i, : len(results)] = [r.score for r in results]

    try:
        ts = [threading.Thread(target=worker) for _ in range(THREADS)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        submit_s = time.perf_counter() - t0
    finally:
        batching.close()
    if errors:
        raise RuntimeError(f"BatchingSearcher.submit failed: {errors[:3]}")
    check_answers("submit", targets, qs, lens, ids, scores, counts, oracle)
    rep["submit"] = {"queries": SUBMIT_QUERIES, "threads": THREADS, "wall_s": submit_s, "searches_per_s": SUBMIT_QUERIES / submit_s,
                     "latency_ms_p50": float(np.percentile(lat, 50)) * 1e3, "latency_ms_p99": float(np.percentile(lat, 99)) * 1e3}
    rep["checked"]["submit"] = SUBMIT_QUERIES
    log(f"bench_100m: BatchingSearcher.submit: {json.dumps(rep['submit'])}; every answer checked")
    return rep


# ---- through the front door: the operator's bulk load, checkpoint and restart ----


def bulk_body(q0: int, q1: int) -> bytes:
    """The docs at positions [q0, q1) as one msgpack POST /:index/_bulk body
    (server/api.decode_bulk_request): ids and hashes as little-endian u32
    bin columns, fixed width 8."""
    import msgpack

    p = np.arange(q0, q1, dtype=np.int64)
    ids = np_bitrev27(p) + np.uint32(1)
    return msgpack.packb({"i": ids.astype("<u4").tobytes(), "h": position_hashes(p).astype("<u4").tobytes(),
                          "k": HASHES_PER_DOC})


def _meminfo_bytes(key: str) -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


class _RssPeak:
    """The largest resident set of this process, sampled every `period` s
    on a thread from start() to stop() (VmHWM cannot be reset everywhere)."""

    def __init__(self, period: float = 0.1):
        self.period, self.peak, self._stop = period, 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="rss-peak")

    @staticmethod
    def resident() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, self.resident())

    def start(self) -> "_RssPeak":
        self.peak = self.resident()
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return max(self.peak, self.resident())


def _dir_bytes(path: str) -> int:
    """Bytes of the files in `path` (a file deleted meanwhile counts 0)."""
    total = 0
    for f in os.listdir(path) if os.path.isdir(path) else ():
        try:
            total += os.path.getsize(os.path.join(path, f))
        except FileNotFoundError:
            pass
    return total


def _span_totals(trace_dir: str) -> dict:
    """{span name: [total ms, count, longest ms]} of the host spans
    (utils/profiling.trace) in the one Chrome trace under trace_dir."""
    (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            tot = out.setdefault(e["name"], [0.0, 0, 0.0])
            tot[0] += e["dur"] / 1e3
            tot[1] += 1
            tot[2] = max(tot[2], e["dur"] / 1e3)
    return out


def _connect(port: int):
    """A keep-alive client socket to 127.0.0.1:port for bench._roundtrip."""
    import socket

    conn = socket.create_connection(("127.0.0.1", port), timeout=3600)
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


def _post_bodies(port: int, p0: int, p1: int, body_docs: int, threads: int) -> dict:
    """POST the docs of positions [p0, p1) as _bulk bodies of body_docs docs,
    taken in position order by `threads` clients on keep-alive sockets."""
    from .bench import _roundtrip

    starts = iter(range(p0, p1, body_docs))
    lock, errors, sent = threading.Lock(), [], [0, 0]

    def client():
        conn = _connect(port)
        try:
            while not errors:
                with lock:
                    q0 = next(starts, None)
                if q0 is None:
                    return
                body = bulk_body(q0, min(q0 + body_docs, p1))
                status, resp = _roundtrip(conn, b"POST", b"/main/_bulk", body)
                if status != 200:
                    errors.append(f"_bulk of positions [{q0}, ...): HTTP {status} {resp[:200]!r}")
                    return
                with lock:
                    sent[0] += 1
                    sent[1] += len(body)
        except Exception as exc:  # noqa: BLE001 -- raised below
            errors.append(repr(exc))
        finally:
            conn.close()

    ts = [threading.Thread(target=client, name=f"bulk-client-{k}") for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise RuntimeError(f"bulk load failed: {errors[:3]}")
    return {"bodies": sent[0], "body_bytes": sent[1]}


def _index(mi):
    ref = mi._get_ref("main")
    try:
        return ref.index
    finally:
        mi._release_ref(ref)


def _server_args(data_dir: str, postings: int):
    """The CLI's flags for the load: the maintenance thread's own threshold
    checkpoint takes the whole load as one file segment (threshold one below
    the corpus's postings, no age trigger); the native search front on a
    free port."""
    from . import main as cli

    return cli.build_parser().parse_args(
        ["--dir", data_dir, "--host", "127.0.0.1", "--port", "0", "--checkpoint-threshold", str(postings - 1),
         "--checkpoint-age-ms", "0", "--search-port", "-1"])


def load_through_server(dev, data_dir: str, p0: int = 0, p1: int = N_DOCS, body_docs: int = BODY_DOCS, log=print):
    """The operator's bulk load of positions [p0, p1) through the CLI's own
    server (main.build_server over data_dir): PUT /main, the corpus as
    msgpack _bulk bodies from LOAD_THREADS clients, the maintenance thread's
    threshold checkpoint (one file segment; every merge of the load counted
    by route, a host fallback fails the load), then the server stopped and
    started again on the same directory and timed to its first answered
    _search.  Returns (the restarted server's build_server tuple, serving;
    stop it with main.stop_server, and the figures).  The load and the
    restart run under a profiler capture whose spans (merge, checkpoint,
    pack, upload) are in the figures, beside the seconds of each step, the
    peak host resident set, the card's peak allocation, and the bytes of
    the bodies, the oplog and the segment file.  Raises when the host has
    less free RAM than HOST_BYTES_PER_POSTING per posting, or on any check
    that fails."""
    import tempfile

    import torch

    from . import main as cli
    from .bench import _roundtrip
    from .engine import filefmt, manifest
    from .utils import profiling

    postings = HASHES_PER_DOC * (p1 - p0)
    need, avail = HOST_BYTES_PER_POSTING * postings, _meminfo_bytes("MemAvailable")
    if avail < need:
        raise RuntimeError(f"the load of {postings} postings through the server needs {need / 2**30:.1f} GiB of "
                           f"host RAM ({HOST_BYTES_PER_POSTING} bytes per posting); {avail / 2**30:.1f} GiB available")
    card = dev.type == "cuda"
    fig = {"docs": p1 - p0, "postings": postings, "positions": [p0, p1], "body_docs": body_docs, "threads": LOAD_THREADS,
           "host_available_gib": avail / 2**30, "host_needed_gib": need / 2**30}
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    rss = _RssPeak().start()

    args = _server_args(data_dir, postings)
    served = cli.build_server(args)
    server, mi = served[0], served[1]
    try:
        server.serve_background()
        conn = _connect(server.port)
        status, resp = _roundtrip(conn, b"PUT", b"/main")
        conn.close()
        if status != 200:
            raise RuntimeError(f"PUT /main: HTTP {status} {resp[:200]!r}")
        index = _index(mi)
        oplog_dir, seg_dir = os.path.join(index.path, "oplog"), os.path.join(index.path, "data")
        oplog_max = [0]

        with tempfile.TemporaryDirectory(prefix="bench_100m_load_") as trace_dir:
            with profiling.capture(trace_dir):
                t0 = time.perf_counter()
                fig.update(_post_bodies(server.port, p0, p1, body_docs, LOAD_THREADS))
                fig["load_s"] = time.perf_counter() - t0
                log(f"bench_100m: {fig['bodies']} _bulk bodies ({fig['body_bytes'] / 2**30:.2f} GiB) of {p1 - p0} docs "
                    f"posted from {LOAD_THREADS} clients in {fig['load_s']:.1f} s = {(p1 - p0) / fig['load_s']:.0f} docs/s")
                t1 = time.perf_counter()
                while True:
                    snap = index.acquire_reader()
                    merges = index.merge_counts.as_dict()
                    if merges["fallback"]:
                        raise RuntimeError(f"a merge of the load fell back to the host: {merges}")
                    if not snap.memory and snap.file:
                        break
                    oplog_max[0] = max(oplog_max[0], _dir_bytes(oplog_dir))
                    if time.perf_counter() - t1 > CHECKPOINT_WAIT_S:
                        raise RuntimeError(f"no checkpoint within {CHECKPOINT_WAIT_S} s of the load: {len(snap.memory)} memory "
                                           f"segments, merges {merges}")
                    time.sleep(0.1)
                fig["checkpoint_wait_s"] = time.perf_counter() - t1
                del snap
            fig["load_spans"] = _span_totals(trace_dir)
        infos = manifest.read_manifest(seg_dir)
        fig["merges"] = index.merge_counts.as_dict()
        if len(infos) != 1 or fig["merges"]["device"] < 1 or fig["merges"]["fallback"]:
            raise RuntimeError(f"the load left {len(infos)} file segments, merges by route {fig['merges']}")
        fig["segment_file_bytes"] = filefmt.segment_file_size(seg_dir, infos[0])
        fig["oplog_bytes_peak"] = oplog_max[0]
        if card:
            fig["load_card_peak_gib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        log(f"bench_100m: the threshold checkpoint took the load as one file segment of {fig['segment_file_bytes']} "
            f"bytes {fig['checkpoint_wait_s']:.1f} s after the last body; merges by route {fig['merges']}; spans "
            f"{json.dumps({k: [round(v[0], 1), v[1], round(v[2], 1)] for k, v in fig['load_spans'].items()})}")
        del index
    except BaseException:
        rss.stop()
        raise
    finally:
        cli.stop_server(*served)
    del served, server, mi
    fig["oplog_bytes_after"] = _dir_bytes(oplog_dir)  # what the restart replays

    # Restart on the same directory, timed to the first answered _search.
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    rng = np.random.default_rng(5)
    target, qs, lens = make_queries(rng, 1, p0, p1)
    body = json.dumps({"query": qs[0, : lens[0]].tolist(), "limit": LIMIT, "min_score": MIN_SCORE,
                       "score_pct": PCT, "timeout": 600_000}).encode()
    with tempfile.TemporaryDirectory(prefix="bench_100m_restart_") as trace_dir:
        with profiling.capture(trace_dir):
            t0 = time.perf_counter()
            served = cli.build_server(args)
            fig["reopen_s"] = time.perf_counter() - t0
            try:
                served[0].serve_background()
                conn = _connect(served[0].port)
                status, resp = _roundtrip(conn, b"POST", b"/main/_search", body, b"application/json")
                fig["restart_s"] = time.perf_counter() - t0
                conn.close()
            except BaseException:
                rss.stop()
                cli.stop_server(*served)
                raise
        fig["restart_spans"] = _span_totals(trace_dir)
    try:
        results = json.loads(resp)["results"] if status == 200 else None
        if not results or results[0]["id"] != int(target[0]):
            raise RuntimeError(f"the first search after the restart answered HTTP {status} {resp[:200]!r}")
        snap = _index(served[1]).ensure_views(_index(served[1]).acquire_reader())
        inter = snap.file_view.get("inter")
        if inter is None or inter.device.type != dev.type or len(snap.file) != 1 or snap.memory:
            raise RuntimeError(f"after the restart: {len(snap.file)} file segments, {len(snap.memory)} memory "
                               f"segments, file tier {'plain' if inter is None else inter.device}")
        fig["file_tier_entries"] = int(inter.numel())
        del snap, inter
        if card:
            fig["restart_card_peak_gib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        fig["peak_rss_gib"] = rss.stop() / 2**30
        log(f"bench_100m: restarted in {fig['restart_s']:.1f} s to the first answered _search (build_server "
            f"{fig['reopen_s']:.1f} s); file tier {fig['file_tier_entries']} interleaved entries on {dev}; spans "
            f"{json.dumps({k: [round(v[0], 1), v[1], round(v[2], 1)] for k, v in fig['restart_spans'].items()})}; oplog "
            f"{fig['oplog_bytes_after']} bytes replayed; peak RSS {fig['peak_rss_gib']:.1f} GiB")
    except BaseException:
        rss.stop()
        cli.stop_server(*served)
        raise
    return served, fig


def search_http(port: int, queries, threads: int = THREADS):
    """POST each query (a list of hashes) to /main/_search on `port` from
    `threads` keep-alive clients, with the reference bench's limit,
    min_score and pct; returns (the raw bodies in query order, wall s)."""
    from .bench import _roundtrip

    out, nxt, lock, errors = [None] * len(queries), [0], threading.Lock(), []

    def client():
        conn = _connect(port)
        try:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(queries) or errors:
                    return
                body = json.dumps({"query": queries[i], "limit": LIMIT, "min_score": MIN_SCORE, "score_pct": PCT,
                                   "timeout": 60_000}).encode()
                status, resp = _roundtrip(conn, b"POST", b"/main/_search", body, b"application/json")
                if status != 200:
                    errors.append(f"query {i}: HTTP {status} {resp[:200]!r}")
                    return
                out[i] = resp
        except Exception as exc:  # noqa: BLE001 -- raised below
            errors.append(repr(exc))
        finally:
            conn.close()

    ts = [threading.Thread(target=client) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"searches failed: {errors[:3]}")
    return out, wall


def check_bodies(label: str, batch, bodies, oracle=None) -> None:
    """check_answers over the JSON _search bodies of one batch (targets, qs,
    lens)."""
    targets, qs, lens = batch
    ids = np.zeros((len(bodies), LIMIT), np.int64)
    scores, counts = np.zeros_like(ids), np.zeros(len(bodies), np.int64)
    for b, raw in enumerate(bodies):
        res = json.loads(raw)["results"]
        counts[b] = len(res)
        ids[b, : len(res)] = [r["id"] for r in res]
        scores[b, : len(res)] = [r["score"] for r in res]
    check_answers(label, targets, qs, lens, ids, scores, counts, oracle)


def serve_fronts(served, batches, oracle=None, log=print) -> dict:
    """Every batch (targets, qs, lens) through the Python server's _search and
    then the native front's, THREADS clients each: self-retrieval (and, with
    `oracle`, every answer equal to it) on the Python bodies, and every
    native body byte-equal to the Python one.  Returns searches per second
    on each front."""
    server, front = served[0], served[3]
    queries = [qs[b, : lens[b]].tolist() for _, qs, lens in batches for b in range(qs.shape[0])]
    py, py_s = search_http(server.port, queries)
    pos = 0
    for k, batch in enumerate(batches):
        n = batch[0].shape[0]
        check_bodies(f"Python front, batch {k}", batch, py[pos : pos + n], oracle)
        pos += n
    native, native_s = search_http(front.port, queries)
    same = sum(a == b for a, b in zip(py, native))
    if same != len(queries):
        raise AssertionError(f"native front: {same}/{len(queries)} bodies byte-equal to the Python server's")
    fig = {"searches": len(queries), "threads": THREADS, "python_qps": len(queries) / py_s,
           "native_qps": len(queries) / native_s, "oracle": oracle is not None}
    log(f"bench_100m: {len(queries)} searches through _search at {fig['python_qps']:.0f}/s (Python server) and "
        f"{fig['native_qps']:.0f}/s (native front, every body byte-equal); self-retrieval 1.0"
        + (", every answer equal to the oracle" if oracle else ""))
    return fig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="default chiprun_out/bench_100m.json, or "
                    "chiprun_out/bench_100m_server.json with --through-server")
    ap.add_argument("--through-server", action="store_true",
                    help="load the corpus through the CLI's server (_bulk, threshold checkpoint, restart) and "
                         "serve it on both fronts, instead of building the tier on the card")
    ap.add_argument("--dir", default=None, help="--through-server: parent of the data directory (default: TMPDIR)")
    args = ap.parse_args(argv)

    import torch

    from .utils.device import device

    dev = device()
    if dev.type != "cuda":
        raise SystemExit(f"bench_100m needs a card; the port's device is {dev}")
    if args.through_server:
        import logging

        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
        import shutil
        import tempfile

        from . import main as cli
        from .measure import smi

        out = args.out or os.path.join("chiprun_out", "bench_100m_server.json")
        data_dir = tempfile.mkdtemp(prefix="bench_100m_server_", dir=args.dir)
        try:
            served, rep = load_through_server(dev, data_dir)
            try:
                rng = np.random.default_rng(11)
                batches = [make_queries(rng) for _ in range(2)] + [boundary_queries(rng)]
                rep["serve"] = serve_fronts(served, batches)
            finally:
                cli.stop_server(*served)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        rep.update(nvidia_smi=smi("name,power.limit"), device=torch.cuda.get_device_name(dev))
    else:
        out = args.out or os.path.join("chiprun_out", "bench_100m.json")
        snap, rep = build_timed(dev)
        rep.update(run(dev, snap))
        del snap
    torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

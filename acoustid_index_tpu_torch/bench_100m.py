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


# ---- the corpus: bench_100m.py's functions, copied (tests/test_torch_scale.py
# holds them equal to the originals) ----


def np_bitrev27(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.uint64)
    r = np.zeros_like(v)
    for b in range(DOC_BITS):
        r |= ((v >> b) & 1) << (DOC_BITS - 1 - b)
    return r.astype(np.uint32)


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
    p = np_bitrev27(doc_ids - 1)  # position within each band
    out = np.empty((doc_ids.shape[0], HASHES_PER_DOC), np.uint32)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "bench_100m.json"))
    args = ap.parse_args(argv)

    import torch

    from .utils.device import device

    dev = device()
    if dev.type != "cuda":
        raise SystemExit(f"bench_100m needs a card; the port's device is {dev}")
    snap, rep = build_timed(dev)
    rep.update(run(dev, snap))
    del snap
    torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Times the port's search program alone on one card, below the HTTP front.

    python -m acoustid_index_tpu_torch.measure [--out FILE]

Packs one file tier straight from the reference bench's corpus (bench.py's
doc_hashes formula: 10M docs x 24 hashes = 240M postings) beside an empty
memory tier, then reports:

  * at batch sizes 1, 16, 64 and 256 of ~120-hash queries (20 target hashes
    + 100 noise, limit 10, min_score 6, pct 10): ms per batch by host clock
    over 20 batches, each launched and fetched as the searcher serves one
    (Searcher._launch on its stream, pinned copy-back, event wait), with
    each kernel's launches per batch; and the range phase alone
    (_batch_ranges) by CUDA events over the same 20;
  * a torch.profiler trace of 5 batches at B=256: summed device time over
    wall time (the card's busy share) and the largest device entries;
  * K1 (stride 2) and K2 alone on the packed table at the B=256 batch's
    landing-lookup count, in 5 rounds of 50 launches each (CUDA events), with
    nvidia-smi's SM clock and power draw read around each round.

Prints one JSON object as its last line and writes it to --out.  Needs a
card; builds the kernels at first use like any other caller.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from types import SimpleNamespace

import numpy as np

N_DOCS = 10_000_000  # bench.py's N_DOCS
HASHES_PER_DOC = 24
NOISE_HASHES = 100
BATCHES = (1, 16, 64, 256)


def doc_hashes(ids):
    """bench.py's deterministic per-doc hash sets (wrapping u32 arithmetic)."""
    j = np.arange(HASHES_PER_DOC, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = ids.astype(np.uint32)[:, None] * np.uint32(2654435761)
        h = h + j[None, :] * np.uint32(0x27D4EB2F) + np.uint32(12345)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(16))
    return h.astype(np.uint32)


def sorted_corpus(n_docs: int, dev):
    """(hashes, docids) u32 of docs 1..n_docs sorted by (hash, docid), sorted
    on `dev` as one u64 key."""
    import torch

    hs, ds = [], []
    step = 1_000_000
    for lo in range(1, n_docs + 1, step):
        ids = np.arange(lo, min(lo + step, n_docs + 1), dtype=np.uint32)
        hs.append(doc_hashes(ids).reshape(-1))
        ds.append(np.repeat(ids, HASHES_PER_DOC))
    # Signed int64 key that orders as the unsigned (hash, docid) pair.
    hi = torch.from_numpy(np.concatenate(hs).astype(np.int64)) - (1 << 31)
    key = (hi << 32) + torch.from_numpy(np.concatenate(ds).astype(np.int64))
    key = torch.sort(key.to(dev)).values.cpu().numpy()
    return ((key >> 32) + (1 << 31)).astype(np.uint32), (key & 0xFFFFFFFF).astype(np.uint32)


def make_query(rng, target_hashes):
    noise = rng.integers(0, 2**32, NOISE_HASHES, dtype=np.uint32)
    return np.unique(np.concatenate([target_hashes[:20], noise])).tolist()


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else f"nvidia-smi rc {out.returncode}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "measure.json"))
    args = ap.parse_args(argv)

    import torch

    from .engine.memseg import Segment
    from .engine.model import SearchOptions, SegmentInfo
    from .engine.searcher import Searcher, _pack_rows, _params_for
    from .engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier, tier_view_for_search
    from .ops import block_lookup as bl
    from .ops import search_kernel as sk
    from .ops.layout import BLOCK
    from .utils.device import device

    dev = device()
    if dev.type != "cuda":
        raise SystemExit(f"measure needs a card; the port's device is {dev}")
    report = {"nvidia_smi": smi("name,power.limit"), "docs": N_DOCS}

    t0 = time.perf_counter()
    hashes, docids = sorted_corpus(N_DOCS, dev)
    ids = np.arange(1, N_DOCS + 1, dtype=np.uint32)
    seg = Segment(SegmentInfo(commit_id=1), hashes, docids, ids, np.ones(N_DOCS, bool), 1, N_DOCS)
    searcher = Searcher(dev)
    snap = SimpleNamespace(
        file_view=pack_tier([seg], FILE_SLOTS, device_mentions=False, device=dev),
        mem_view=pack_tier([], MEMORY_SLOTS, device=dev),
    )
    del hashes, docids, seg
    report["pack_s"] = time.perf_counter() - t0
    inter = snap.file_view["inter"]

    rng = np.random.default_rng(11)
    opts = SearchOptions(max_results=10, min_score=6, min_score_pct=10)
    params = _params_for(128)

    def packed_batch(b: int) -> np.ndarray:
        targets = rng.integers(1, N_DOCS + 1, b, dtype=np.uint32)
        th = doc_hashes(targets)
        rows = [searcher._row(*searcher.prepare_query(make_query(rng, th[i])), opts)[0] for i in range(b)]
        return _pack_rows(params, rows, b)

    def run(packed):
        return searcher._fetch(searcher._launch(snap, params, packed))

    file_view = tier_view_for_search(snap.file_view, mentions=False)
    mem_view = tier_view_for_search(snap.mem_view)
    report["batches"] = {}
    for b in BATCHES:
        packs = [packed_batch(b) for _ in range(21)]
        run(packs[0])  # first use of this shape
        stats0, launches0 = dict(sk.STATS), dict(bl.LAUNCHES)
        t0 = time.perf_counter()
        for p in packs[1:]:
            run(p)
        wall_ms = (time.perf_counter() - t0) * 1e3 / 20
        launches = {k: (bl.LAUNCHES[k] - launches0[k]) / 20 for k in bl.LAUNCHES}
        # The range phase alone, on the same batches.
        ins = [torch.from_numpy(p.view(np.int32)).to(dev) for p in packs[1:]]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            for x in ins:
                sk._batch_ranges(params, file_view, mem_view, sk.u32(x[:, :128]), x[:, 128].to(torch.int64), want_emit=True)
            end.record()
        end.synchronize()
        report["batches"][str(b)] = {
            "ms_per_batch_wall": wall_ms,
            "queries_per_s": b * 1e3 / wall_ms,
            "range_phase_ms_events": start.elapsed_time(end) / 20,
            "branches": {k: sk.STATS[k] - stats0[k] for k in sk.STATS},
            "launches_per_batch": launches,
        }

    # Busy share of the card over 5 batches at B=256.
    packs = [packed_batch(256) for _ in range(5)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in packs:
            run(p)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    top = sorted(events, key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)[:12]
    report["profile"] = {
        "wall_ms": wall,
        "device_ms": dev_us / 1e3,
        "busy_share": dev_us / 1e3 / wall,
        "top": [[e.key[:120], e.count, getattr(e, "self_device_time_total", 0) / 1e3] for e in top],
    }

    # K1 (stride 2) and K2 alone on the packed table, 5 rounds.
    L = 256 * 128
    nblk = inter.shape[0] // (2 * BLOCK)
    g = torch.Generator(device=dev).manual_seed(3)
    blk = torch.randint(0, nblk, (L,), generator=g, device=dev, dtype=torch.int32)
    q = inter.view(nblk, 2 * BLOCK)[blk.to(torch.int64), torch.randint(0, BLOCK, (L,), generator=g, device=dev)]
    kernels = {"block_count_stride2": lambda: bl.block_count(inter, blk, q, 2), "block_count_emit": lambda: bl.block_count_emit(inter, blk, q)}
    rounds = []
    for _ in range(5):
        row = {"smi_before": smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")}
        for name, fn in kernels.items():
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                fn()
            end.record()
            end.synchronize()
            row[name + "_ms"] = start.elapsed_time(end) / 50
        row["smi_after"] = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
        rounds.append(row)
    report["kernel_rounds"] = {"lookups": L, "table_blocks": nblk, "rounds": rounds}

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

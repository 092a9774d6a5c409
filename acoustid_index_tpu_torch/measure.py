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
  * K1 and K2 alone at the shapes the main path gives them
    (main_path_cases, phase1_cases): (a) K1 over the packed tier's 1 MiB
    top index with a B=256 batch's 32,768 landing lookups; (b) K1 as
    tier_ranges_resident calls it, two lookups per query, over a sorted
    table of the smoke's live memory-tier size; (c) K1 stride 2 and K2 over
    the packed 2 GiB interleaved tier with 32,768 + 2,048 lookups; (d)
    chip_smoke.py's 64K-block table (all four kernels).  At each shape the
    kernel, its first (scanning) design, the search designs it did not take
    (csrc/block_lookup_designs.cu) and, for K1, the torch.searchsorted
    yardstick run in turns, 5 rounds of 50 launches each, cold (cycling
    through input sets that together exceed the L2 four times) and warm
    (one set), with nvidia-smi's SM clock and power draw read around each
    round; each must equal the plain version bit for bit on every set first.

    python -m acoustid_index_tpu_torch.measure --mesh 1,2,4,8 [--out FILE]

times the sharded program (parallel/: N shards as slices of the card) in
place of the above: the same corpus packed once for the single program and
once per shard count (ShardedBatchingSearcher's packing), every B=256
batch's results first checked equal to the single program's; then, in
turns (single, 1, 2, 4, 8, then the reverse, ...), 20 batches per turn,
each launched and fetched as the searcher serves one: ms per batch by host
clock and by CUDA events on the searcher's stream (launch to the batch's
last work), kernel launches, host syncs and branches per batch; then the
range phase alone by CUDA events, and 5 batches under torch.profiler for
the card's kernel time per batch (K1 and K2 apart) and its busy share.

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


# ---------------------------------------------------------------- kernels
#
# The kernels alone at the shapes the main path gives them.  chip_smoke.py
# phase 1 runs the same cases on synthetic tables; main() below on the
# packed tier, with the search designs K1 and K2 did not take
# (csrc/block_lookup_designs.cu) beside them.

LOOKUPS = 256 * 128  # a B=256 batch's landing lookups (Q = 128)
TAIL = 2048  # tier_ranges_blocked's straddle tail (AITPU_WINDOW_CAP's default)
# chip_smoke.py's live memory tier while it serves the native front: 33,720
# postings (1,000 new docs, 5 re-inserts and 400 hot-hash docs of 24 hashes)
# in a tier of 49,152 (phase 2 checks the capacity).
MEM_TIER_LIVE, MEM_TIER_CAP = 33_720, 49_152
ROUNDS, TURN_LAUNCHES = 5, 50
# The card's peaks (H100 SXM data sheet): HBM bytes per second, and the
# float32 rate outside the tensor cores, taken as the rate of the kernels'
# 32-bit integer compares.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
_SLEEP_CYCLES = 20_000_000  # ~10 ms: the card waits while the host queues a turn
# Cold and warm.  On the main path every batch brings new lookups, and
# between two calls of one kernel the rest of a batch (K2's tens of MB over
# the file tier, the candidate gathers) passes through the H100's 50 MB L2,
# so a call finds its inputs cold there.  A case's cold turns cycle through
# independent input sets that together hold at least COLD_BYTES: fresh
# lookups over one large table ((c), (d): QUERY_SETS batches, each call
# touching >= 12 MB), or fresh lookups and a fresh copy of a small table
# ((a), (b)).  Its warm turns repeat one set, whose table and lookups then
# stay in L2 from call to call.
L2_BYTES = 50 * 2**20
COLD_BYTES = 4 * L2_BYTES
QUERY_SETS = 16


def _n_sets(table_bytes: int, L: int) -> int:
    """Input sets of a small-table case that hold COLD_BYTES together: each
    a table copy plus its lookups' blk, q, lt and eq (16 bytes each)."""
    return -(-COLD_BYTES // (table_bytes + 16 * L))


def sorted_table(n: int, live: int, g, dev):
    """n u32 values (int64) in ascending order: `live` random ones, then
    0xFFFFFFFF padding, as a packed tier holds them."""
    import torch

    h = torch.sort(torch.randint(0, 0xFFFFFFFF, (live,), generator=g, device=dev, dtype=torch.int64)).values
    return torch.cat([h, torch.full((n - live,), 0xFFFFFFFF, dtype=torch.int64, device=dev)])


def interleave(hashes, docids):
    """(n,) + (n,) int64 u32 values -> the interleaved int32 table."""
    import torch

    from .ops.layout import BLOCK, to_storage

    nblk = hashes.shape[0] // BLOCK
    return torch.stack([to_storage(hashes).view(nblk, BLOCK), to_storage(docids).view(nblk, BLOCK)], 1).reshape(-1).contiguous()


def searchsorted_count(sorted64, blk, q64):
    """K1's (lt, eq) by torch.searchsorted over a globally sorted table
    (int64 u32 values), both sides clamped to each lookup's block: the
    yardstick that chip_smoke.py reports as K1's library time.  The port
    never calls it."""
    import torch

    from .ops.layout import BLOCK

    base = blk.to(torch.int64) * BLOCK
    lo = torch.searchsorted(sorted64, q64, side="left").clamp_(min=base, max=base + BLOCK)
    hi = torch.searchsorted(sorted64, q64, side="right").clamp_(min=base, max=base + BLOCK)
    return (lo - base).to(torch.int32), (hi - lo).to(torch.int32)


def design_count(name, table, blk, q, stride):
    """(lt, eq) by aitpu_design_count_<name> (csrc/block_lookup_designs.cu),
    a K1 design the port does not run; counted in no LAUNCHES."""
    import torch

    from .ops import _build
    from .ops import block_lookup as bl
    from .ops.layout import BLOCK

    blk, q = bl._cuda_args(table, blk, q)
    L = blk.shape[0]
    lt = torch.empty(L, dtype=torch.int32, device=table.device)
    eq = torch.empty(L, dtype=torch.int32, device=table.device)
    rc = getattr(_build.library("designs"), "aitpu_design_count_" + name)(
        table.data_ptr(), blk.data_ptr(), q.data_ptr(), lt.data_ptr(), eq.data_ptr(),
        L, table.shape[0] // (stride * BLOCK), stride, torch.cuda.current_stream(table.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"design_count_{name} launch failed: cudaError {rc}")
    return lt, eq


def design_emit(name, inter, blk, q):
    """(lt, eq, rows) by aitpu_design_emit_<name>, a K2 design the port
    does not run."""
    import torch

    from .ops import _build
    from .ops import block_lookup as bl
    from .ops.layout import BLOCK

    blk, q = bl._cuda_args(inter, blk, q)
    L = blk.shape[0]
    lt = torch.empty(L, dtype=torch.int32, device=inter.device)
    eq = torch.empty(L, dtype=torch.int32, device=inter.device)
    rows = torch.empty((L, 2, 128), dtype=torch.int32, device=inter.device)
    rc = getattr(_build.library("designs"), "aitpu_design_emit_" + name)(
        inter.data_ptr(), blk.data_ptr(), q.data_ptr(), lt.data_ptr(), eq.data_ptr(), rows.data_ptr(),
        L, inter.shape[0] // (2 * BLOCK), torch.cuda.current_stream(inter.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"design_emit_{name} launch failed: cudaError {rc}")
    return lt, eq, rows


SECTOR_ARITIES = (2, 4, 8)  # the sector designs of csrc/probe_lookup_designs.cu
# K3's and K4's designs beside the kernels: their first, per-thread binary search
# and the sector search at every arity (the kernels' own included); K4's
# also with its second docid sector loaded lazily ("sectorKlazy").
PAIR_DESIGNS = ("thread11",) + tuple(f"sector{a}" for a in SECTOR_ARITIES)
EMIT_DESIGNS = PAIR_DESIGNS + tuple(f"sector{a}lazy" for a in SECTOR_ARITIES)


def kernel_design(kernel):
    """The design name of what K3 ("block_count_pair") or K4 launches."""
    from .ops import probe_lookup as pl

    lazy = "lazy" if kernel == "block_count_emit_docids" and pl.SECTOR_LAZY else ""
    return f"sector{pl.SECTOR_ARITY}{lazy}"


def _design_args(name, designs):
    """(C entry suffix, extra arguments) of a K3/K4 design name."""
    if name not in designs:
        raise ValueError(f"design {name!r} is not one of {designs}")
    if name == "thread11":
        return "thread11", ()
    lazy = name.endswith("lazy")
    arity = (int(name.removeprefix("sector").removesuffix("lazy")),)
    return "sector", arity + ((int(lazy),) if designs is EMIT_DESIGNS else ())


def design_pair(name, table, blk0, blk1, q, stride=1, variant="full", g=8):
    """K3's composite by the design `name` of PAIR_DESIGNS
    (csrc/probe_lookup_designs.cu), which the port does not run; counted in
    no LAUNCHES."""
    import torch

    from .ops import _build
    from .ops import block_lookup as bl
    from .ops import probe_lookup as pl
    from .ops.layout import BLOCK

    entry, extra = _design_args(name, PAIR_DESIGNS)
    blk0, q = bl._cuda_args(table, blk0, q)
    blk1 = blk1.to(torch.int32).contiguous()
    L = blk0.shape[0]
    comp = torch.empty(L, dtype=torch.int32, device=table.device)
    rc = getattr(_build.library("designs"), "aitpu_design_pair_" + entry)(
        table.data_ptr(), blk0.data_ptr(), blk1.data_ptr(), q.data_ptr(), comp.data_ptr(),
        L, table.shape[0] // (stride * BLOCK), stride, pl.PAIR_VARIANTS.index(variant), g, *extra,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"design_pair {name} launch failed: cudaError {rc}")
    return comp


def design_emit_docids(name, inter, blk, q, E, R=1024, mode="onehot"):
    """K4's (comp, d) by the design `name` of EMIT_DESIGNS, which the port
    does not run."""
    import torch

    from .ops import _build
    from .ops import block_lookup as bl
    from .ops import probe_lookup as pl
    from .ops.layout import BLOCK

    entry, extra = _design_args(name, EMIT_DESIGNS)
    blk, q = bl._cuda_args(inter, blk, q)
    L = blk.shape[0]
    comp = torch.empty(L, dtype=torch.int32, device=inter.device)
    d = torch.empty((E, L), dtype=torch.int32, device=inter.device)
    rc = getattr(_build.library("designs"), "aitpu_design_emit_docids_" + entry)(
        inter.data_ptr(), blk.data_ptr(), q.data_ptr(), comp.data_ptr(), d.data_ptr(),
        L, inter.shape[0] // (2 * BLOCK), E, R, pl.EMIT_MODES.index(mode), *extra,
        torch.cuda.current_stream(inter.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"design_emit_docids {name} launch failed: cudaError {rc}")
    return comp, d


def _set(table, blk, q64, sorted64=None, spans=None):
    """One input set: the kernels' inputs (int32 blk, int32 bit-pattern q,
    as the range phase hands them), the int64 query values, the
    yardstick's table and K1m's spans."""
    import torch

    from .ops.layout import to_storage

    return {"inputs": (table, blk.to(torch.int32).contiguous(), to_storage(q64).contiguous()),
            "q64": q64, "sorted64": sorted64, "spans": spans}


def _case(kernel, shape, note, stride, sets, variants, plain):
    table, blk, _ = sets[0]["inputs"]
    return {"kernel": kernel, "shape": shape, "note": note, "stride": stride, "L": int(blk.shape[0]),
            "table_entries": int(table.shape[0]), "sets": sets, "variants": variants, "plain": plain}


def _k1_case(shape, note, stride, sets, designs=False):
    """K1 at one shape: the search, the scan, the torch.searchsorted
    yardstick and, with `designs`, the 8-lane group design."""
    from .ops import block_lookup as bl

    variants = {
        "new": lambda s: bl.block_count(*s["inputs"], stride),
        "scan": lambda s: bl.block_count_scan(*s["inputs"], stride),
        "searchsorted": lambda s: searchsorted_count(s["sorted64"], s["inputs"][1], s["q64"]),
    }
    if designs:
        variants["group8"] = lambda s: design_count("group8", *s["inputs"], stride)
    return _case("block_count", shape, note, stride, sets, variants, lambda s: bl.block_count_plain(*s["inputs"], stride))


def _k2_case(shape, note, sets, designs=False):
    from .ops import block_lookup as bl

    variants = {
        "new": lambda s: bl.block_count_emit(*s["inputs"]),
        "scan": lambda s: bl.block_count_emit_scan(*s["inputs"]),
    }
    if designs:
        variants["group8"] = lambda s: design_emit("group8", *s["inputs"])
        variants["warp32"] = lambda s: design_emit("warp32", *s["inputs"])
    return _case("block_count_emit", shape, note, 2, sets, variants, lambda s: bl.block_count_emit_plain(*s["inputs"]))


def main_path_cases(inter, n_live: int, qpool, mem_hashes, g, designs: bool = False):
    """Shapes (a)-(c) and the L = 1 launch floor.  `inter` is a packed
    interleaved tier with `n_live` live postings (globally sorted), `qpool`
    (QUERY_SETS, LOOKUPS) batches of flat query hashes (int64 u32 values),
    `mem_hashes` a sorted memory-tier table (int32 storage).  Lookups are
    made as the main path makes them: landing chunks and blocks from each
    table's own top index."""
    import torch

    from .ops import block_lookup as bl
    from .ops.layout import BLOCK, u32

    dev = inter.device
    nblk = inter.shape[0] // (2 * BLOCK)
    hh = inter.view(nblk, 2 * BLOCK)[:, :BLOCK]
    h64 = u32(hh.reshape(-1))  # the hash halves, contiguous: the yardstick's table
    qs = list(qpool)

    # (a) the file tier's top-index lookup (tier_ranges_blocked, stage 1),
    # each set over its own copy of the 1 MiB top index.
    bi = hh[:, 0].contiguous()
    if bi.shape[0] % BLOCK:
        bi = torch.cat([bi, torch.full((-bi.shape[0] % BLOCK,), -1, dtype=torch.int32, device=dev)])
    sets = []
    for k in range(_n_sets(bi.shape[0] * 4, LOOKUPS)):
        t, q = bi.clone(), qs[k % len(qs)].clone()
        sets.append(_set(t, bl._landing_chunk(u32(t[::BLOCK]), q), q, u32(t)))
    cases = [_k1_case("a", "top index of the file tier", 1, sets, designs)]

    # (b) tier_ranges_resident over the live memory tier: chunks c-1 and c.
    sets = []
    for k in range(_n_sets(mem_hashes.shape[0] * 4, 2 * LOOKUPS)):
        t, qm = mem_hashes.clone(), qs[k % len(qs)].clone()
        hit = torch.randint(0, MEM_TIER_LIVE, (qm.shape[0] // 6,), generator=g, device=dev)
        qm[: hit.shape[0]] = u32(t[hit])
        cm = bl._landing_chunk(u32(t[::BLOCK]), qm)
        sets.append(_set(t, torch.cat([torch.clamp(cm - 1, min=0), cm]), torch.cat([qm, qm]), u32(t)))
    cases.append(_k1_case("b", f"memory tier of {mem_hashes.shape[0]} entries, two lookups per query", 1, sets, designs))

    # (c) the landing stream of the file tier plus its straddle tail.
    blk_last = (n_live - 1) // BLOCK
    top64 = u32(bi)
    sets = []
    for q in qs:
        blk = torch.clamp(torch.searchsorted(top64, q, right=True) - 1, 0, blk_last)
        sets.append(_set(inter, torch.cat([blk, torch.clamp(blk[:TAIL] - 1, min=0)]), torch.cat([q, q[:TAIL]]), h64))
    note = f"{inter.shape[0] * 4 / 2**30:.2f} GiB interleaved tier, landing stream + tail"
    cases.append(_k1_case("c", note, 2, sets, designs))
    cases.append(_k2_case("c", note, sets, designs))

    q1 = qs[0][:1].contiguous()
    floor = _k1_case("floor", "L = 1: the launch floor", 1, [_set(bi, bl._landing_chunk(u32(bi[::BLOCK]), q1), q1, top64)])
    # As the main path called K1 before the range phase made int32 queries.
    floor["variants"]["new_int64_queries"] = lambda s: bl.block_count(s["inputs"][0], s["inputs"][1], s["q64"], 1)
    cases.append(floor)
    return cases


def phase1_cases(dev, g, designs: bool = False):
    """Shape (d): chip_smoke.py's first 64K-block table, all four
    kernels at L = 34,816 (a batch's lookups plus the tail), K1m with
    random [lo_b, hi_b) spans, some across block edges, some empty;
    QUERY_SETS sets of fresh lookups."""
    import torch

    from .ops import block_lookup as bl
    from .ops.layout import BLOCK, to_storage

    nblk = 65536
    n = nblk * BLOCK
    h = torch.sort(torch.randint(0, 0xFFFFFFFF, (n,), generator=g, device=dev, dtype=torch.int64)).values
    # Equal runs across every 97th block boundary, and sentinel padding.
    for b in range(1, nblk, 97):
        h[b * BLOCK - 3 : b * BLOCK + 5] = h[b * BLOCK].item()
    h[-3000:] = 0xFFFFFFFF
    d = torch.randint(1, 0xFFFFFFFF, (n,), generator=g, device=dev, dtype=torch.int64)
    hashes = to_storage(h)
    inter = interleave(h, d)

    L = LOOKUPS + TAIL
    flat, wide = [], []
    for _ in range(QUERY_SETS):
        pos = torch.randint(0, n, (L,), generator=g, device=dev)
        blk = (pos // BLOCK).to(torch.int32)
        q = h[pos]
        q[1::7] = torch.randint(0, 0xFFFFFFFF, q[1::7].shape, generator=g, device=dev)  # misses
        q[2::13] = 0xFFFFFFFF  # sentinel queries count the padding
        blk[3::29] = 0  # dead lanes point at block 0
        lo = pos - torch.randint(0, 1536, (L,), generator=g, device=dev)
        hi = pos + torch.randint(0, 1536, (L,), generator=g, device=dev)
        hi[::8] = lo[::8] - torch.randint(0, 2, lo[::8].shape, generator=g, device=dev)
        whole = blk[4::8].to(torch.int64) * BLOCK
        lo[4::8], hi[4::8] = whole - 7, whole + BLOCK + 7
        spans = (lo.clamp(0, n).to(torch.int32), hi.clamp(0, n).to(torch.int32))
        flat.append(_set(hashes, blk, q, h, spans))
        wide.append(_set(inter, blk, q, h))

    note = "64K-block table"
    masked = _case("block_count_masked", "d", note, 1, flat,
                   {"new": lambda s: bl.block_count_masked(*s["inputs"], *s["spans"])},
                   lambda s: bl.block_count_masked_plain(*s["inputs"], *s["spans"]))
    (lo_b, hi_b), b0 = flat[0]["spans"], flat[0]["inputs"][1]
    cut = ((lo_b // BLOCK != b0) | ((hi_b - 1) // BLOCK != b0)) & (hi_b > lo_b)
    masked["span_counts"] = {"empty": int((hi_b <= lo_b).sum()), "cut_by_a_block_edge": int(cut.sum())}
    return [
        _k1_case("d", note, 1, flat, designs),
        _k1_case("d", note, 2, wide, designs),
        masked,
        _k2_case("d", note, wide, designs),
    ]


# ---- K3-K5, the probes' kernels (ops/probe_lookup.py) ----
#
# At the probes' own shapes (acoustid_index_tpu_torch/probes.py builds the
# tables): L = 32,768 lookups over 2^28-entry (1 GiB) and 2^27-entry
# interleaved (1 GiB) tables whose hashes are the posting index, as the
# probes' arange tables, K3 and K4 beside the designs they did not take
# (csrc/probe_lookup_designs.cu, library "designs").  chip_smoke.py phase
# 1c runs these cases; `python -m acoustid_index_tpu_torch.probes` runs
# them beside the probe sites' own cases.

PROBE_L = 32_768


def probe_queries(hash_of, nblk: int, g, dev, lo: int = 1, L: int = PROBE_L):
    """(blk int32, q int64 u32 values) of one probe input set: blocks
    uniform in [lo, nblk - 1); per eight lookups, four hit their block at a
    random position and one at one of its last four, three are uniform u32
    (over the arange tables: past the block's end).  `hash_of(idx)` is the
    hash of posting idx."""
    import torch

    from .ops.layout import BLOCK

    blk = torch.randint(lo, nblk - 1, (L,), generator=g, device=dev)
    pos = torch.randint(0, BLOCK, (L,), generator=g, device=dev)
    kind = torch.arange(L, device=dev) % 8
    pos = torch.where(kind == 1, BLOCK - 1 - (pos & 3), pos)
    q = hash_of(blk * BLOCK + pos)
    miss = torch.randint(0, 1 << 32, (L,), generator=g, device=dev, dtype=torch.int64)
    return blk.to(torch.int32), torch.where(kind >= 5, miss, q)


def _designs_not_taken(kernel, sets):
    """The K3/K4 designs timed beside the kernel: PAIR_DESIGNS /
    EMIT_DESIGNS but the kernel's own, on a card only (they have no CPU
    version)."""
    if not sets[0]["inputs"][0].is_cuda:
        return ()
    designs = PAIR_DESIGNS if kernel == "block_count_pair" else EMIT_DESIGNS
    return tuple(d for d in designs if d != kernel_design(kernel))


def pair_case(shape, note, stride, sets):
    """K3's window at one shape, and on a card the designs it did not take
    (thread11, the first design; the other sector arities) in the same
    turns; each set carries "blk1".  No yardstick: no single PyTorch call
    computes the window."""
    from .ops import probe_lookup as pl

    def run(fn):
        return lambda s: fn(s["inputs"][0], s["inputs"][1], s["blk1"], s["inputs"][2], stride)

    variants = {"new": run(pl.block_count_pair)}
    for d in _designs_not_taken("block_count_pair", sets):
        variants[d] = run(lambda *a, d=d: design_pair(d, *a))
    case = _case("block_count_pair", shape, note, stride, sets, variants, run(pl.block_count_pair_plain))
    case["variant"] = "full"
    return case


def emit_docids_case(shape, note, sets, E, R, mode="onehot"):
    """K4 at one shape, beside its designs not taken (as pair_case): no
    yardstick (no single PyTorch call computes it)."""
    from .ops import probe_lookup as pl

    variants = {"new": lambda s: pl.block_count_emit_docids(*s["inputs"], E, R, mode)}
    for d in _designs_not_taken("block_count_emit_docids", sets):
        variants[d] = lambda s, d=d: design_emit_docids(d, *s["inputs"], E, R, mode)
    case = _case("block_count_emit_docids", shape, note, 2, sets, variants,
                 lambda s: pl.block_count_emit_docids_plain(*s["inputs"], E, R, mode))
    case.update(E=E, R=R, mode=mode)
    return case


def staged_case(shape, note, sets, configs):
    """K5 at one shape, each (G, NBUF) of `configs` a variant (the first is
    the headline), beside K1's scan (per-thread 16-byte loads of the same
    4 KB), K1's search and the searchsorted yardstick on sorted tables,
    each of those three with the composite's packing (K5 writes it from
    its own body)."""
    from .ops import block_lookup as bl
    from .ops import probe_lookup as pl

    comp = pl.composite
    variants = {f"G{G}xNBUF{N}": (lambda s, G=G, N=N: pl.block_count_staged(*s["inputs"], G, N)) for G, N in configs}
    variants["scan"] = lambda s: comp(*bl.block_count_scan(*s["inputs"], 1))
    if sets[0]["sorted64"] is not None:
        variants["search"] = lambda s: comp(*bl.block_count(*s["inputs"], 1))
        variants["searchsorted"] = lambda s: comp(*searchsorted_count(s["sorted64"], s["inputs"][1], s["q64"]))
    case = _case("block_count_staged", shape, note, 1, sets, variants, lambda s: pl.block_count_staged_plain(*s["inputs"]))
    case["headline"] = next(iter(variants))
    return case


def probe_kernel_cases(t, g, n_sets: int = QUERY_SETS):
    """K3, K4 and K5 at one probe shape each, QUERY_SETS input sets, K3
    and K4 beside their designs not taken (pair_case, emit_docids_case):
    K3 (window, stride 1 and 2) over _pairkernel's callers' 2^28 table,
    half the lookups with blk1 = blk0 + 1; K4 (E = 2 and 4, R = 1024 and
    128) over _probe_fused's 2^27 interleaved tables; K5 ((G, NBUF) = (8,
    4) and (16, 2)) over _probe_dma2's 2^28 table.  `t` is probes.py's
    build_tables()."""
    import torch

    def ident(idx):
        return idx

    cases = []
    for key, stride, label in (("t28", 1, "2^28 hashes (1 GiB)"), ("i28", 2, "2^28 interleaved (2 GiB)")):
        table = t[key]
        nblk = table.shape[0] // (stride * 1024)
        sets = []
        for _ in range(n_sets):
            blk0, q = probe_queries(ident, nblk, g, table.device)
            s = _set(table, blk0, q, t["sorted64"] if stride == 1 else None)
            s["blk1"] = torch.where(torch.arange(blk0.shape[0], device=table.device) % 2 == 0, blk0 + 1, 0).to(torch.int32)
            sets.append(s)
        cases.append(pair_case("probe-window", f"{label}, half the windows enabled", stride, sets))
    for key, R in (("rm27", 1024), ("lm27", 128)):
        table = t[key]
        sets = [_set(table, *probe_queries(ident, table.shape[0] // 2048, g, table.device)) for _ in range(n_sets)]
        for E in (2, 4):
            cases.append(emit_docids_case(f"probe-E{E}-R{R}", f"2^27 interleaved (1 GiB), 3/8 of lookups past the block end", sets, E, R))
    table = t["t28"]
    sets = [_set(table, *probe_queries(ident, table.shape[0] // 1024, g, table.device), t["sorted64"]) for _ in range(n_sets)]
    cases.append(staged_case("probe", "2^28 hashes (1 GiB)", sets, ((8, 4), (16, 2))))
    return cases


def turn_ms(fn, sets, n: int, start: int = 0) -> float:
    """ms per call of n back-to-back calls fn(sets[(start + i) % len(sets)]),
    CUDA events.  The card first sleeps while the host queues the n calls,
    so the time is the card's and not the host's dispatch."""
    import torch

    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(_SLEEP_CYCLES)
    start_ev.record()
    for i in range(n):
        fn(sets[(start + i) % len(sets)])
    end_ev.record()
    end_ev.synchronize()
    return start_ev.elapsed_time(end_ev) / n


def _bound_sectors(b, at, words_per_block: int):
    """Distinct 32-byte sectors holding block-relative words `at` (one
    row per lookup) of blocks `b`."""
    import torch

    return int(torch.unique(((b[:, None] * words_per_block + at) * 4 // 32).reshape(-1)).numel())


def search_schedule(design, at, q):
    """(lt, ub, reads, sector) of q[j] (int64 u32 values) in one sorted
    block per lookup, as the K3/K4 design `design` of EMIT_DESIGNS
    searches it (csrc/probe_lookup_designs.cu, csrc/sector_search.cuh).
    `at(i)` gives the hashes at block-relative positions i (int64, shape
    (L,) or (L, k)) of each lookup's block.  `reads` (L, n) holds the
    position of every hash the design loads, a sector's pair of 16-byte
    loads as its first position, -1 for a load it does not issue (the
    upper bound's own pivots while both bounds share a base); `sector` is
    the lower bound's final sector (None for thread11)."""
    import torch

    from .ops.layout import BLOCK

    zero = torch.zeros_like(q)
    none = torch.full_like(q, -1)
    reads = []
    if design == "thread11":
        lo, up = zero, zero
        half = BLOCK // 2
        while half:
            pl_, pu = lo + half - 1, up + half - 1
            reads += [pl_, pu]
            lo = lo + torch.where(at(pl_) < q, half, 0)
            up = up + torch.where(at(pu) <= q, half, 0)
            half //= 2
        reads += [lo, up]
        return lo + (at(lo) < q), up + (at(up) <= q), torch.stack(reads, 1), None
    arity = int(design.removeprefix("sector").removesuffix("lazy"))
    sector = 8  # u32 hashes per 32-byte sector
    sl, su = zero, zero
    size = BLOCK // sector
    while size > 1:
        k = min(arity, size)
        chunk = size // k
        split = su != sl
        ml, mu = zero, zero
        for i in range(1, k):
            pl_, pu = sector * (sl + chunk * i), sector * (su + chunk * i)
            xl = at(pl_)
            ml = ml + (xl < q)
            mu = mu + (torch.where(split, at(pu), xl) <= q)
            reads += [pl_, torch.where(split, pu, none)]
        sl, su, size = sl + chunk * ml, su + chunk * mu, chunk
    split = su != sl
    reads += [sector * sl, torch.where(split, sector * su, none)]
    within = torch.arange(sector, device=q.device)
    lt = sector * sl + (at(sector * sl[:, None] + within) < q[:, None]).sum(1)
    ub = sector * su + (at(sector * su[:, None] + within) <= q[:, None]).sum(1)
    return lt, ub, torch.stack(reads, 1), sl


def docid_reads(design, lt, sector, E, mode):
    """(L, n) block-relative docid positions K4's design `design` loads for
    E docids at lt + e (-1: none): thread11 each docid it extracts; the
    sector designs docid sector `sector` and the half sector after it
    (sector 112's, docids 896.., past the block in "slice"; none in
    "onehot"), the lazy ones that half only where lt + E - 1 reaches it."""
    import torch

    from .ops.layout import BLOCK

    if E == 0:
        return torch.empty((lt.shape[0], 0), dtype=torch.int64, device=lt.device)
    if design == "thread11":
        p = lt[:, None] + torch.arange(E, device=lt.device)
        if mode == "slice":
            return torch.clamp(p >> 7, max=BLOCK // 128 - 1) * 128 + (p & 127)
        return torch.where(p < BLOCK, p, -1)
    past = sector + 1 >= BLOCK // 8
    nxt = torch.where(past, BLOCK - 128 if mode == "slice" else -1, 8 * (sector + 1))
    if design.endswith("lazy"):
        nxt = torch.where(lt - 8 * sector + E - 1 >= 8, nxt, -1)
    return torch.stack([8 * sector, nxt], 1)


def design_sectors(table, b, q, words, R=None, E=0, mode="onehot", chunk=8192):
    """{design: the distinct 32-byte sectors of `table` (global sector ids)
    it reads} for lookups of blocks b (int64, clamped) and queries q (int64
    u32 values): K3's blocks of `words` words whose hashes are the first
    BLOCK (R None), or K4's 2048-word blocks of R-word runs with E docids."""
    import torch

    from .ops.layout import BLOCK, u32

    def hword(i):
        return i if R is None else (i // R) * 2 * R + i % R

    def dword(i):
        return (i // R) * 2 * R + R + i % R

    hpos = hword(torch.arange(BLOCK, device=b.device))
    out = {d: [] for d in (PAIR_DESIGNS if R is None else EMIT_DESIGNS)}
    for s in range(0, b.shape[0], chunk):
        bb, qq = b[s : s + chunk], q[s : s + chunk]
        h = u32(table.view(-1, words)[bb][:, hpos])

        def at(i, h=h):
            return h.gather(1, i.reshape(i.shape[0], -1)).reshape(i.shape)

        for d in out:
            lt, _, reads, sector = search_schedule(d, at, qq)
            word = torch.where(reads >= 0, hword(reads.clamp(min=0)), -1)
            if E:
                dr = docid_reads(d, lt, sector, E, mode)
                word = torch.cat([word, torch.where(dr >= 0, dword(dr.clamp(min=0)), -1)], 1)
            sec = (bb[:, None] * words + word) // 8
            out[d].append(torch.unique(sec[word >= 0]))
    return {d: torch.unique(torch.cat(v)) for d, v in out.items()}


def kernel_bound(case, s):
    """(needed bytes, scan bytes, compares) of one call on input set `s`:
    each byte the call needs, read once, each output written once.

    K1/K2 and K3 over sorted blocks need, per lookup, the 32-byte sectors
    that hold the entries on each side of its two bounds (lt - 1 and lt, ub
    - 1 and ub, inside the block), each sector counted once per call: K3 in
    each enabled block (its "noreduce" variant the sector of the block's
    first hash, "empty" none); K2 also the distinct docid rows it copies
    and the 1 KB it writes per lookup; K4 also the sectors of the docids it
    reads and 4 * (1 + E) B out.  K1m needs the entries inside its spans,
    K5 every entry of each distinct block (it counts the whole block).
    K1, K1m and K2 write lt and eq (8 B per lookup), K3 and K5 the
    composite (4 B).
    "Scan bytes" is what a scanning design reads: every distinct block's
    1024 hashes.  The counts come from the plain versions on `s`.
    K3 (window, one block) and K4 also give "read_bytes": per design of
    PAIR_DESIGNS / EMIT_DESIGNS, the distinct sectors it loads (search_schedule's loads,
    the schedule tests/test_torch_probes.py checks), plus the I/O."""
    import torch

    from .ops import block_lookup as bl
    from .ops import probe_lookup as pl
    from .ops.layout import BLOCK, u32

    kernel = case["kernel"]
    table, blk, q = s["inputs"]
    stride = case["stride"]
    nblk = table.shape[0] // (stride * BLOCK)
    L = blk.shape[0]
    b = blk.to(torch.int64).clamp(0, nblk - 1)
    io = L * (4 + 4) + L * 8  # blk, q; lt, eq
    scan = int(torch.unique(b).numel()) * BLOCK * 4 + io
    words = stride * BLOCK

    def at_bounds(lt, eq):  # the hash positions on each side of both bounds
        lt, eq = lt.to(torch.int64), eq.to(torch.int64)
        return torch.stack([lt - 1, lt, lt + eq - 1, lt + eq], 1).clamp(0, BLOCK - 1)

    if kernel == "block_count_masked":
        lo_b, hi_b = s["spans"]
        e = b[:, None] * BLOCK + torch.arange(BLOCK, device=blk.device)
        need = torch.zeros(nblk * BLOCK, dtype=torch.bool, device=blk.device)
        need[e[(e >= lo_b[:, None]) & (e < hi_b[:, None])]] = True
        return {"needed_bytes": int(need.sum()) * 4 + io + L * 8, "scan_bytes": scan, "compares": L * BLOCK * 4}
    if kernel == "block_count_staged":
        scan -= L * 4  # one 4-byte composite out
        return {"needed_bytes": scan, "scan_bytes": scan, "compares": L * BLOCK * 2}
    if kernel == "block_count_pair":
        io -= L * 4
        scan -= L * 4
        variant, blk1 = case["variant"], s["blk1"].to(torch.int64)
        if variant == "empty":
            return {"needed_bytes": L * 4, "scan_bytes": L * 4, "compares": 0}
        if variant == "noreduce":
            return {"needed_bytes": int(torch.unique(b * words * 4 // 32).numel()) * 32 + io, "scan_bytes": scan, "compares": L}
        sectors = [(b, at_bounds(*bl.block_count_plain(table, blk, q, stride)))]
        read = design_sectors(table, b, u32(q), words)
        if variant == "full":
            on = blk1 > 0
            b1 = blk1[on].clamp(0, nblk - 1)
            sectors.append((b1, at_bounds(*bl.block_count_plain(table, b1, q[on], stride))))
            read1 = design_sectors(table, b1, u32(q)[on], words)
            read = {d: torch.unique(torch.cat([v, read1[d]])) for d, v in read.items()}
            io += L * 4
            scan += int(torch.unique(b1).numel()) * BLOCK * 4
        needed = sum(_bound_sectors(bb, at, words) for bb, at in sectors) * 32 + io
        return {"needed_bytes": needed, "scan_bytes": scan, "compares": sum(bb.shape[0] for bb, _ in sectors) * 2 * 11,
                "read_bytes": {d: int(v.numel()) * 32 + io for d, v in read.items()}}
    if kernel == "block_count_emit_docids":
        E, R, mode = case["E"], case["R"], case["mode"]
        comp, _ = pl.block_count_emit_docids_plain(table, blk, q, 0, R)
        lt, eq = pl.counts(comp)
        lt = lt.to(torch.int64)
        at = at_bounds(lt, eq)
        at = (at // R) * 2 * R + at % R  # the hash words of layout R
        p = lt[:, None] + torch.arange(E, device=blk.device)
        if mode == "slice":
            p = torch.clamp(p >> 7, max=7) * 128 + (p & 127)
        else:  # words past the block are not read
            p = torch.where(p < BLOCK, p, lt[:, None].clamp(max=BLOCK - 1))
        at = torch.cat([at, (p // R) * 2 * R + R + p % R], 1)
        io = L * 8 + L * 4 * (1 + E)
        needed = _bound_sectors(b, at, words) * 32 + io
        read = design_sectors(table, b, u32(q), words, R, E, mode)
        return {"needed_bytes": needed, "scan_bytes": scan - L * 16 + io, "compares": L * 2 * 11,
                "read_bytes": {d: int(v.numel()) * 32 + io for d, v in read.items()}}
    lt, eq = bl.block_count_plain(table, blk, q, stride)
    needed = _bound_sectors(b, at_bounds(lt, eq), words) * 32 + io
    if kernel == "block_count_emit":
        r = torch.clamp(lt.to(torch.int64) >> 7, max=7)
        rows = int(torch.unique(torch.cat([b * 8 + r, b * 8 + torch.clamp(r + 1, max=7)])).numel())
        needed += rows * 128 * 4 + L * 256 * 4
        scan += rows * 128 * 4 + L * 256 * 4
    return {"needed_bytes": needed, "scan_bytes": scan, "compares": L * 2 * 11}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_case(case):
    """Check every variant of `case` bit for bit against the plain version
    on every input set (AssertionError on the first difference); returns
    the case's record with the mean bound of one call over the sets."""
    import torch

    err, need = 0, []
    for s in case["sets"]:
        want = _tuple(case["plain"](s))
        for name, fn in case["variants"].items():
            got = _tuple(fn(s))
            if got[0].is_cuda:
                torch.cuda.synchronize()
            e = max(int((a.to(torch.int64) - w.to(torch.int64)).abs().max()) if w.numel() else 0 for a, w in zip(got, want))
            if e or len(got) != len(want) or not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise AssertionError(f"{case['kernel']}/{case['shape']}/{name} differs from the plain version (max abs err {e})")
            err = max(err, e)
        need.append(kernel_bound(case, s))
    rec = {k: case[k] for k in ("kernel", "shape", "note", "stride", "L", "table_entries", "span_counts") if k in case}
    rec["sets"], rec["max_abs_err"] = len(case["sets"]), err
    for key in ("needed_bytes", "scan_bytes", "compares"):
        rec[key] = sum(n[key] for n in need) / len(need)
    if "read_bytes" in need[0]:
        rec["read_bytes"] = {d: sum(n["read_bytes"][d] for n in need) / len(need) for d in need[0]["read_bytes"]}
    t_bytes, t_ops = rec["needed_bytes"] / HBM_BYTES_PER_S * 1e3, rec["compares"] / CUDA_CORE_OPS_PER_S * 1e3
    rec["bound_ms"], rec["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    rec["scan_bound_ms"] = rec["scan_bytes"] / HBM_BYTES_PER_S * 1e3
    return rec


def run_case(case, log=print):
    """check_case, then time every variant in turns (v1, v2, ..., v2, v1)
    over ROUNDS rounds of TURN_LAUNCHES launches, cold (cycling through the
    sets) and warm (set 0 again and again), with the SM clock and power
    draw read around each round.  Returns the case's record; a variant's
    `median_ms` is its cold time where the case has several sets."""
    import statistics

    rec = check_case(case)
    sets = case["sets"]
    names = list(case["variants"])
    order = names + names[::-1]
    modes = {"cold": sets, "warm": sets[:1]} if len(sets) > 1 else {"warm": sets}
    samples = {(k, m): [] for k in names for m in modes}
    smi_rounds, at = [], 0
    for _ in range(ROUNDS):
        before = smi("clocks.sm,power.draw")
        for m, ss in modes.items():
            for k in order:
                samples[(k, m)].append(turn_ms(case["variants"][k], ss, TURN_LAUNCHES, at))
                at += TURN_LAUNCHES
        smi_rounds.append([before, smi("clocks.sm,power.draw")])

    def stats(v):
        return {"median_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v), "samples_ms": v}

    timed = next(iter(modes))
    rec["timed"], rec["variants"] = timed, {}
    for k in names:
        rec["variants"][k] = stats(samples[(k, timed)])
        if timed == "cold":
            rec["variants"][k]["warm"] = stats(samples[(k, "warm")])
    rec["plain_ms"] = turn_ms(case["plain"], sets[:1], 5)
    rec["smi_rounds"] = smi_rounds

    def show(k):
        v = rec["variants"][k]
        warm = f", warm {v['warm']['median_ms']:.4f}" if "warm" in v else ""
        return f"{k} {v['median_ms']:.4f} ({v['min_ms']:.4f}-{v['max_ms']:.4f}){warm}"

    head = case.get("headline", "new")
    rec["headline"] = head
    new = rec["variants"][head]["median_ms"]
    log(f"kernels: {case['kernel']} ({case['shape']}: {case['note']}, stride {case['stride']}) L={case['L']} "
        f"bit-equal to plain on {len(sets)} sets; median ms over {ROUNDS}x2 turns of {TURN_LAUNCHES}, {timed}: "
        f"{'; '.join(show(k) for k in names)}; plain {rec['plain_ms']:.4f}; bound {rec['bound_ms']:.5f} ms by "
        f"{rec['bound_by']} ({rec['needed_bytes']:.0f} needed bytes; scan bytes {rec['scan_bytes']:.0f} = "
        f"{rec['scan_bound_ms']:.4f} ms) = {100 * rec['bound_ms'] / new:.1f} % of the kernel; "
        + (f"read bytes by design {json.dumps({k: round(v) for k, v in rec['read_bytes'].items()})}; " if "read_bytes" in rec else "")
        + f"clocks/power {smi_rounds[0][0]} .. {smi_rounds[-1][1]}")
    return rec


MESH_SHARDS = (1, 2, 4, 8)
MESH_ROUNDS, MESH_BATCHES, MESH_PROFILED = 4, 20, 5


def _device_ms(events, name_has: str = "") -> float:
    """Summed self time on the card (ms) of torch.profiler's averaged
    events whose key holds `name_has`."""
    import torch

    return sum(
        getattr(e, "self_device_time_total", 0) for e in events
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and name_has in e.key
    ) / 1e3


def mesh_report(dev, shards=MESH_SHARDS, log=print) -> dict:
    """The sharded program at each shard count beside the single program,
    on one 10M-doc file tier and an empty memory tier (module docstring)."""
    import torch

    from .engine.memseg import Segment
    from .engine.model import SearchOptions, SegmentInfo
    from .engine.searcher import Searcher, _pack_rows, _params_for
    from .engine.segments import tier_view_for_search
    from .ops import block_lookup as bl
    from .ops import search_kernel as sk
    from .parallel import sharded as sh
    from .parallel.serving import ShardedBatchingSearcher

    report = {"nvidia_smi": smi("name,power.limit"), "docs": N_DOCS, "batch": 256, "shards": list(shards)}
    hashes, docids = sorted_corpus(N_DOCS, dev)
    ids = np.arange(1, N_DOCS + 1, dtype=np.uint32)
    seg = Segment(SegmentInfo(commit_id=1), hashes, docids, ids, np.ones(N_DOCS, bool), 1, N_DOCS)
    del hashes, docids
    configs = {"single": Searcher(dev)}
    configs.update({f"mesh{n}": ShardedBatchingSearcher(sh.make_mesh(n, dev)) for n in shards})
    views, report["pack_s"] = {}, {}
    for name, searcher in configs.items():
        t0 = time.perf_counter()
        views[name] = SimpleNamespace(file_view=searcher.pack_file_tier([seg]), mem_view=searcher.pack_mem_tier([]))
        report["pack_s"][name] = time.perf_counter() - t0
    del seg
    log(f"mesh: packed {list(configs)} in {json.dumps({k: round(v, 1) for k, v in report['pack_s'].items()})} s")

    rng = np.random.default_rng(11)
    opts = SearchOptions(max_results=10, min_score=6, min_score_pct=10)
    params = _params_for(128)
    single = configs["single"]

    def packed_batch() -> np.ndarray:
        th = doc_hashes(rng.integers(1, N_DOCS + 1, 256, dtype=np.uint32))
        return _pack_rows(params, [single._row(*single.prepare_query(make_query(rng, h)), opts)[0] for h in th], 256)

    packs = [packed_batch() for _ in range(MESH_BATCHES)]

    def run(name, packed):
        return configs[name]._fetch(configs[name]._launch(views[name], params, packed))

    # Results first: every batch at every shard count equals the single
    # program's ids, scores and counts.
    n_res = 2 * params.out_len + 1
    want = [run("single", p)[:, :n_res] for p in packs]
    for name in configs:
        for p, w in zip(packs, want):
            got = run(name, p)[:, :n_res]
            if not np.array_equal(got, w):
                raise SystemExit(f"{name}: results differ from the single program's")
    log(f"mesh: {MESH_BATCHES} batches of 256 equal to the single program's at {list(shards)} shards")

    names = list(configs)
    rec = {name: {"wall_ms": [], "events_ms": [], "launches": None, "host_syncs": None, "branches": None} for name in names}
    for r in range(MESH_ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            searcher = configs[name]
            stream = searcher._stream
            l0, s0, b0 = dict(bl.LAUNCHES), dict(sk.STATS), dict(sh.STATS)
            marks = []
            for p in packs:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record(stream)
                handle = searcher._launch(views[name], params, p)
                end.record(stream)
                searcher._fetch(handle)
                rec[name]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                marks.append((start, end))
            torch.cuda.synchronize()
            rec[name]["events_ms"] += [a.elapsed_time(b) for a, b in marks]
            per = {k: (bl.LAUNCHES[k] - l0[k]) / MESH_BATCHES for k in ("block_count", "block_count_emit")}
            rec[name]["launches"] = per
            rec[name]["host_syncs"] = (sk.STATS["host_syncs"] - s0["host_syncs"]) / MESH_BATCHES
            rec[name]["branches"] = {k: sh.STATS[k] - b0[k] for k in sh.STATS if sh.STATS[k] != b0[k]} or {
                k: sk.STATS[k] - s0[k] for k in ("direct", "matrix", "sort") if sk.STATS[k] != s0[k]}

    for name in names:
        searcher, v = configs[name], views[name]
        f_t = tier_view_for_search(v.file_view, mentions=False)
        m_t = tier_view_for_search(v.mem_view)
        n = getattr(searcher, "n_shards", None)
        ins = [torch.from_numpy(p.view(np.int32)).to(dev) for p in packs]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            torch.cuda.synchronize()
            start.record()
            for x in ins:
                qs, lens = sk.u32(x[:, :128]), x[:, 128].to(torch.int64)
                for k in range(n or 1):
                    ft = sh._local_tier(f_t, k, n) if n else f_t
                    mt = sh._local_tier(m_t, k, n) if n else m_t
                    sk._batch_ranges(params, ft, mt, qs, lens, want_emit=True)
            end.record()
        end.synchronize()
        rec[name]["range_phase_ms_events"] = start.elapsed_time(end) / MESH_BATCHES

        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for p in packs[:MESH_PROFILED]:
                run(name, p)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        dev_ms = _device_ms(ev)
        rec[name]["profile"] = {
            "wall_ms_per_batch": wall / MESH_PROFILED,
            "device_ms_per_batch": dev_ms / MESH_PROFILED,
            "k1_ms_per_batch": _device_ms(ev, "block_count_kernel") / MESH_PROFILED,
            "k2_ms_per_batch": _device_ms(ev, "block_count_emit_kernel") / MESH_PROFILED,
            "kernels_ms_per_batch": _device_ms(ev, "block_count") / MESH_PROFILED,
            "busy_share": dev_ms / wall,
        }
        rec[name]["wall_ms_median"] = float(np.median(rec[name]["wall_ms"]))
        rec[name]["events_ms_median"] = float(np.median(rec[name]["events_ms"]))
        log(f"mesh: {name}: {json.dumps({k: v for k, v in rec[name].items() if k not in ('wall_ms', 'events_ms')})}")
    report["configs"] = rec
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="default chiprun_out/measure.json (measure_mesh.json with --mesh)")
    ap.add_argument("--mesh", default=None, help="comma-separated shard counts: time the sharded program only")
    args = ap.parse_args(argv)
    if args.mesh:
        from .utils.device import device

        dev = device()
        if dev.type != "cuda":
            raise SystemExit(f"measure needs a card; the port's device is {dev}")
        report = mesh_report(dev, [int(x) for x in args.mesh.split(",")])
        out = args.out or os.path.join("chiprun_out", "measure_mesh.json")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report), flush=True)
        return 0
    args.out = args.out or os.path.join("chiprun_out", "measure.json")

    import torch

    from .engine.memseg import Segment
    from .engine.model import SearchOptions, SegmentInfo
    from .engine.searcher import Searcher, _pack_rows, _params_for
    from .engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier, tier_view_for_search
    from .ops import block_lookup as bl
    from .ops import search_kernel as sk
    from .ops.layout import to_storage, u32
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

    # The kernels alone at the main path's shapes, on the packed tier, with
    # the designs K1 and K2 did not take beside them.
    qpool = torch.stack([u32(torch.from_numpy(packed_batch(256).view(np.int32)).to(dev)[:, :128]).reshape(-1)
                         for _ in range(QUERY_SETS)])
    g = torch.Generator(device=dev).manual_seed(3)
    mem = to_storage(sorted_table(MEM_TIER_CAP, MEM_TIER_LIVE, g, dev))
    n_live = int(snap.file_view["seg_len"].sum())
    report["kernels"] = [run_case(c) for c in main_path_cases(inter, n_live, qpool, mem, g, designs=True)]
    del mem
    torch.cuda.empty_cache()
    report["kernels"] += [run_case(c) for c in phase1_cases(dev, g, designs=True)]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

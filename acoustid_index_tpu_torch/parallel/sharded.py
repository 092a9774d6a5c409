"""Hash-range sharded search and ingest (counterpart of
acoustid_index_tpu/parallel/sharded.py).

The reference's layout and semantics, unchanged:

  * postings are sharded by HASH RANGE (shard k owns hashes in
    [bounds[k], bounds[k+1])), so every query hash has one home shard;
  * mention tables are sharded by DOCID RANGE, so a candidate doc's
    supersession lookup has one home shard too;
  * a query goes to every shard; each shard finds and gathers its hit
    postings locally; the per-shard hit lists are joined in shard order
    (the reference's tiled all_gather) and scored once, by the single-card
    scoring stages, so scores are exact; per-shard supersession answers
    combine with a max, the statistics with a sum or a max.

What changed in the port, and why:
  * the mesh is N shards as slices of ONE device (`Mesh`).  NCCL does not
    put two ranks on one card, and the reference tests its own mesh as
    virtual devices of one process.  The packed device fields ship flat,
    (n_shards * X,) as in the reference, and shard k's local tier is a
    VIEW of them (`_local_tier`): no copy per batch;
  * the collectives are plain tensor operations over the shards' tensors,
    in shard order 0..n-1: all_gather(axis=1, tiled) is `torch.cat(.., 1)`,
    pmax a max and psum a sum.  Scoring the joined stream once replaces
    scoring it identically on every shard;
  * `lax.cond` on pmax'd predicates is a host-side branch: each stage's
    predicates of ALL shards come to the host in one transfer (`_host`),
    so a batch makes at most two host syncs at any shard count, as the
    single path does (ops/search_kernel.py);
  * each shard's range phase runs the port's kernels (K1, K2) through the
    single path's `_batch_ranges`, with its path decisions per shard.
`STATS` counts the branches each batch took.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.memseg import Segment
from ..engine.segments import Snapshot, _bucket, filter_superseded, tier_from_numpy
from ..ops.layout import BLOCK, interleave_np, resident_max_bytes, u32, use_interleaved
from ..ops.search_kernel import (
    F_DIRECT,
    P_MEM_DIRECT,
    P_SMALL,
    TIER_MEM,
    SearchParams,
    _batch_ranges,
    _direct_candidates,
    _final_select,
    _final_select_matrix,
    _host,
    _newest_gate,
    _newest_lookup,
    _plan_and_gather,
    _score_matrix,
    _score_rank,
    _tier_blocks,
    _values,
    pack_outputs,
    small_budget,
)

MATRIX_MAX = 1024  # widest joined stream scored sort-free (the reference's)

# Per-process counts of the sharded program: batches, the path each took
# (direct with a live memory tier or without, P_SMALL gather, full-budget
# gather) and the scorer of the joined stream (equality matrix up to
# MATRIX_MAX wide, else the sort).  Host syncs count in
# ops/search_kernel.STATS["host_syncs"].
STATS = {"batches": 0, "direct_wide": 0, "direct_narrow": 0, "small": 0, "full": 0,
         "select_matrix": 0, "select_sorted": 0}
_stats_lock = threading.Lock()


def _count(*keys: str) -> None:
    with _stats_lock:
        for k in keys:
            STATS[k] += 1


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `n_shards` shards, all slices of `device`."""

    n_shards: int
    device: torch.device


def make_mesh(n_shards: Optional[int] = None, device=None) -> Mesh:
    """`n_shards` shards (default 1) on `device` (default utils.device.device())."""
    if device is None:
        from ..utils.device import device as default_device

        device = default_device()
    n = int(n_shards or 1)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return Mesh(n, torch.device(device))


def hash_bounds(n_shards: int) -> np.ndarray:
    """Shard k owns hashes in [bounds[k], bounds[k+1])."""
    return np.array([(k * (1 << 32)) // n_shards for k in range(n_shards + 1)], dtype=np.uint64)


@dataclass
class ShardedView:
    """Both tiers packed per shard: device fields flat (n_shards * X,) on
    the mesh's device, docs_* bookkeeping host-side numpy (n_shards, X)."""

    file_tier: Dict
    mem_tier: Dict
    n_shards: int


def _pack_tier_sharded(
    segments: Sequence[Segment],
    n_shards: int,
    slots: int,
    min_cap: int = 1024,
    min_caps: Optional[Tuple[int, int, int]] = None,
) -> Dict[str, np.ndarray]:
    """The reference's packing, line for line, as numpy: partition each
    segment's postings by hash range and its docs by docid range, and pack
    per shard (slot k = ordinal k).  Supersession within the tier is
    filtered GLOBALLY first (pack_tier's rule), so a shard's run never holds
    a posting another shard's mention entry would have killed; each shard
    then holds ONE merged hash-sorted run, and mention tables stay
    membership-only."""
    bounds = hash_bounds(n_shards)
    per_shard_items: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    per_shard_ids: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    per_shard_docs: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    per_shard_alive: List[List[np.ndarray]] = [[] for _ in range(n_shards)]

    if len(segments) > slots:
        raise ValueError(f"too many segments for tier: {len(segments)} > {slots}")

    live_items = filter_superseded(segments)
    for s_idx, seg in enumerate(segments):
        hashes, docids = live_items[s_idx]
        cuts = np.searchsorted(hashes.astype(np.uint64), bounds)
        dcuts = np.searchsorted(seg.docs_ids.astype(np.uint64), bounds)
        for k in range(n_shards):
            per_shard_items[k].append(hashes[cuts[k] : cuts[k + 1]])
            per_shard_ids[k].append(docids[cuts[k] : cuts[k + 1]])
            per_shard_docs[k].append(seg.docs_ids[dcuts[k] : dcuts[k + 1]])
            per_shard_alive[k].append(seg.docs_alive[dcuts[k] : dcuts[k + 1]].astype(np.int32))

    def total(chunks):
        return sum(a.shape[0] for a in chunks)

    cmin, dmin, mmin = min_caps or (min_cap, min_cap, min_cap)
    dcap = _bucket(max((total(chunks) for chunks in per_shard_docs), default=1), dmin)
    mention = [
        np.unique(np.concatenate(per_shard_docs[k])) if per_shard_docs[k] else np.empty(0, np.uint32)
        for k in range(n_shards)
    ]
    mcap = _bucket(max((m.shape[0] for m in mention), default=1), mmin)
    cap = _bucket(
        max((-(-total(chunks) // BLOCK) * BLOCK for chunks in per_shard_items), default=1),
        max(cmin, BLOCK),
    )

    S = slots
    out = {
        "hashes": np.full((n_shards, cap), 0xFFFFFFFF, np.uint32),
        "docids": np.full((n_shards, cap), 0xFFFFFFFF, np.uint32),
        "seg_start": np.zeros((n_shards, S), np.int32),
        "seg_len": np.zeros((n_shards, S), np.int32),
        "docs_ids": np.full((n_shards, dcap), 0xFFFFFFFF, np.uint32),
        "docs_alive": np.zeros((n_shards, dcap), np.int32),
        "docs_start": np.zeros((n_shards, S), np.int32),
        "docs_len": np.zeros((n_shards, S), np.int32),
        "mention_ids": np.full((n_shards, mcap), 0xFFFFFFFF, np.uint32),
        "mention_len": np.zeros((n_shards,), np.int32),
        "block_index": np.full((n_shards, cap // BLOCK), 0xFFFFFFFF, np.uint32),
    }
    for k, mi in enumerate(mention):
        out["mention_ids"][k, : mi.shape[0]] = mi
        out["mention_len"][k] = mi.shape[0]
    for k in range(n_shards):
        pos = 0
        for s_idx, a in enumerate(per_shard_items[k]):
            out["seg_start"][k, s_idx] = pos
            out["seg_len"][k, s_idx] = a.shape[0]
            pos += a.shape[0]
        if any(a.shape[0] for a in per_shard_items[k]):
            all_h = np.concatenate(per_shard_items[k])
            all_d = np.concatenate(per_shard_ids[k])
            if sum(1 for a in per_shard_items[k] if a.shape[0]) > 1:
                order = np.argsort(all_h, kind="stable")  # ties stay segment-asc
                all_h, all_d = all_h[order], all_d[order]
            out["hashes"][k, : all_h.shape[0]] = all_h
            out["docids"][k, : all_d.shape[0]] = all_d
        dpos = 0
        for s_idx, a in enumerate(per_shard_docs[k]):
            out["docs_start"][k, s_idx] = dpos
            out["docs_len"][k, s_idx] = a.shape[0]
            out["docs_ids"][k, dpos : dpos + a.shape[0]] = a
            out["docs_alive"][k, dpos : dpos + a.shape[0]] = per_shard_alive[k][s_idx]
            dpos += a.shape[0]
        out["block_index"][k] = out["hashes"][k, ::BLOCK]

    # Per-shard interleave decision, as pack_tier decides for one tier: the
    # shard's slice is what its range phase reads.
    if use_interleaved(cap, resident_max_bytes()):
        inter = np.empty((n_shards, 2 * cap), np.uint32)
        for k in range(n_shards):
            inter[k] = interleave_np(out["hashes"][k], out["docids"][k])
        out["inter"] = inter
        del out["hashes"], out["docids"]

    # Device fields ship FLAT (n_shards * X,); mention_len stays (n_shards,).
    for k in SHARDED_DEVICE_FIELDS:
        if k in out and k != "mention_len":
            out[k] = np.ascontiguousarray(out[k]).reshape(-1)
    return out


# Fields the sharded program reads on the device; everything else in a
# packed tier is host-side bookkeeping.
SHARDED_DEVICE_FIELDS = (
    "hashes",
    "docids",
    "inter",
    "block_index",
    "seg_start",
    "seg_len",
    "mention_ids",
    "mention_len",
)


def _device_fields(tier: Dict) -> Dict:
    return {k: tier[k] for k in SHARDED_DEVICE_FIELDS if k in tier}


def put_sharded(tier_np: Dict, mesh: Mesh, mentions: bool = True) -> Dict:
    """Place a packed sharded tier: search fields as tensors on the mesh's
    device (u32 as int32 storage), docs_* bookkeeping host-side numpy.
    `mentions=False` keeps the mention table host-side (the file tier: the
    search never reads it)."""
    return tier_from_numpy(tier_np, mesh.device, mentions=mentions)


def build_sharded_view(
    snapshot: Snapshot,
    mesh: Mesh,
    file_slots: int = 16,
    mem_slots: int = 8,
    min_cap: int = 1024,
) -> ShardedView:
    n = mesh.n_shards
    file_np = _pack_tier_sharded(snapshot.file, n, file_slots, min_cap)
    mem_np = _pack_tier_sharded(snapshot.memory, n, mem_slots, min_cap)
    return ShardedView(
        file_tier=put_sharded(file_np, mesh, mentions=False),
        mem_tier=put_sharded(mem_np, mesh),
        n_shards=n,
    )


def search_tiers(view: ShardedView) -> Tuple[Dict, Dict]:
    """The (file, mem) device fields the sharded program takes; the file
    tier's mention table is not consulted (supersession only asks the
    memory tier), as tier_view_for_search(..., mentions=False)."""
    f = {k: v for k, v in _device_fields(view.file_tier).items() if not k.startswith("mention")}
    return f, _device_fields(view.mem_tier)


def _local_tier(tier: Dict, k: int, n: int) -> Dict:
    """Shard k's tier: a view of each flat field's k-th block (no copy),
    and its own mention_len."""
    out = {}
    for key, v in tier.items():
        if key == "mention_len":
            out[key] = v[k]
        else:
            size = v.shape[0] // n
            out[key] = v[k * size : (k + 1) * size]
    return out


def _sharded_batch_impl(p: SearchParams, n: int, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """(B, Q) batch over n shards: the reference's shard body, branch for
    branch, with every branch decided on the host from all shards'
    predicates at once."""
    B = queries.shape[0]
    dev = queries.device
    f_loc = [_local_tier(file_tier, k, n) for k in range(n)]
    m_loc = [_local_tier(mem_tier, k, n) for k in range(n)]

    # Range phase per shard, whole batch at once; the emitting lookup feeds
    # the direct path.
    want_emit = "inter" in file_tier and p.query_len <= 256
    f_lo, f_cnt, m_lo, m_cnt, r_trunc, emit = map(list, zip(*(
        _batch_ranges(p, f_loc[k], m_loc[k], queries, q_lens, want_emit=want_emit) for k in range(n)
    )))

    def pmax(xs):
        return torch.stack(xs).amax(0)

    # Global predicates (the reference's pmax'd ones), one host sync.
    has_mem = pmax([c.sum() for c in m_cnt]) > 0
    mem_mentions_any = mem_tier["mention_len"].amax() > 0
    false = torch.zeros((), dtype=torch.bool, device=dev)
    # candidate_cap against n * P_SMALL, not P_SMALL: the sorted ranker's
    # top C must fit the joined P_SMALL hit lists of every shard.
    small_ok = p.postings_budget > P_SMALL and p.candidate_cap <= n * P_SMALL
    small = false
    if small_ok:
        p_small = dataclasses.replace(p, postings_budget=P_SMALL)
        small = pmax([small_budget(p, f_cnt[k], m_cnt[k], B)[1].amax() for k in range(n)]) <= P_SMALL
    direct_ok = false
    if want_emit:
        E_direct = 2 if p.query_len <= 128 else 1
        ov_tot = [torch.clamp(f_cnt[k] - torch.where(emit[k][1], E_direct, 0), min=0).sum(1).amax() for k in range(n)]
        m_tot = [m_cnt[k].sum(1).amax() for k in range(n)]
        direct_ok = (pmax(ov_tot) <= F_DIRECT) & (pmax(m_tot) <= P_MEM_DIRECT)
    has_mem, mem_mentions_any, small, direct_ok = _host(has_mem, mem_mentions_any, small, direct_ok)

    def combined_newest(d_flat, mask_flat):
        # Each candidate doc has one docid-range home shard; every shard
        # answers from its own table behind its own gate (the flag is
        # global, the range test local), and a max combines the answers.
        # All shards' gates reach the host in one sync.
        newest = torch.full_like(d_flat, -1)
        if not mem_mentions_any:
            return newest
        live = _host(*(_newest_gate(m_loc[k], d_flat, mask_flat, True) for k in range(n)))
        for k in range(n):
            if live[k]:
                newest = torch.maximum(newest, _newest_lookup(m_loc[k], d_flat, mask_flat))
        return newest

    def select_any(p_eff, d, o, inv):
        """Stages 3-7 on the joined stream: the equality matrix while it
        is at most MATRIX_MAX wide (the width is static), else the sort.
        Returns (out, the sort's candidate-cap overflow or None)."""
        if d.shape[1] <= MATRIX_MAX:
            _count("select_matrix")
            win, score, cand = _score_matrix(p, d, o, inv, min_scores)
            newest = combined_newest(d.reshape(-1), cand.reshape(-1)).reshape(d.shape)
            return _final_select_matrix(p, d, score, win, cand, newest, limits, min_scores, pcts), None
        _count("select_sorted")
        cd, co, csc, c_valid, c_over = _score_rank(p_eff, d, o, inv, min_scores)
        newest = combined_newest(cd.reshape(-1), c_valid.reshape(-1)).reshape(cd.shape)
        return _final_select(p, cd, co, csc, c_valid, newest, limits, min_scores, pcts), c_over

    def joined(parts):
        return torch.cat(parts, 1)  # the tiled all_gather, in shard order

    if direct_ok:
        # Gather-free file-tier candidates per shard from the emitted rows;
        # with a live memory tier (global has_mem) its postings ride along
        # through a P_MEM_DIRECT gather.  A hash lives on one shard, so the
        # joined direct streams are the single-card stream of the union.
        _count("batches", "direct_wide" if has_mem else "direct_narrow")
        p_mem = dataclasses.replace(p, postings_budget=P_MEM_DIRECT)
        ds, os_, invs, totals = [], [], [], []
        for k in range(n):
            rows, covered = emit[k]
            d_f, inv_f, tot_f = _direct_candidates(p, f_loc[k], rows, covered, f_lo[k], f_cnt[k], E_direct)
            if has_mem:
                d_m, _o, inv_m, tot_m, _over = _plan_and_gather(
                    p_mem, f_loc[k], m_loc[k], f_lo[k], torch.zeros_like(m_cnt[k]), m_lo[k], m_cnt[k],
                    use_mem=True, use_file=False,
                )
                ds.append(torch.cat([d_f, d_m], 1))
                invs.append(torch.cat([inv_f, inv_m], 1))
                os_.append(torch.cat([torch.zeros_like(d_f), torch.full_like(d_m, TIER_MEM)], 1))
                totals.append(tot_f + tot_m)
            else:
                ds.append(d_f)
                invs.append(inv_f)
                os_.append(torch.zeros_like(d_f))
                totals.append(tot_f)
        out, c_over = select_any(p, joined(ds), joined(os_), joined(invs))
        overs = []
    else:
        # Per-shard plan+gather at P_SMALL or at the full budget.
        p_eff = p_small if (small_ok and small) else p
        _count("batches", "small" if p_eff is not p else "full")
        ds, os_, invs, totals, overs = map(list, zip(*(
            _plan_and_gather(p_eff, f_loc[k], m_loc[k], f_lo[k], f_cnt[k], m_lo[k], m_cnt[k], use_mem=has_mem)
            for k in range(n)
        )))
        out, c_over = select_any(p_eff, joined(ds), joined(os_), joined(invs))

    truncated = torch.stack(r_trunc).any().expand(B)
    for x in overs + ([c_over] if c_over is not None else []):
        truncated = truncated | x
    out["postings_scanned"] = torch.stack(totals).sum(0)  # psum
    out["truncated"] = truncated
    # A hash's postings live on one shard, so the max of the local maxima
    # is the global one (pmax).
    out["max_per_hash"] = pmax([(f_cnt[k] + m_cnt[k]).amax(1) for k in range(n)])
    out["max_blocks_per_hash"] = pmax(
        [(_tier_blocks(f_lo[k], f_cnt[k]) + _tier_blocks(m_lo[k], m_cnt[k])).amax(1) for k in range(n)]
    )
    return out


@torch.inference_mode()
def sharded_search_batch(params: SearchParams, mesh: Mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """(B, Q) batched hash-range-sharded search, the serving program: the
    tiers are search_tiers' flat fields; queries (B, Q) and the (B,)
    scalars are tensors, arrays or values.  Returns the single path's
    output dict of (B, ...) tensors."""
    dev = mesh.device
    return _sharded_batch_impl(
        params, mesh.n_shards, file_tier, mem_tier,
        *(_values(x, dev) for x in (queries, q_lens, limits, min_scores, pcts)),
    )


def sharded_search(
    params: SearchParams,
    mesh: Mesh,
    view: ShardedView,
    query: np.ndarray,
    q_len: int,
    limit: int,
    min_score: int,
    pct: int,
):
    """Single-query wrapper over the batched program (tests, dryrun)."""
    f_t, m_t = search_tiers(view)
    out = sharded_search_batch(
        params, mesh, f_t, m_t,
        np.asarray(query, np.uint32)[None, :],
        *(np.full((1,), v, np.int64) for v in (q_len, limit, min_score, pct)),
    )
    return {k: v[0] for k, v in out.items()}


def sharded_search_batch_packed(params: SearchParams, mesh: Mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """sharded_search_batch with its outputs packed into one tensor (one
    device->host copy per batch; see search_kernel.pack_outputs)."""
    return pack_outputs(sharded_search_batch(params, mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts))


@torch.inference_mode()
def sharded_search_batch_packed_io(params: SearchParams, mesh: Mesh, file_tier, mem_tier, packed_in):
    """The sharded counterpart of search_segments_batch_packed_io: the
    int32 view of pack_inputs_np's array on the mesh's device in, the
    packed outputs out."""
    Q = params.query_len
    qs = u32(packed_in[:, :Q])
    lens, limits, min_scores, pcts = (packed_in[:, Q + k].to(torch.int64) for k in range(4))
    return pack_outputs(_sharded_batch_impl(params, mesh.n_shards, file_tier, mem_tier, qs, lens, limits, min_scores, pcts))


def sharded_ingest_step(mesh: Mesh, batch_hashes: np.ndarray, batch_ids: np.ndarray):
    """Partition an ingest batch by hash range on the host, sort each
    shard's (hash, docid) pairs on the mesh's device (ops/build.sort_postings),
    and return the stacked sorted runs: two (n_shards, cap) int32 tensors of
    u32 patterns, SENTINEL behind each shard's pairs (the building block of
    a distributed segment build)."""
    from ..ops.build import sort_postings

    n = mesh.n_shards
    bounds = hash_bounds(n)
    order = np.argsort(batch_hashes.astype(np.uint64), kind="stable")
    h_sorted = batch_hashes[order]
    i_sorted = batch_ids[order]
    cuts = np.searchsorted(h_sorted.astype(np.uint64), bounds)
    cap = _bucket(max(int(np.max(np.diff(cuts))), 1), 1024)
    h = np.full((n, cap), 0xFFFFFFFF, np.uint32)
    i = np.full((n, cap), 0xFFFFFFFF, np.uint32)
    for k in range(n):
        h[k, : cuts[k + 1] - cuts[k]] = h_sorted[cuts[k] : cuts[k + 1]]
        i[k, : cuts[k + 1] - cuts[k]] = i_sorted[cuts[k] : cuts[k + 1]]
    h_t = torch.from_numpy(h.view(np.int32)).to(mesh.device)
    i_t = torch.from_numpy(i.view(np.int32)).to(mesh.device)
    runs = [sort_postings(h_t[k], i_t[k], int(cuts[k + 1] - cuts[k])) for k in range(n)]
    return torch.stack([r[0] for r in runs]), torch.stack([r[1] for r in runs])

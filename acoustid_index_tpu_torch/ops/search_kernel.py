"""The batched search program (counterpart of acoustid_index_tpu/ops/search_kernel.py).

Same semantics as the reference, stage for stage (its module docstring
states them): per query hash find its run in each tier's merged sorted
postings, count one hit per posting, let the newest tier with a hit win
each doc, drop docs a newer tier mentions, rank by (score desc, id asc),
cut by min_score and the pct of the best survivor, return the top `limit`.

What changed in the port, and why:
  * the range phase runs the hand-written kernels of ops/block_lookup.py;
    the scoring tail (candidates, scoring, supersession, ranking) is plain
    PyTorch, as it was plain XLA in the reference;
  * `vmap` is an explicit batch dimension;
  * the one-hot float matmul extractions (a TPU device for integer
    gathers) are integer gathers and scatters, so no float ever holds an id;
  * `lax.cond` is a host-side branch: the batch's branch predicates
    (direct_ok, small, has_mem) come to the host in ONE transfer, and the
    supersession gate of _batch_newest in one more -- at most two host syncs
    per batch, counted in STATS["host_syncs"];
  * tensors hold u32 values as int64 (torch has no unsigned compare); tier
    tables stay int32 storage of the u32 bit patterns.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import bump, counters, trace
from .binsearch import lower_bound, upper_bound
from .block_lookup import (
    BLOCK,
    mention_lookup_blocked,
    tier_ranges_blocked,
    tier_ranges_resident,
)
from .layout import docid_gather, postings_cap, resident_max_bytes, to_storage, u32

SENTINEL = 0xFFFFFFFF
TIER_FILE = 0
TIER_MEM = 1
ORD_INVALID = 2

P_SMALL = 256  # fast-path postings budget
F_DIRECT = 16  # fallback gather slots per query on the direct path
P_MEM_DIRECT = 64  # memory-tier gather slots per query on the direct path

# Per-process counts: which branch each batch took, and host syncs spent
# on branch predicates.  Tests and chip_smoke.py read deltas.  They live in
# the span and counter registry (utils/profiling) as `search.<key>`, whose
# lock guards them: the native front's pumps launch concurrently.
STATS = counters("search", {"direct": 0, "matrix": 0, "sort": 0, "host_syncs": 0})


def _count(key: str) -> None:
    bump(STATS, key)


@dataclass(frozen=True)
class SearchParams:
    """Static configuration of one search program (shapes and budgets)."""

    query_len: int = 256  # padded query hashes
    postings_budget: int = 16384  # P: max postings gathered per query
    per_hash_cap: int = 1024  # K: max postings per (hash, tier)
    candidate_cap: int = 1024  # C: max candidates ranked (sort path)
    out_len: int = 128  # padded results


def _host(*preds):
    """Fetch device predicates in one transfer (one host sync): the span
    `program.sync` is the time the launching thread waits on the card."""
    _count("host_syncs")
    with trace("program.sync"):
        return [bool(v) for v in torch.stack([torch.as_tensor(p) for p in preds]).tolist()]


def _tier_n_items(tier):
    return tier["seg_len"].sum().to(torch.int64)


def _tier_ranges(tier, queries, valid_q, cap_k):
    """(lo, counts, trunc) of each query hash's run by binary search over
    the live prefix of the tier's merged run."""
    assert "hashes" in tier, "interleaved tiers always take the blocked path"
    n_items = _tier_n_items(tier)
    lo = lower_bound(tier["hashes"], queries, 0, n_items)
    hi = upper_bound(tier["hashes"], queries, 0, n_items)
    counts = torch.where(valid_q, hi - lo, 0)
    return lo, torch.clamp(counts, max=cap_k), (counts > cap_k).any()


def _plan_and_gather(p: SearchParams, file_tier, mem_tier, f_lo, f_counts, m_lo, m_counts, use_mem=True, use_file=True):
    """Stage 2, batched: the (B, Q) run ranges of both tiers expanded into
    each query's first P postings.  Returns (d, o, invalid, total, over),
    each (B, P) or (B,)."""
    B, Q = f_lo.shape
    P = p.postings_budget
    dev = f_lo.device
    flat_counts = torch.cat([f_counts, m_counts], 1)
    flat_lo = torch.cat([f_lo, m_lo], 1)
    cum = torch.cumsum(flat_counts, 1)
    grand_total = cum[:, -1]
    total = torch.clamp(grand_total, max=P)

    pos = torch.arange(P, device=dev).expand(B, P).contiguous()
    j = torch.clamp(torch.searchsorted(cum, pos, right=True), 0, 2 * Q - 1)
    within = pos - (cum.gather(1, j) - flat_counts.gather(1, j))
    src = flat_lo.gather(1, j) + within
    p_valid = pos < total[:, None]

    is_mem = j >= Q
    if use_file:
        f_vals = docid_gather(file_tier, torch.clamp(src, 0, postings_cap(file_tier) - 1))
    if use_mem:
        m_vals = docid_gather(mem_tier, torch.clamp(src, 0, postings_cap(mem_tier) - 1))
    if use_file and use_mem:
        vals = torch.where(is_mem, m_vals, f_vals)
        ords = torch.where(is_mem, TIER_MEM, TIER_FILE)
    elif use_file:
        vals, ords = f_vals, torch.full_like(f_vals, TIER_FILE)
    else:
        vals, ords = m_vals, torch.full_like(m_vals, TIER_MEM)
    d = torch.where(p_valid, vals, SENTINEL)
    o = torch.where(p_valid, ords, ORD_INVALID)
    return d, o, ~p_valid, total, grand_total > P


def _batch_ranges(p: SearchParams, file_tier, mem_tier, queries, q_lens, want_emit: bool = False):
    """Stage 1: per-tier (B, Q) run ranges, each tier by the path its
    static shape selects (the reference's decisions, unchanged)."""
    Q, K = p.query_len, p.per_hash_cap
    B = queries.shape[0]
    valid_q = torch.arange(Q, device=queries.device)[None, :] < q_lens[:, None]

    outs = []
    emit_info = None
    for tier in (file_tier, mem_tier):
        cap = postings_cap(tier)
        if "inter" in tier:
            if want_emit and tier is file_tier:
                lo, cnt, tr, rows, covered = tier_ranges_blocked(tier, queries, valid_q, K, emit=True)
                emit_info = (rows, covered)
                outs.append((lo, cnt, tr))
            else:
                outs.append(tier_ranges_blocked(tier, queries, valid_q, K))
        elif cap <= 4096 and B * Q * cap <= (1 << 28):
            # The reference's _tier_ranges_dense (a dense compare summed on
            # the MXU); over a sorted run that count is the searchsorted rank.
            outs.append(_tier_ranges(tier, queries, valid_q, K))
        elif cap % BLOCK == 0 and cap * 4 <= resident_max_bytes():
            outs.append(tier_ranges_resident(tier, queries, valid_q, K))
        elif "block_index" in tier and cap >= 64 * BLOCK:
            outs.append(tier_ranges_blocked(tier, queries, valid_q, K))
        else:
            outs.append(_tier_ranges(tier, queries, valid_q, K))
    (f_lo, f_cnt, f_tr), (m_lo, m_cnt, m_tr) = outs
    return f_lo, f_cnt, m_lo, m_cnt, f_tr | m_tr, emit_info


def tier_mentions(tier, cand_ids):
    """Bool: the tier's sorted mention table holds each candidate."""
    ids = tier["mention_ids"]
    cap = ids.shape[0]
    mention_len = tier["mention_len"].to(torch.int64)
    lo = lower_bound(ids, cand_ids, 0, mention_len)
    return (lo < mention_len) & (u32(ids[torch.clamp(lo, 0, cap - 1)]) == cand_ids)


def _score_rank(p: SearchParams, d, o, inv, min_score):
    """Stages 3-4, batched: sort by docid, run-length score with the newest
    tier winning, rank (score desc, id asc), keep the top C."""
    B, P = d.shape
    C = p.candidate_cap
    dev = d.device
    key = torch.where(inv, SENTINEL, (d - 1) & 0xFFFFFFFF)
    key, order = torch.sort(key, dim=1, stable=True)
    o = o.gather(1, order)
    p_valid = key != SENTINEL

    key_prev = torch.cat([torch.zeros_like(key[:, :1]), key[:, :-1]], 1)
    first = torch.arange(P, device=dev) == 0
    grp_start = first | (key != key_prev)
    gid = torch.cumsum(grp_start.to(torch.int64), 1) - 1
    max_o = torch.full((B, P), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, gid, torch.where(p_valid, o, -1), "amax"
    )
    o_win = max_o.gather(1, gid)
    is_win = p_valid & (o == o_win)
    grp_score = torch.zeros((B, P), dtype=torch.int64, device=dev).scatter_add(1, gid, is_win.to(torch.int64))
    score = grp_score.gather(1, gid)

    key_next = torch.cat([key[:, 1:], torch.zeros_like(key[:, :1])], 1)
    last_pos = torch.arange(P, device=dev) == P - 1
    doc_last = p_valid & (last_pos | (key != key_next))
    d = torch.where(p_valid, key + 1, SENTINEL)
    cand = doc_last & (score >= min_score[:, None])

    # Rank by (score desc, id asc) as one int64 key: (P - score) in the high
    # word, non-candidates after every candidate (P + 1 > any P - score).
    rank_hi = torch.where(cand, P - score, P + 1)
    _, order = torch.sort((rank_hi << 32) | d, dim=1, stable=True)
    order = order[:, :C]
    rk = rank_hi.gather(1, order)
    cd, co = d.gather(1, order), o_win.gather(1, order)
    c_valid = rk != P + 1
    csc = torch.where(c_valid, P - rk, 0)
    c_over = cand.sum(1) > C
    return cd, co, csc, c_valid, c_over


def _final_select(p: SearchParams, cd, co, csc, c_valid, newest, limits, min_scores, pcts):
    """Stages 5-7, batched, given each candidate's newest mention tier."""
    B, C = cd.shape
    dev = cd.device
    alive = c_valid & ~(newest > co)
    best = torch.where(alive, csc, 0).amax(1)
    cutoff = torch.maximum(min_scores, best * pcts // 100)
    rank = torch.cumsum(alive.to(torch.int64), 1) - 1
    limit_eff = torch.clamp(limits, max=p.out_len)
    keep = alive & (csc >= cutoff[:, None]) & (rank < limit_eff[:, None])

    # Kept candidates to the front, in their (already ranked) order.
    order = torch.argsort((~keep).to(torch.int64) * C + torch.arange(C, device=dev), dim=1)
    out_ids = cd.gather(1, order)[:, : p.out_len]
    out_scores = csc.gather(1, order)[:, : p.out_len]
    n = keep.sum(1)
    mask = torch.arange(p.out_len, device=dev)[None, :] < n[:, None]
    return {"ids": torch.where(mask, out_ids, 0), "scores": torch.where(mask, out_scores, 0), "count": n}


def _newest_gate(mem_tier, cand_flat, valid_flat, mem_mentions_any=None):
    """0-d bool on the device: the mention lookup can find anything, i.e.
    the memory tier mentions some doc and a valid candidate lies inside
    [ids[0], ids[len-1]] of its sorted table.  Sharded callers pass the
    GLOBAL `mem_mentions_any` (a host bool); the range test stays against
    this (local) table, which is all its lookup could find.  An empty table
    reads sentinels for lo and hi, and then only a candidate 0xFFFFFFFF
    passes the range test; its lookup answers "not mentioned" all the same."""
    ids = mem_tier["mention_ids"]
    mention_len = mem_tier["mention_len"].to(torch.int64)
    lo = u32(ids[0])
    hi = u32(ids.index_select(0, torch.clamp(mention_len - 1, min=0).reshape(1)))[0]
    in_range = (cand_flat >= lo) & (cand_flat <= hi)
    any_in_range = (in_range & valid_flat).any()
    if mem_mentions_any is None:
        return (mention_len > 0) & any_in_range
    return any_in_range & bool(mem_mentions_any)


def _batch_newest(mem_tier, cand_flat, valid_flat):
    """Newest mention tier of each candidate: TIER_MEM where the memory
    tier mentions it, -1 otherwise.  Skipped (exactly) when the gate
    (_newest_gate) is shut; one host sync for the gate."""
    (live,) = _host(_newest_gate(mem_tier, cand_flat, valid_flat))
    if not live:
        return torch.full_like(cand_flat, -1)
    return _newest_lookup(mem_tier, cand_flat, valid_flat)


def _newest_lookup(mem_tier, cand_flat, valid_flat):
    """_batch_newest's lookup, with its gate open."""
    ids = mem_tier["mention_ids"]
    cap = ids.shape[0]
    if cap % BLOCK == 0 and cap > 4096:
        found = mention_lookup_blocked(mem_tier, cand_flat, valid_flat)
    else:
        # The reference picks a dense compare or a binary search here by
        # size; over a sorted unique table both answer membership exactly.
        found = tier_mentions(mem_tier, cand_flat)
    return torch.where(found, TIER_MEM, -1)


def small_budget(p: SearchParams, f_cnt, m_cnt, B: int):
    """(p_small, per-query rough totals) for the P_SMALL fast-path rule."""
    p_small = dataclasses.replace(p, postings_budget=P_SMALL)
    totals_rough = f_cnt.reshape(B, -1).sum(1) + m_cnt.reshape(B, -1).sum(1)
    return p_small, totals_rough


def _direct_candidates(p: SearchParams, file_tier, rows, covered, f_lo, f_cnt, lanes_per_hash: int):
    """Gather-free file-tier candidates: each hash's first `lanes_per_hash`
    docids from the emitted landing-block rows, plus ONE compacted fallback
    gather of F_DIRECT positions per query for the remainder (long and
    straddling runs).  Returns (d (B, E*Q+F), invalid, totals (B,))."""
    B, Q = f_lo.shape
    E = lanes_per_hash
    dev = f_lo.device
    rowsf = rows.reshape(B * Q, 256)  # docid rows r and r+1, back to back
    off = (f_lo.reshape(-1) % 128)[:, None]
    cnt_f = f_cnt.reshape(-1)
    cov = covered.reshape(-1)
    lanes_d, lanes_ok = [], []
    for e in range(E):
        # Lane off+e of row r, or lane off+e-128 of row r+1: flat index off+e.
        lanes_d.append(u32(rowsf.gather(1, off + e)).reshape(B, Q))
        lanes_ok.append((cov & (cnt_f > e)).reshape(B, Q))

    start = torch.where(covered, E, 0)
    ov = torch.clamp(f_cnt - start, min=0)
    cum = torch.cumsum(ov, 1)
    total_ov = cum[:, -1]
    fpos = torch.arange(F_DIRECT, device=dev).expand(B, F_DIRECT).contiguous()
    jsel = torch.searchsorted(cum, fpos, right=True)  # owning hash of each slot
    in_q = jsel < Q
    jc = torch.clamp(jsel, max=Q - 1)

    def pick(x):
        return torch.where(in_q, x.gather(1, jc), 0)

    src = pick(f_lo) + fpos - pick(cum - ov) + pick(start)
    f_ok = fpos < torch.clamp(total_ov, max=F_DIRECT)[:, None]
    srcc = torch.clamp(torch.where(f_ok, src, 0), 0, postings_cap(file_tier) - 1)
    fvals = docid_gather(file_tier, srcc)

    d = torch.cat(lanes_d + [fvals], 1)
    ok = torch.cat(lanes_ok + [f_ok], 1)
    return torch.where(ok, d, SENTINEL), ~ok, f_cnt.sum(1)


def _score_matrix(p: SearchParams, d, o, inv, min_score):
    """Stages 3-4 sort-free, batched: a (W, W) same-doc matrix per query
    gives each doc's winning tier (row max), its score (hits carrying the
    winner) and its first occurrence (the candidate row)."""
    B, W = d.shape
    valid = ~inv
    eq = (d[:, :, None] == d[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    o_b = torch.where(valid, o, -1).to(torch.int8)
    win = torch.where(eq, o_b[:, None, :], -1).amax(2).to(torch.int64)
    score = (eq & (o_b[:, None, :] == win[:, :, None])).sum(2)
    pos = torch.arange(W, device=d.device)
    dup_before = (eq & (pos[None, :] < pos[:, None])).any(2)
    cand = valid & ~dup_before & (score >= min_score[:, None])
    return win, score, cand


def _rank_extract(p: SearchParams, d, score, keep, limits):
    """Rank kept candidates by (score desc, id asc) by counting, and
    scatter them into their output slots."""
    B, W = d.shape
    hi = torch.where(keep, W - score, SENTINEL)
    less = (hi[:, None, :] < hi[:, :, None]) | ((hi[:, None, :] == hi[:, :, None]) & (d[:, None, :] < d[:, :, None]))
    rank = (less & keep[:, None, :]).sum(2)
    limit_eff = torch.clamp(limits, max=p.out_len)
    final = keep & (rank < limit_eff[:, None])
    slot = torch.where(final, rank, p.out_len)  # non-final -> dropped column

    def place(v):
        out = torch.zeros((B, p.out_len + 1), dtype=torch.int64, device=d.device)
        return out.scatter_(1, slot, torch.where(final, v, 0))[:, : p.out_len]

    return {"ids": place(d), "scores": place(score), "count": final.sum(1)}


def _final_select_matrix(p: SearchParams, d, score, win, cand, newest, limits, min_scores, pcts):
    """Stages 5-7 sort-free: supersession kill, pct cutoff anchored on the
    best survivor, ranked extraction."""
    alive = cand & ~(newest > win)
    best = torch.where(alive, score, 0).amax(1)
    cutoff = torch.maximum(min_scores, best * pcts // 100)
    keep = alive & (score >= cutoff[:, None])
    return _rank_extract(p, d, score, keep, limits)


def _tier_blocks(lo, cnt):
    """BLOCKs each (B, Q) run [lo, lo + cnt) spans (0 for an empty run)."""
    hi = lo + torch.clamp(cnt, min=1) - 1
    return torch.where(cnt > 0, hi // BLOCK - lo // BLOCK + 1, 0)


def _search_batch_impl(p: SearchParams, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """(B, Q) batch: one range phase for the whole batch, then the direct,
    matrix or sort branch, chosen on the host exactly as the reference's
    lax.cond cascade chooses.  Each stage is a span of the registry
    (utils/profiling): program.range, program.branch, program.gather,
    program.rank, program.mention, program.select -- the host's time to
    enqueue it, and the host syncs (program.sync) inside it."""
    B = queries.shape[0]
    want_emit = "inter" in file_tier and p.query_len <= 256
    with trace("program.range"):
        f_lo, f_cnt, m_lo, m_cnt, trunc, emit_info = _batch_ranges(
            p, file_tier, mem_tier, queries, q_lens, want_emit=want_emit
        )

    with trace("program.branch"):
        has_mem = m_cnt.sum() > 0
        small_ok = p.postings_budget > P_SMALL and p.candidate_cap <= P_SMALL
        small = torch.zeros((), dtype=torch.bool, device=queries.device)
        if small_ok:
            p_small, totals_rough = small_budget(p, f_cnt, m_cnt, B)
            small = totals_rough.max() <= P_SMALL
        direct_ok = torch.zeros((), dtype=torch.bool, device=queries.device)
        if emit_info is not None:
            rows, covered = emit_info
            E_direct = 2 if p.query_len <= 128 else 1
            ov_tot = torch.clamp(f_cnt - torch.where(covered, E_direct, 0), min=0).sum(1)
            m_tot = m_cnt.sum(1)
            direct_ok = (ov_tot.max() <= F_DIRECT) & (m_tot.max() <= P_MEM_DIRECT)
        has_mem, small, direct_ok = _host(has_mem, small, direct_ok)

        # Per-query load-skew signals: max postings of one hash (both tiers)
        # and max blocks one hash's run spans.
        max_per_hash = (f_cnt + m_cnt).amax(1)
        max_blocks_per_hash = (_tier_blocks(f_lo, f_cnt) + _tier_blocks(m_lo, m_cnt)).amax(1)

    def finish(res, totals, tr):
        res["postings_scanned"] = totals
        res["truncated"] = tr
        res["max_per_hash"] = max_per_hash
        res["max_blocks_per_hash"] = max_blocks_per_hash
        return res

    if direct_ok:
        _count("direct")
        with trace("program.gather"):
            d_f, inv_f, totals_f = _direct_candidates(p, file_tier, rows, covered, f_lo, f_cnt, E_direct)
            if has_mem:
                # Mem-live batch: append the memory-tier postings (<= P_MEM_DIRECT).
                p_mem = dataclasses.replace(p, postings_budget=P_MEM_DIRECT)
                d_m, _o, inv_m, totals_m, _over = _plan_and_gather(
                    p_mem, file_tier, mem_tier, f_lo, torch.zeros_like(m_cnt), m_lo, m_cnt,
                    use_mem=True, use_file=False,
                )
                d = torch.cat([d_f, d_m], 1)
                inv = torch.cat([inv_f, inv_m], 1)
                o = torch.cat([torch.zeros_like(d_f), torch.full_like(d_m, TIER_MEM)], 1)
                totals = totals_f + totals_m
            else:
                d, inv, o, totals = d_f, inv_f, torch.zeros_like(d_f), totals_f
        with trace("program.rank"):
            win, score, cand = _score_matrix(p, d, o, inv, min_scores)
        with trace("program.mention"):
            newest = _batch_newest(mem_tier, d.reshape(-1), cand.reshape(-1)).reshape(d.shape)
        with trace("program.select"):
            res = _final_select_matrix(p, d, score, win, cand, newest, limits, min_scores, pcts)
            return finish(res, totals, trunc.expand(B))

    if small_ok and small:
        _count("matrix")
        with trace("program.gather"):
            d, o, inv, totals, overs = _plan_and_gather(
                p_small, file_tier, mem_tier, f_lo, f_cnt, m_lo, m_cnt, use_mem=has_mem
            )
        with trace("program.rank"):
            win, score, cand = _score_matrix(p_small, d, o, inv, min_scores)
        with trace("program.mention"):
            newest = _batch_newest(mem_tier, d.reshape(-1), cand.reshape(-1)).reshape(d.shape)
        with trace("program.select"):
            res = _final_select_matrix(p, d, score, win, cand, newest, limits, min_scores, pcts)
            return finish(res, totals, trunc | overs)

    _count("sort")
    with trace("program.gather"):
        d, o, inv, totals, overs = _plan_and_gather(p, file_tier, mem_tier, f_lo, f_cnt, m_lo, m_cnt, use_mem=has_mem)
    with trace("program.rank"):
        cd, co, csc, c_valid, c_over = _score_rank(p, d, o, inv, min_scores)
    with trace("program.mention"):
        newest = _batch_newest(mem_tier, cd.reshape(-1), c_valid.reshape(-1)).reshape(cd.shape)
    with trace("program.select"):
        res = _final_select(p, cd, co, csc, c_valid, newest, limits, min_scores, pcts)
        return finish(res, totals, trunc | overs | c_over)


def _tier_device(tier) -> torch.device:
    return next(v.device for v in tier.values() if isinstance(v, torch.Tensor))


def _values(x, dev) -> torch.Tensor:
    """u32 or non-negative int values (tensor, array or scalar; int32
    storage included) -> int64 values on `dev`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
    return u32(x.to(dev))


@torch.inference_mode()
def search_segments_batch(params: SearchParams, file_tier, mem_tier, query, q_len, limit, min_score, pct):
    """Batched search: query (B, Q) and q_len/limit/min_score/pct (B,) carry
    a leading batch dimension; the tables are shared.  Returns the output
    dict of (B, ...) tensors on the tiers' device."""
    dev = _tier_device(file_tier)
    return _search_batch_impl(params, file_tier, mem_tier, *(_values(x, dev) for x in (query, q_len, limit, min_score, pct)))


def _search_one(p: SearchParams, file_tier, mem_tier, query, q_len, limit, min_score, pct):
    """Single-query search (query (Q,), scalars): a batch of one."""
    dev = _tier_device(file_tier)
    scalars = (_values(x, dev).reshape(1) for x in (q_len, limit, min_score, pct))
    out = search_segments_batch(p, file_tier, mem_tier, _values(query, dev)[None, :], *scalars)
    return {k: v[0] for k, v in out.items()}


# The reference's jitted single-query entry; nothing is compiled here.
search_segments = _search_one


def pack_outputs(out) -> torch.Tensor:
    """The output dict as ONE (B, 2*out_len + 5) int32 tensor of u32 bit
    patterns: ids | scores | count | postings_scanned | truncated |
    max_per_hash | max_blocks_per_hash (one device->host copy per batch)."""
    cols = [
        out["ids"],
        out["scores"],
        out["count"][:, None],
        out["postings_scanned"][:, None],
        out["truncated"].to(torch.int64)[:, None],
        out["max_per_hash"][:, None],
        out["max_blocks_per_hash"][:, None],
    ]
    return to_storage(torch.cat([c.to(torch.int64) for c in cols], 1))


def unpack_outputs_np(arr, out_len: int):
    """Host-side inverse of pack_outputs (arr: numpy (B, 2*out_len+5) u32)."""
    return {
        "ids": arr[:, :out_len],
        "scores": arr[:, out_len : 2 * out_len],
        "count": arr[:, 2 * out_len],
        "postings_scanned": arr[:, 2 * out_len + 1],
        "truncated": arr[:, 2 * out_len + 2],
        "max_per_hash": arr[:, 2 * out_len + 3],
        "max_blocks_per_hash": arr[:, 2 * out_len + 4],
    }


def pack_inputs_np(qs, lens, limits, min_scores, pcts):
    """Host-side: one (B, Q+4) u32 array = queries | len | limit | min_score
    | pct.  Cross into torch with `.view(np.int32)`."""
    return np.concatenate(
        [
            qs,
            lens[:, None].astype(np.uint32),
            limits[:, None].astype(np.uint32),
            min_scores[:, None].astype(np.uint32),
            pcts[:, None].astype(np.uint32),
        ],
        axis=1,
    )


def unpack_inputs(params: SearchParams, packed_in):
    """(queries, q_lens, limits, min_scores, pcts) as int64 values from the
    int32 view of pack_inputs_np's array."""
    Q = params.query_len
    # The reference reads the scalar columns as int32 (astype): the signed
    # view of the storage.
    return (u32(packed_in[:, :Q]), *(packed_in[:, Q + k].to(torch.int64) for k in range(4)))


@torch.inference_mode()
def search_segments_batch_packed_io(params: SearchParams, file_tier, mem_tier, packed_in):
    """Batched search with both sides packed: `packed_in` is the int32 view
    of pack_inputs_np's array on the tiers' device; returns pack_outputs."""
    return pack_outputs(_search_batch_impl(params, file_tier, mem_tier, *unpack_inputs(params, packed_in)))

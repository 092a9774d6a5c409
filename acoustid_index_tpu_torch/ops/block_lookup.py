"""Two-level postings lookup (counterpart of acoustid_index_tpu/ops/pallas_lookup.py).

A query hash finds its run in a tier's merged sorted postings in two steps:
a search of the sampled top index (one hash per 1024-posting block) names
the landing block, and a block kernel counts `lt`/`eq` of the query inside
it.  Runs that straddle a block boundary get one extra single-block count
of the previous block, appended to the same lookup stream as a compacted
tail (see tier_ranges_blocked).

Three CUDA kernels (csrc/block_lookup.cu) serve the contracts of all five
of the reference's Pallas kernels:

    K1  block_count         <- block_lookup, block_lookup_wave,
                               block_lookup_resident (unmasked)
    K1m block_count_masked  <- block_lookup_resident (masked: lo_b, hi_b)
    K2  block_count_emit    <- block_lookup_emit, block_lookup_emit_wave

K1 and K2 search the block (one thread per lookup, a binary search to
each bound), so they are exact only on blocks that are non-decreasing as
u32: every table this module hands them is (merged tier postings with
their 0xFFFFFFFF padding, top indexes, mention tables).  K1m keeps the
whole-block scan, as its tables may concatenate sorted runs.
`block_count_scan` and `block_count_emit_scan` are K1's and K2's first,
scanning designs, kept so that a run can time both designs on one card;
nothing here calls them.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on a card; there is no other fallback.
The plain versions count over the whole block, so they hold for any block;
with `CHECK_SORTED` set, K1's and K2's wrappers first check the search's
precondition on the CPU.  `LAUNCHES` counts kernel launches per wrapper, so
a run can show that its path went through the kernels.

The kernels read queries as int32 bit patterns.  The range phase below
converts a batch's int64 query values once per call (`to_storage`, one
cast) and hands every K1/K2 call of that call the int32 copy.
"""

from __future__ import annotations

import os

import torch

from ..utils.profiling import bump, counters
from .binsearch import upper_bound
from .layout import BLOCK, resident_max_bytes, to_storage, u32

ROWS = BLOCK // 128
# Launches by kernel, in the span and counter registry (utils/profiling) as
# `launches.<kernel>`; several native-front pumps launch at once.
LAUNCHES = counters("launches", {
    "block_count": 0,
    "block_count_masked": 0,
    "block_count_emit": 0,
    "block_count_scan": 0,
    "block_count_emit_scan": 0,
    # K3-K5 (ops/probe_lookup.py, csrc/probe_lookup.cu): the probes' kernels
    "block_count_pair": 0,
    "block_count_emit_docids": 0,
    "block_count_staged": 0,
})

# Test hook: when true, the wrappers of the searching kernels (K1, K2 here,
# K3, K4 in probe_lookup.py) check on the CPU that every block they look
# into is non-decreasing as u32 -- the precondition of the kernels' search,
# which the card does not check and the plain versions do not need -- and
# raise if one is not.  The tests that drive the serving path set it, so a
# caller that hands K1/K2 an unsorted table fails there.
CHECK_SORTED = False

# Lookups per chunk of the plain versions: (chunk, 1024) widened to int64
# is 64 MB, small enough for the card at serving sizes.
_PLAIN_CHUNK = 8192


def _check(table, blk, q, stride):
    if table.dim() != 1 or table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 1-D int32 tensor")
    if table.shape[0] % (stride * BLOCK):
        raise ValueError(f"table length {table.shape[0]} is not a multiple of {stride * BLOCK}")
    if blk.shape != q.shape or blk.dim() != 1:
        raise ValueError("blk and q must be 1-D and of equal length")
    if blk.device != table.device or q.device != table.device:
        raise ValueError("table, blk and q must be on one device")


def _cuda_args(table, blk, q):
    """Contiguous int32 blk / u32-pattern q on the table's card."""
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned for the vector loads")
    blk = blk.to(torch.int32).contiguous()
    q = (q if q.dtype == torch.int32 else to_storage(q.to(torch.int64))).contiguous()
    return blk, q


def _check_sorted(name, table, blk, stride, R: int = BLOCK):
    """Raise unless every block that `blk` names is non-decreasing as u32
    (at stride 2 its hashes: the first of each pair of R-word runs)."""
    nblk = table.shape[0] // (stride * BLOCK)
    b = torch.unique(blk.to(torch.int64).clamp(0, nblk - 1))
    h = u32(table.view(nblk, BLOCK // R, stride, R)[b, :, 0].reshape(-1, BLOCK))
    bad = (h[:, 1:] < h[:, :-1]).any(1)
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: block {int(b[bad][0])} of a {table.shape[0]}-entry table is not "
            "non-decreasing as u32; the kernel's search would miscount it"
        )


def _launched(rc: int, name: str) -> None:
    """Count one launch of kernel `name`, then raise if it was refused."""
    bump(LAUNCHES, name)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _on_card(t):
    """The launch context of a kernel on t's card: that card current for
    the launch (the runtime launches on the calling thread's current
    device, and a pump or dispatcher thread may have another one current),
    so the stream passed is the caller's current stream of t's card."""
    return torch.cuda.device(t.device)


def block_count_plain(table, blk, q, stride: int = 1):
    """Plain PyTorch version of K1: (lt, eq) int32 per lookup."""
    nblk = table.shape[0] // (stride * BLOCK)
    t2 = table.view(nblk, stride * BLOCK)
    q = u32(q)
    blk = blk.to(torch.int64).clamp(0, nblk - 1)
    lts, eqs = [], []
    for s in range(0, blk.shape[0], _PLAIN_CHUNK):
        h = u32(t2[blk[s : s + _PLAIN_CHUNK], :BLOCK])
        qq = q[s : s + _PLAIN_CHUNK, None]
        lts.append((h < qq).sum(1, dtype=torch.int32))
        eqs.append((h == qq).sum(1, dtype=torch.int32))
    if not lts:
        e = torch.zeros(0, dtype=torch.int32, device=table.device)
        return e, e.clone()
    return torch.cat(lts), torch.cat(eqs)


def _launch_count(name, table, blk, q, stride):
    """(lt, eq) from the library's K1-shaped kernel aitpu_<name>."""
    from . import _build

    blk, q = _cuda_args(table, blk, q)
    L = blk.shape[0]
    lt = torch.empty(L, dtype=torch.int32, device=table.device)
    eq = torch.empty(L, dtype=torch.int32, device=table.device)
    with _on_card(table):
        rc = getattr(_build.library(), "aitpu_" + name)(
            table.data_ptr(), blk.data_ptr(), q.data_ptr(), lt.data_ptr(), eq.data_ptr(),
            L, table.shape[0] // (stride * BLOCK), stride, torch.cuda.current_stream(table.device).cuda_stream,
        )
    _launched(rc, name)
    return lt, eq


def block_count(table, blk, q, stride: int = 1):
    """K1: (lt, eq) int32 of q[j] in block blk[j] of `table` (u32 patterns
    in int32 storage; `stride` 2 reads the hash half of interleaved
    blocks).  q holds u32 values as int64, or bit patterns as int32.  On a
    card every block must be non-decreasing as u32: the kernel searches it
    (lt = its lower bound of q, eq = upper bound - lt)."""
    _check(table, blk, q, stride)
    if table.device.type == "cpu":
        if CHECK_SORTED:
            _check_sorted("block_count", table, blk, stride)
        return block_count_plain(table, blk, q, stride)
    return _launch_count("block_count", table, blk, q, stride)


def block_count_scan(table, blk, q, stride: int = 1):
    """K1's first design, kept for comparison on the card: the same
    (lt, eq), counted over the whole block (any block, sorted or not)."""
    _check(table, blk, q, stride)
    if table.device.type == "cpu":
        return block_count_plain(table, blk, q, stride)
    return _launch_count("block_count_scan", table, blk, q, stride)


def block_count_masked_plain(table, blk, q, lo_b, hi_b):
    """Plain PyTorch version of K1m: K1 at stride 1 counting only entries
    whose absolute index blk*BLOCK + i lies in [lo_b[j], hi_b[j])."""
    nblk = table.shape[0] // BLOCK
    t2 = table.view(nblk, BLOCK)
    q = u32(q)
    blk = blk.to(torch.int64).clamp(0, nblk - 1)
    lo_b, hi_b = lo_b.to(torch.int64), hi_b.to(torch.int64)
    ar = torch.arange(BLOCK, device=table.device)
    lts, eqs = [], []
    for s in range(0, blk.shape[0], _PLAIN_CHUNK):
        b = blk[s : s + _PLAIN_CHUNK]
        e = b[:, None] * BLOCK + ar
        m = (e >= lo_b[s : s + _PLAIN_CHUNK, None]) & (e < hi_b[s : s + _PLAIN_CHUNK, None])
        h = u32(t2[b])
        qq = q[s : s + _PLAIN_CHUNK, None]
        lts.append(((h < qq) & m).sum(1, dtype=torch.int32))
        eqs.append(((h == qq) & m).sum(1, dtype=torch.int32))
    if not lts:
        e = torch.zeros(0, dtype=torch.int32, device=table.device)
        return e, e.clone()
    return torch.cat(lts), torch.cat(eqs)


def block_count_masked(table, blk, q, lo_b, hi_b):
    """K1m: (lt, eq) int32 of q[j] in block blk[j] of `table` (stride 1),
    counting only absolute entries in [lo_b[j], hi_b[j]) (int32 bounds).
    Its tables may concatenate sorted runs, so a block need not be sorted:
    the kernel scans the whole block."""
    _check(table, blk, q, 1)
    if lo_b.shape != blk.shape or hi_b.shape != blk.shape:
        raise ValueError("lo_b and hi_b must match blk's shape")
    if lo_b.device != table.device or hi_b.device != table.device:
        raise ValueError("table, lo_b and hi_b must be on one device")
    if table.device.type == "cpu":
        return block_count_masked_plain(table, blk, q, lo_b, hi_b)
    from . import _build

    blk, q = _cuda_args(table, blk, q)
    lo_b = lo_b.to(torch.int32).contiguous()
    hi_b = hi_b.to(torch.int32).contiguous()
    L = blk.shape[0]
    lt = torch.empty(L, dtype=torch.int32, device=table.device)
    eq = torch.empty(L, dtype=torch.int32, device=table.device)
    with _on_card(table):
        rc = _build.library().aitpu_block_count_masked(
            table.data_ptr(), blk.data_ptr(), q.data_ptr(), lo_b.data_ptr(), hi_b.data_ptr(),
            lt.data_ptr(), eq.data_ptr(), L, table.shape[0] // BLOCK, torch.cuda.current_stream(table.device).cuda_stream,
        )
    _launched(rc, "block_count_masked")
    return lt, eq


def block_count_emit_plain(inter, blk, q):
    """Plain PyTorch version of K2: (lt, eq, rows (L, 2, 128) int32)."""
    nblk = inter.shape[0] // (2 * BLOCK)
    t2 = inter.view(nblk, 2 * BLOCK)
    q = u32(q)
    blk = blk.to(torch.int64).clamp(0, nblk - 1)
    lts, eqs, rows = [], [], []
    for s in range(0, blk.shape[0], _PLAIN_CHUNK):
        tile = t2[blk[s : s + _PLAIN_CHUNK]]
        h = u32(tile[:, :BLOCK])
        qq = q[s : s + _PLAIN_CHUNK, None]
        lt = (h < qq).sum(1, dtype=torch.int32)
        lts.append(lt)
        eqs.append((h == qq).sum(1, dtype=torch.int32))
        dd = tile[:, BLOCK:].view(-1, ROWS, 128)
        r = torch.clamp(lt.to(torch.int64) >> 7, max=ROWS - 1)
        r2 = torch.clamp(r + 1, max=ROWS - 1)
        ar = torch.arange(dd.shape[0], device=inter.device)
        rows.append(torch.stack([dd[ar, r], dd[ar, r2]], dim=1))
    if not lts:
        e = torch.zeros(0, dtype=torch.int32, device=inter.device)
        return e, e.clone(), torch.zeros((0, 2, 128), dtype=torch.int32, device=inter.device)
    return torch.cat(lts), torch.cat(eqs), torch.cat(rows)


def _launch_emit(name, inter, blk, q):
    """(lt, eq, rows) from the library's K2-shaped kernel aitpu_<name>."""
    from . import _build

    blk, q = _cuda_args(inter, blk, q)
    L = blk.shape[0]
    lt = torch.empty(L, dtype=torch.int32, device=inter.device)
    eq = torch.empty(L, dtype=torch.int32, device=inter.device)
    rows = torch.empty((L, 2, 128), dtype=torch.int32, device=inter.device)
    with _on_card(inter):
        rc = getattr(_build.library(), "aitpu_" + name)(
            inter.data_ptr(), blk.data_ptr(), q.data_ptr(), lt.data_ptr(), eq.data_ptr(),
            rows.data_ptr(), L, inter.shape[0] // (2 * BLOCK), torch.cuda.current_stream(inter.device).cuda_stream,
        )
    _launched(rc, name)
    return lt, eq, rows


def block_count_emit(inter, blk, q):
    """K2: K1 at stride 2 over the interleaved layout, plus each lookup's
    docid rows r = min(lt >> 7, 7) and min(r + 1, 7) of its block as
    rows[j] (2, 128), u32 patterns in int32 storage.  On a card every
    block's hashes must be non-decreasing as u32 (the kernel searches)."""
    _check(inter, blk, q, 2)
    if inter.device.type == "cpu":
        if CHECK_SORTED:
            _check_sorted("block_count_emit", inter, blk, 2)
        return block_count_emit_plain(inter, blk, q)
    return _launch_emit("block_count_emit", inter, blk, q)


def block_count_emit_scan(inter, blk, q):
    """K2's first design, kept for comparison on the card: the same
    (lt, eq, rows), counted over the whole block (any block)."""
    _check(inter, blk, q, 2)
    if inter.device.type == "cpu":
        return block_count_emit_plain(inter, blk, q)
    return _launch_emit("block_count_emit_scan", inter, blk, q)


# ---- the reference's kernel entry points, same names and return contracts ----


def block_lookup(hashes, blk, queries, stride: int = 1):
    """(lo, cnt): lo = blk*BLOCK + lt (int64), cnt = eq (int32), by K1.
    Precondition (unlike the reference's scan): every block that `blk`
    names is non-decreasing as u32; on a card an unsorted block gives
    wrong counts, unchecked."""
    lt, eq = block_count(hashes, blk, queries, stride)
    return blk.to(torch.int64) * BLOCK + lt, eq


block_lookup_wave = block_lookup  # the reference's explicit-DMA twin: same contract


def block_lookup_emit(inter, blk, queries):
    """(lo, cnt, rows (L, 2, 128)) over the interleaved layout, by K2.
    Precondition: each looked-up block's hashes are non-decreasing as u32
    (unchecked on a card, as for block_lookup)."""
    lt, eq, rows = block_count_emit(inter, blk, queries)
    return blk.to(torch.int64) * BLOCK + lt, eq, rows


block_lookup_emit_wave = block_lookup_emit


def block_lookup_resident(hashes, blk, queries, lo_b=None, hi_b=None):
    """(lt, eq) of each query in 1024-entry chunk blk of a small table (the
    reference's VMEM-resident kernel; on the card K1, which requires every
    looked-up chunk non-decreasing as u32, unchecked, as for block_lookup).
    With `lo_b`/`hi_b` (per-lookup absolute entry bounds) only entries in
    [lo_b, hi_b) count: the reference's masked mode, K1m on the card, which
    scans and so takes any chunk."""
    if lo_b is None:
        return block_count(hashes, blk, queries, stride=1)
    return block_count_masked(hashes, blk, queries, lo_b, hi_b)


# ---- range phase ----


def _n_items(tier) -> torch.Tensor:
    return tier["seg_len"].sum().to(torch.int64)


def _landing_chunk(mini, q):
    """Index of the last sampled entry <= q (the reference's dense
    compare-sum over a sorted mini index), clipped to [0, len-1]."""
    ub2 = torch.searchsorted(mini, q, right=True)
    return torch.clamp(ub2 - 1, 0, mini.shape[0] - 1)


def tier_ranges_resident(tier, queries, valid_q, cap_k):
    """Range phase for a mid-size plain tier: the landing chunk c from the
    mini index, then two K1 lookups per query (chunks c-1 and c) bound its
    run.  Runs longer than the two-chunk window truncate with the flag."""
    B, Q = queries.shape
    assert "hashes" in tier, "interleaved tiers always take the blocked path"
    hp = tier["hashes"]
    n_items = _n_items(tier)
    qf = queries.reshape(-1)
    q32 = to_storage(qf)  # the kernels' query format, made once

    mini = u32(hp[::BLOCK])
    c = _landing_chunk(mini, qf)
    c0 = torch.clamp(c - 1, min=0)
    lt2, eq2 = block_lookup_resident(hp, torch.cat([c0, c]), torch.cat([q32, q32]))
    L = qf.shape[0]
    lt_b, eq_b = lt2[:L].to(torch.int64), eq2[:L].to(torch.int64)
    lt_c, eq_c = lt2[L:].to(torch.int64), eq2[L:].to(torch.int64)

    has_below = (eq_b > 0) & (c > 0)
    lo = torch.where(has_below, c0 * BLOCK + lt_b, c * BLOCK + lt_c)
    cnt = torch.where(has_below, eq_b + eq_c, eq_c)
    spill = has_below & (c0 > 0) & (mini[c0] == qf)

    live = valid_q.reshape(-1) & (n_items > 0)
    lo = torch.minimum(torch.clamp(lo, min=0), n_items)
    cnt = torch.minimum(cnt, n_items - lo)
    cnt = torch.where(live, cnt, 0)
    kcap = min(cap_k, 2 * BLOCK)
    cnt = torch.clamp(cnt, max=kcap)
    truncated = ((cnt >= kcap) & live).any() | (spill & live).any()
    return lo.reshape(B, Q), cnt.reshape(B, Q), truncated


def tier_ranges_blocked(tier, queries, valid_q, cap_k, emit: bool = False):
    """Two-level range phase over the tier's merged sorted postings.

    `queries` (int64 u32 values) and `valid_q` are (B, Q); returns (lo,
    cnt, truncated) with (B, Q) int64 lo/cnt and a 0-d bool, or with
    `emit` (interleaved tiers only) (lo, cnt, truncated, rows (B*Q, 2, 128),
    covered (B, Q)).  Semantics are the reference's, step for step."""
    B, Q = queries.shape
    block_index = tier["block_index"]
    nblk = block_index.shape[0]
    if "inter" in tier:
        postings, stride = tier["inter"], 2
    else:
        assert not emit, "emit requires the interleaved layout"
        postings, stride = tier["hashes"], 1
    n_items = _n_items(tier)
    blk_last = torch.clamp((n_items - 1) // BLOCK, min=0)
    dev = queries.device

    # Stage 1: landing block from the top index.  `blk` is the LAST block
    # whose first hash is <= q; the run can reach back one block exactly
    # when that first hash == q.
    qf = queries.reshape(-1)
    q32 = to_storage(qf)  # the kernels' query format, made once for both stages
    nblk_pad = -(-nblk // BLOCK) * BLOCK
    bi = block_index
    if nblk_pad != nblk:
        pad = torch.full((nblk_pad - nblk,), -1, dtype=torch.int32, device=dev)  # 0xFFFFFFFF
        bi = torch.cat([bi, pad])
    c = _landing_chunk(u32(bi[::BLOCK]), qf)
    if nblk_pad * 4 <= resident_max_bytes():
        lt_c, cnt_c = block_lookup_resident(bi, c, q32)
        ub = c * BLOCK + lt_c + cnt_c
    else:
        lo_c, cnt_c = block_lookup(bi, c, q32)
        ub = lo_c + cnt_c
    ub = ub.reshape(B, Q)
    eq_top = cnt_c.to(torch.int64).reshape(B, Q)
    blk = torch.clamp(torch.minimum(torch.clamp(ub - 1, min=0), blk_last), 0, nblk - 1)

    step_back = (eq_top > 0) & (blk > 0)
    b0 = torch.where(step_back, blk - 1, blk)
    b1 = torch.clamp(b0 + 1, max=nblk - 1)
    enabled = step_back & (b1 <= blk_last) & (b1 != b0)
    spill = (step_back & (b0 > 0)) & ((eq_top >= 2) | ((ub - 1) % BLOCK == 0))

    live = valid_q & (n_items > 0)
    b0 = torch.where(live, b0, 0)

    # Stage 2: the landing-block stream plus a compacted tail of w_cap
    # previous-block lookups for the straddlers (one stream, one launch).
    L = qf.shape[0]
    window = (live & (step_back | enabled)).reshape(-1)
    blk_main = torch.where(live, blk, 0).reshape(-1)

    w_cap = min(max(int(os.environ.get("AITPU_WINDOW_CAP", "2048")), L // 16), L)
    r = torch.cumsum(window.to(torch.int64), 0) - 1
    slot = torch.where(window & (r < w_cap), r, w_cap)
    sel = torch.zeros(w_cap + 1, dtype=torch.int64, device=dev)
    sel.scatter_(0, slot, torch.arange(L, device=dev))
    sel = sel[:w_cap]
    n_w = window.sum()
    valid_w = torch.arange(w_cap, device=dev) < n_w
    fb0 = torch.where(valid_w, b0.reshape(-1)[sel], 0)
    fq = torch.where(valid_w, q32[sel], 0)

    ext_blk = torch.cat([blk_main, fb0])
    ext_q = torch.cat([q32, fq])
    rows = None
    if emit:
        lo_all, cnt_all, rows_all = block_lookup_emit(postings, ext_blk, ext_q)
        rows = rows_all[:L]
    else:
        lo_all, cnt_all = block_lookup(postings, ext_blk, ext_q, stride=stride)
    cnt_all = cnt_all.to(torch.int64)
    lo_flat, cnt_flat = lo_all[:L], cnt_all[:L]

    # Straddlers: lo from the previous-block scan, cnt = both blocks' eq.
    lo_fix = lo_all[L : L + w_cap]
    cnt_fix = cnt_all[L : L + w_cap] + cnt_flat[torch.clamp(sel, 0, L - 1)]
    tgt = torch.where(valid_w, sel, L)  # dead slots land on a dropped column
    lo_flat = torch.cat([lo_flat, lo_flat.new_zeros(1)]).scatter_(0, tgt, lo_fix)[:L]
    cnt_flat = torch.cat([cnt_flat, cnt_flat.new_zeros(1)]).scatter_(0, tgt, cnt_fix)[:L]
    w_over = n_w > w_cap

    lo = lo_flat.reshape(B, Q)
    cnt = cnt_flat.reshape(B, Q)
    lo = torch.minimum(torch.clamp(lo, min=0), n_items)
    cnt = torch.minimum(cnt, n_items - lo)
    cnt = torch.where(valid_q, cnt, 0)
    kcap = min(cap_k, 2 * BLOCK)
    cnt = torch.clamp(cnt, max=kcap)
    truncated = ((cnt >= kcap) & live).any() | (spill & live).any() | w_over
    if emit:
        covered = live & ~window.reshape(B, Q)
        return lo, cnt, truncated, rows, covered
    return lo, cnt, truncated


def _pad_to_block(a):
    """Sentinel-pad to a BLOCK multiple; always a contiguous copy (the
    kernels take contiguous tables, and callers pass strided samples)."""
    n = a.shape[0]
    pad = torch.full((-(-n // BLOCK) * BLOCK - n,), -1, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def mention_lookup_blocked(tier, cand_flat, valid=None):
    """Bool: the tier's mention table holds each candidate doc (ids are
    unique, so a lookup never straddles)."""
    ids = tier["mention_ids"]
    cap = ids.shape[0]
    mention_len = tier["mention_len"].to(torch.int64)
    cand32 = to_storage(cand_flat)  # the kernels' query format, made once
    if cap % BLOCK == 0 and cap * 4 <= resident_max_bytes():
        c = _landing_chunk(u32(ids[::BLOCK]), cand_flat)
        lt, eq = block_lookup_resident(ids, c, cand32)
        lo = c * BLOCK + lt
        return (eq > 0) & (lo < mention_len)

    top = _pad_to_block(ids[::BLOCK])
    nblk = cap // BLOCK
    if top.shape[0] * 4 <= resident_max_bytes():
        c = _landing_chunk(u32(top[::BLOCK]), cand_flat)
        lt_c, eq_c = block_lookup_resident(top, c, cand32)
        ub = c * BLOCK + lt_c + eq_c
    else:
        ub = upper_bound(top, cand_flat, 0, nblk)
    blk = torch.clamp(ub - 1, 0, nblk - 1)
    if valid is not None:
        blk = torch.where(valid, blk, 0)
    lo, cnt = block_lookup(ids, blk, cand32)
    return (cnt > 0) & (lo < mention_len)

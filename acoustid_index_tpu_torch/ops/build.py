"""Device-side term-table construction and segment merging (counterpart of
acoustid_index_tpu/ops/build.py).

  * `sort_postings` -- sort an ingest batch's (hash, docid) pairs; the basis
    of a new term table.
  * `merge_postings_live` -- merge a packed run of segments into one,
    dropping postings of docs that a newer segment in the run mentions (the
    merger's skip_docs rule) and collapsing the per-segment mentioned-doc
    maps to newest-wins (tombstones are kept, as the host merger keeps them).

What changed in the port, and why:
  * the reference pads every input to a bucketed capacity and sorts the
    padding too, so that XLA compiles a handful of programs; here the
    callers hand over exactly the live entries (engine/device_merge packs
    no padding), and padded inputs are still answered exactly;
  * each `lax.sort` over several keys is one `torch.sort` over ONE int64 key
    that orders as the key tuple.  u32 values sit in a signed word biased by
    2^31, so that 0xFFFFFFFF still sorts last;
  * the reference's leading `inv` key (invalid rows last) would cost a bit
    above the id.  Invalid rows carry the SENTINEL id, so they tie only with
    a VALID id 0xFFFFFFFF (engine/model.py allows it); where the payload of
    such a tie differs, the validity bit sits just below the id, so the
    valid row still sorts first;
  * the second docs sort of the reference only compacts rows that are
    already in id order; here that is a cumsum scatter;
  * a merge of 2^30 postings must fit the card beside its inputs: the
    postings pass runs MERGE_CHUNK postings at a time into one int64 key
    column, and past SORT_PART postings the sort runs in key-range parts
    of about SORT_PART keys each (ranges cut at sampled quantiles; the
    dropped rows, which all hold the largest key, are filled in behind
    them), so the peak stays a few times the key column's bytes instead of
    ~15 times.  Each part costs one host sync.
Tables are int32 storage of u32 bit patterns (ops/layout.py); counts come
back as 0-d int64 tensors, with no host sync below SORT_PART postings.
"""

from __future__ import annotations

import torch

from .binsearch import lower_bound
from .layout import to_storage, u32

SENTINEL = 0xFFFFFFFF
_BIAS = 1 << 31
_KEY_MAX = (1 << 63) - 1  # _pair_key(SENTINEL, SENTINEL): every dropped row's key
MERGE_CHUNK = 1 << 26  # postings per step of merge_postings_live's postings pass
SORT_PART = 1 << 27  # keys per part of a split sort (one 1 GiB int64 column)
_SAMPLES = 1 << 16  # keys sampled to cut a split sort's ranges


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering as the u32 pair (hi, lo): hi biased into a signed
    high word."""
    return ((hi - _BIAS) << 32) | lo


def _unpair(key: torch.Tensor):
    return (key >> 32) + _BIAS, key & 0xFFFFFFFF


def _padded(live: torch.Tensor, size: int) -> torch.Tensor:
    """int64 u32 values -> int32 storage of `size`, SENTINEL behind them."""
    out = torch.full((size,), SENTINEL, dtype=torch.int64, device=live.device)
    out[: live.shape[0]] = live
    return to_storage(out)


def sort_postings(hashes: torch.Tensor, ids: torch.Tensor, n: int):
    """Sort the first `n` (hash, id) pairs by (hash, id).

    Returns (hashes_sorted, ids_sorted), int32 storage of the inputs' length
    with the `n` sorted pairs in front and SENTINEL padding behind them."""
    n = int(n)
    size = hashes.shape[0]
    key = torch.sort(_pair_key(u32(hashes[:n]), u32(ids[:n]))).values
    h, d = _unpair(key)
    return _padded(h, size), _padded(d, size)


def _compact(mask: torch.Tensor, cols, fills):
    """The rows of `cols` where `mask` holds, in order, at the front of
    columns of the same length; `fills` behind them."""
    n = mask.shape[0]
    dst = torch.where(mask, torch.cumsum(mask, 0) - 1, n)  # n: a spare slot
    out = []
    for col, fill in zip(cols, fills):
        o = torch.full((n + 1,), fill, dtype=col.dtype, device=col.device)
        o[dst] = col
        out.append(o[:n])
    return out


def merge_postings_live(
    hashes: torch.Tensor,  # u32[CAP] packed postings, contiguous in ordinal order
    docids: torch.Tensor,  # u32[CAP]
    seg_start: torch.Tensor,  # i32[S] (contiguous: start[k+1] == start[k]+len[k])
    seg_len: torch.Tensor,  # i32[S]
    docs_ids: torch.Tensor,  # u32[DCAP] packed per-segment sorted mentioned docs
    docs_alive: torch.Tensor,  # i32[DCAP] 1=live, 0=tombstone
    docs_start: torch.Tensor,  # i32[S]
    docs_len: torch.Tensor,  # i32[S]
    n_run=None,
):
    """Merge every segment in the packed view into one sorted segment.

    Returns (hashes', docids', n_postings, docs_ids', docs_alive', n_docs):
    int32 tables of the input lengths, live entries in front, and the two
    counts as 0-d int64 tensors.  u32 inputs may be int32 storage or int64
    values.  With `n_run`, the segments from ordinal n_run on stand for
    segments newer than the run: their mentions drop the run's postings and
    docs as a newer segment's do, and their docs are not in the result."""
    dev = hashes.device
    cap, dcap = hashes.shape[0], docs_ids.shape[0]
    seg_len, docs_len = seg_len.to(torch.int64), docs_len.to(torch.int64)

    # Mentioned-docs map: sorted by (id, validity, ordinal), the newest
    # mention of each id is the last valid row of its id group.
    dpos = torch.arange(dcap, device=dev)
    dord = torch.searchsorted(torch.cumsum(docs_len, 0), dpos, right=True)
    d_in = dpos < docs_len.sum()
    did = torch.where(d_in, u32(docs_ids), SENTINEL)
    dkey = _pair_key(did, ((~d_in).to(torch.int64) << 31) | dord)
    dkey, order = torch.sort(dkey, stable=True)
    did, _ = _unpair(dkey)
    d_in, dord, dalive = d_in[order], dord[order], docs_alive.to(torch.int32)[order]

    nxt_other = torch.ones(dcap, dtype=torch.bool, device=dev)  # the last row has no next
    nxt_other[:-1] = (did[1:] != did[:-1]) | ~d_in[1:]
    is_last = d_in & nxt_other
    out_id, out_alive, out_ord = _compact(is_last, (did, dalive, dord), (SENTINEL, 0, 0))
    n_docs = is_last.sum()
    if n_run is None:
        run_id, run_alive, n_run_docs = out_id, out_alive, n_docs
    else:
        in_run = is_last & (dord < n_run)
        run_id, run_alive = _compact(in_run, (did, dalive), (SENTINEL, 0))
        n_run_docs = in_run.sum()
        del in_run
    del dpos, d_in, did, dkey, order, dord, dalive, nxt_other, is_last

    # Drop a posting iff a newer segment in the run mentions its doc: its
    # own segment mentions it, so the merged map holds it with the NEWEST
    # in-run mention ordinal.  Dropped rows become (SENTINEL, SENTINEL):
    # they sort behind every kept row, and tie only with a kept
    # (0xFFFFFFFF, 0xFFFFFFFF), which holds the same values.  One chunk of
    # postings at a time (segments are packed contiguously: a posting's
    # ordinal is the segment whose inclusive end passes it).
    bounds = torch.cumsum(seg_len, 0)
    live_end = seg_len.sum()
    key = torch.empty(cap, dtype=torch.int64, device=dev)
    n_kept = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, cap, MERGE_CHUNK):
        e = min(s + MERGE_CHUNK, cap)
        pos = torch.arange(s, e, device=dev)
        ordinal = torch.searchsorted(bounds, pos, right=True)
        d64 = u32(docids[s:e])
        if dcap:
            loc = lower_bound(out_id, d64, 0, n_docs)
            loc_c = torch.clamp(loc, 0, dcap - 1)
            found = (loc < n_docs) & (out_id[loc_c] == d64)
            newest = torch.where(found, out_ord[loc_c], -1)
            del loc, loc_c, found
        else:
            newest = torch.full_like(d64, -1)
        keep = (pos < live_end) & ~(newest > ordinal)
        del pos, ordinal, newest
        n_kept += keep.sum()
        key[s:e] = _pair_key(torch.where(keep, u32(hashes[s:e]), SENTINEL), torch.where(keep, d64, SENTINEL))
        del keep, d64
    key = _sorted_keys(key)
    h_out = torch.empty(cap, dtype=torch.int32, device=dev)
    d_out = torch.empty(cap, dtype=torch.int32, device=dev)
    for s in range(0, cap, MERGE_CHUNK):
        h, d = _unpair(key[s : s + MERGE_CHUNK])
        h_out[s : s + MERGE_CHUNK], d_out[s : s + MERGE_CHUNK] = to_storage(h), to_storage(d)
    return h_out, d_out, n_kept, to_storage(run_id), run_alive, n_run_docs


def _sorted_keys(key: torch.Tensor) -> torch.Tensor:
    """torch.sort(key).values; past SORT_PART keys, sorted in key-range parts
    of about SORT_PART keys each: the ranges are cut at quantiles of a
    sample of the keys below _KEY_MAX, and the _KEY_MAX keys (dropped rows,
    all equal) fill the tail without a sort."""
    n = key.shape[0]
    if n <= SORT_PART:
        return torch.sort(key).values
    out = torch.full((n,), _KEY_MAX, dtype=torch.int64, device=key.device)
    live = key != _KEY_MAX
    n_live = int(live.sum())
    sample = key[:: max(n // _SAMPLES, 1)]
    sample = torch.sort(sample[sample != _KEY_MAX]).values
    parts = -(-n_live // SORT_PART)
    cuts = sample[(torch.arange(1, parts, device=key.device) * sample.shape[0]) // parts].tolist() if sample.shape[0] else []
    edges = [None] + sorted(set(cuts)) + [None]
    pos = 0
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = live if lo is None else live & (key >= lo)
        if hi is not None:
            mask = mask & (key < hi)
        part = key[mask]
        del mask
        out[pos : pos + part.shape[0]] = torch.sort(part).values
        pos += part.shape[0]
        del part
    return out

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
    already in id order; here that is a cumsum scatter.
Tables are int32 storage of u32 bit patterns (ops/layout.py); counts come
back as 0-d int64 tensors, with no host sync.
"""

from __future__ import annotations

import torch

from .binsearch import lower_bound
from .layout import to_storage, u32

SENTINEL = 0xFFFFFFFF
_BIAS = 1 << 31


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
):
    """Merge every segment in the packed view into one sorted segment.

    Returns (hashes', docids', n_postings, docs_ids', docs_alive', n_docs):
    int32 tables of the input lengths, live entries in front, and the two
    counts as 0-d int64 tensors.  u32 inputs may be int32 storage or int64
    values."""
    dev = hashes.device
    cap, dcap = hashes.shape[0], docs_ids.shape[0]
    seg_len, docs_len = seg_len.to(torch.int64), docs_len.to(torch.int64)

    # Ordinal of each posting (segments are packed contiguously).
    pos = torch.arange(cap, device=dev)
    bounds = torch.cumsum(seg_len, 0)  # inclusive ends
    ordinal = torch.searchsorted(bounds, pos, right=True)
    in_range = pos < seg_len.sum()

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

    # Drop a posting iff a newer segment in the run mentions its doc: its
    # own segment mentions it, so the merged map holds it with the NEWEST
    # in-run mention ordinal.
    d64 = u32(docids)
    loc = lower_bound(out_id, d64, 0, n_docs)
    loc_c = torch.clamp(loc, 0, max(dcap - 1, 0))
    if dcap:
        found = (loc < n_docs) & (out_id[loc_c] == d64)
        newest = torch.where(found, out_ord[loc_c], -1)
    else:
        newest = torch.full_like(d64, -1)
    keep = in_range & ~(newest > ordinal)

    # Dropped rows become (SENTINEL, SENTINEL): they sort behind every kept
    # row, and tie only with a kept (0xFFFFFFFF, 0xFFFFFFFF), which holds the
    # same values.
    h = torch.where(keep, u32(hashes), SENTINEL)
    d = torch.where(keep, d64, SENTINEL)
    h, d = _unpair(torch.sort(_pair_key(h, d)).values)
    return to_storage(h), to_storage(d), keep.sum(), to_storage(out_id), out_alive, n_docs

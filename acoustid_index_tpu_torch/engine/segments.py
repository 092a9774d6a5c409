"""Packed device views of segment sets (counterpart of
acoustid_index_tpu/engine/segments.py).

The host side -- snapshots, supersession filtering, capacity buckets, the
numpy pack -- is the reference's own: its helpers are imported, and
pack_tier_np below is the numpy half of the reference's pack_tier, line for
line, so both packages pack a tier to the same bytes.  Only the upload
differs: `torch.as_tensor` on the port's device in place of `jnp.asarray`,
with u32 arrays carried as int32 storage of the same bit patterns.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from acoustid_index_tpu.engine.memseg import Segment
from acoustid_index_tpu.engine.segments import (  # noqa: F401  (re-exported host layer)
    FILE_SLOTS,
    MEMORY_SLOTS,
    PENDING_VIEW,
    SEARCH_TIER_FIELDS,
    SENTINEL32,
    Snapshot,
    _VIEW_TOKENS,
    _bucket,
    _pack_runs,
    build_mention_table,
    filter_superseded,
    slot_bucket,
)

from ..ops.layout import BLOCK, interleave_np, resident_max_bytes, use_interleaved

# Fields that live on the device (the rest of a view stays host-side numpy).
_DEVICE_FIELDS = ("hashes", "docids", "inter", "block_index", "seg_start", "seg_len")


def pack_tier_np(
    segments: Sequence[Segment],
    slots: int,
    min_cap: int = 1024,
    min_slots: int = 0,
    min_caps: Optional[Tuple[int, int, int]] = None,
) -> Dict:
    """The reference's pack_tier up to its upload: every field as numpy
    (u32 tables as np.uint32), mention_len as np.int32."""
    if len(segments) > slots:
        raise ValueError(f"too many segments for tier: {len(segments)} > {slots}")
    slots = slot_bucket(max(len(segments), min(min_slots, slots)), slots)
    cmin, dmin, mmin = min_caps or (min_cap, min_cap, min_cap)

    mention_ids, _mention_ord = build_mention_table(segments)
    live_items = filter_superseded(segments)

    seg_len = np.zeros(slots, dtype=np.int32)
    seg_start = np.zeros(slots, dtype=np.int32)
    docs_len = np.zeros(slots, dtype=np.int32)
    docs_start = np.zeros(slots, dtype=np.int32)
    pos = dpos = 0
    for k, s in enumerate(segments):
        seg_start[k] = pos
        seg_len[k] = live_items[k][0].shape[0]
        pos += seg_len[k]
        docs_start[k] = dpos
        docs_len[k] = s.num_docs
        dpos += s.num_docs

    cap = _bucket(max(-(-pos // BLOCK) * BLOCK, 1), max(cmin, BLOCK))
    dcap = _bucket(max(dpos, 1), dmin)

    hashes = np.full(cap, SENTINEL32, dtype=np.uint32)
    docids = np.full(cap, SENTINEL32, dtype=np.uint32)
    if segments:
        all_h = np.concatenate([h for h, _ in live_items])
        all_d = np.concatenate([d for _, d in live_items])
        if len(segments) > 1:
            order = np.argsort(all_h, kind="stable")  # ties stay segment-asc
            all_h, all_d = all_h[order], all_d[order]
        hashes[: all_h.shape[0]] = all_h
        docids[: all_d.shape[0]] = all_d
    block_index = np.ascontiguousarray(hashes[::BLOCK])

    mcap = _bucket(max(mention_ids.shape[0], 1), mmin)
    m_ids = np.full(mcap, SENTINEL32, np.uint32)
    m_ids[: mention_ids.shape[0]] = mention_ids

    out = {
        "block_index": block_index,
        "seg_start": seg_start,
        "seg_len": seg_len,
        "docs_ids": _pack_runs([s.docs_ids for s in segments], dcap, SENTINEL32),
        "docs_alive": _pack_runs([s.docs_alive.astype(np.int32) for s in segments], dcap, np.int32(0)),
        "docs_start": docs_start,
        "docs_len": docs_len,
        "mention_ids": m_ids,
        "mention_len": np.int32(mention_ids.shape[0]),
    }
    if use_interleaved(cap, resident_max_bytes()):
        out["inter"] = interleave_np(hashes, docids)
    else:
        out["hashes"] = hashes
        out["docids"] = docids
    return out


def _to_device(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. np.asarray of a jax array
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)  # same bits; the kernels read them as u32
    return torch.as_tensor(a, device=device)


def tier_from_numpy(view: Dict, device, mentions: bool = True) -> Dict:
    """A tier packed by either package, every field as numpy (np.asarray
    of the reference's jax arrays works), as the port's device view: the
    search fields become tensors on `device`, the docs_* bookkeeping stays
    numpy.  `mentions=False` keeps the mention table host-side (the file
    tier: within-tier supersession is resolved at pack time, so the search
    never reads it)."""
    out = {}
    for k, v in view.items():
        if k in _DEVICE_FIELDS or (mentions and k in ("mention_ids", "mention_len")):
            out[k] = _to_device(np.asarray(v), device)
        elif k in ("mention_ids", "mention_len"):
            out[k] = np.asarray(v)
        else:
            out[k] = v
    if device is not None and torch.device(device).type == "cuda":
        # The upload ran on this thread's current stream; searches run on
        # the searcher's own stream, so finish the copies before sharing.
        torch.cuda.current_stream(device).synchronize()
    return out


def pack_tier(
    segments: Sequence[Segment],
    slots: int,
    min_cap: int = 1024,
    min_slots: int = 0,
    min_caps: Optional[Tuple[int, int, int]] = None,
    device_mentions: bool = True,
    device=None,
) -> Dict:
    """Pack segments (oldest -> newest) into one padded tier on `device`
    (default: utils.device.device())."""
    if device is None:
        from ..utils.device import device as default_device

        device = default_device()
    view = tier_from_numpy(
        pack_tier_np(segments, slots, min_cap, min_slots, min_caps), device, mentions=device_mentions
    )
    view["view_token"] = next(_VIEW_TOKENS)
    return view


def tier_view_for_search(tier: Dict, mentions: bool = True) -> Dict:
    """The search program's input: postings (+ the mention membership table
    when `mentions` -- the memory tier)."""
    fields = SEARCH_TIER_FIELDS if mentions else tuple(
        f for f in SEARCH_TIER_FIELDS if not f.startswith("mention")
    )
    return {k: tier[k] for k in fields if k in tier}

"""Immutable segment-set snapshots and their packed device views
(counterpart of acoustid_index_tpu/engine/segments.py).

The host half -- Snapshot, slot and capacity buckets, the mention table,
the pack-time supersession filter -- is the reference's code, copied here;
pack_tier_np below is the numpy half of the reference's pack_tier, line for
line, so both packages pack a tier to the same bytes.  Only the upload
differs: `torch.as_tensor` on the port's device in place of `jnp.asarray`,
with u32 arrays carried as int32 storage of the same bit patterns.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.layout import BLOCK, interleave_np, resident_max_bytes, use_interleaved
from ..utils.profiling import trace
from .memseg import Segment

FILE_SLOTS = 64
MEMORY_SLOTS = 32
SLOT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
SENTINEL32 = np.uint32(0xFFFFFFFF)

# Every packed view carries a process-unique token (plain int, host-side
# only): caches that need view identity (e.g. the searcher's warm-program
# shape cache) key on the token instead of id(view), which both avoids the
# id-recycling hazard and lets caches drop the view reference — a strong
# reference would pin superseded device buffers (GBs at 100M+ docs) in HBM
# past their last reader.
_VIEW_TOKENS = itertools.count(1)


class _PendingView:
    """Placeholder for a tier view whose device packing is DEFERRED to the
    first reader (the bulk-ingest path): packing re-sorts the whole tier,
    so a write-only ingest stream must not pay it per batch.  Readers go
    through Index.ensure_views, which resolves the placeholder exactly once
    per snapshot (from snapshot.memory) before any search sees it."""

    __repr__ = lambda self: "<pending view>"  # noqa: E731


PENDING_VIEW = _PendingView()


def _bucket(n: int, minimum: int) -> int:
    """Smallest capacity >= n from {minimum·2^k} ∪ {1.5·minimum·2^k}: the
    half-octave steps cut the worst-case HBM waste from 50% to 33% (a
    corpus just past a power of two no longer doubles the buffers — at
    ~1.6B postings that is the difference between fitting a chip's HBM and
    not), at the cost of one extra compiled program per octave.  Half
    steps are taken only when they remain multiples of `minimum`, so
    BLOCK-aligned packing (and the (…, 128) reshapes in the Pallas
    kernels) is preserved."""
    size = minimum
    while size < n:
        half = size + size // 2
        if size >= 2 * minimum and n <= half:
            return half
        size *= 2
    return size


def slot_bucket(n_segments: int, cap: int) -> int:
    """Slot count for a tier: the kernel's range/supersession work scales
    with the slot count, so small indexes get small compiled programs."""
    for b in SLOT_BUCKETS:
        if b >= n_segments and b <= cap:
            return b
    return cap


def build_mention_table(segments: "Sequence[Segment]"):
    """Merged (docid -> newest tier-local ordinal) table: the kernel resolves
    supersession with ONE binary search per tier instead of one per segment.
    Exact because ordinals ascend with commit ids: a doc is superseded for a
    hit at ordinal o iff its newest mention ordinal exceeds o."""
    if not segments:
        return np.empty(0, np.uint32), np.empty(0, np.int32)
    if len(segments) == 1:
        ids = np.ascontiguousarray(segments[0].docs_ids)
        ords = np.zeros(ids.shape[0], np.int32)
    else:
        ids = np.concatenate([s.docs_ids for s in segments])
        ords = np.concatenate(
            [np.full(s.num_docs, k, np.int32) for k, s in enumerate(segments)]
        )
    if ids.shape[0] < 2 or bool((ids[1:] > ids[:-1]).all()):
        # Sorted and unique already (one segment's docs, or segments over
        # ascending disjoint ranges): the sort below would be the identity
        # and every row its id's last.  At 2^27 docs this saves ~4 s.
        return ids, ords
    order = np.argsort(ids, kind="stable")  # stable: ords ascend within ties
    ids = ids[order]
    ords = ords[order]
    last = np.ones(ids.shape[0], bool)
    last[:-1] = ids[1:] != ids[:-1]
    return np.ascontiguousarray(ids[last]), np.ascontiguousarray(ords[last])


def filter_superseded(segments: "Sequence[Segment]"):
    """Per-segment (hashes, docids) with within-tier superseded postings
    dropped: segment k keeps a posting iff NO newer segment mentions its
    doc — the reference's hasNewerCommit discard (Index.zig:133-149) moved
    to pack time.  Works newest-to-oldest against a growing suffix union
    of newer segments' mentioned docs, so the big oldest slot searches a
    table the size of the RECENT docs (thousands), not the whole corpus;
    doc-range-disjoint segments (append-only ingest) skip entirely."""
    S = len(segments)
    out: list = [None] * S
    suffix = np.empty(0, np.uint32)  # sorted unique docs of segments > k
    suffix_min = suffix_max = None
    for k in range(S - 1, -1, -1):
        s = segments[k]
        if (
            suffix.size == 0
            or s.num_items == 0
            or s.min_doc_id > suffix_max
            or s.max_doc_id < suffix_min
        ):
            out[k] = (s.hashes, s.docids)
        else:
            idx = np.searchsorted(suffix, s.docids)
            hit = suffix[np.minimum(idx, suffix.shape[0] - 1)] == s.docids
            keep = ~hit
            out[k] = (s.hashes[keep], s.docids[keep])
        if k > 0 and s.num_docs:
            suffix = np.union1d(suffix, s.docs_ids) if suffix.size else np.array(s.docs_ids)
            suffix_min = int(suffix[0])
            suffix_max = int(suffix[-1])
    return out


def _pack_runs(arrays: Sequence[np.ndarray], cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, dtype=arrays[0].dtype if arrays else np.uint32)
    pos = 0
    for a in arrays:
        out[pos : pos + a.shape[0]] = a
        pos += a.shape[0]
    return out


# Fields that live on the device (the rest of a view stays host-side numpy).
_DEVICE_FIELDS = ("hashes", "docids", "inter", "block_index", "seg_start", "seg_len")


def tier_frame(
    segments: Sequence[Segment],
    live_lens: Sequence[int],
    slots: int,
    min_cap: int = 1024,
    min_slots: int = 0,
    min_caps: Optional[Tuple[int, int, int]] = None,
    mention_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[Dict, int]:
    """pack_tier_np's fields other than the postings, as numpy, for
    segments that keep `live_lens` postings each after the supersession
    filter; and the postings capacity.  `mention_table` is the segments'
    build_mention_table, where the caller has it already."""
    if len(segments) > slots:
        raise ValueError(f"too many segments for tier: {len(segments)} > {slots}")
    slots = slot_bucket(max(len(segments), min(min_slots, slots)), slots)
    cmin, dmin, mmin = min_caps or (min_cap, min_cap, min_cap)

    mention_ids, _mention_ord = mention_table or build_mention_table(segments)

    seg_len = np.zeros(slots, dtype=np.int32)
    seg_start = np.zeros(slots, dtype=np.int32)
    docs_len = np.zeros(slots, dtype=np.int32)
    docs_start = np.zeros(slots, dtype=np.int32)
    pos = dpos = 0
    for k, s in enumerate(segments):
        seg_start[k] = pos
        seg_len[k] = live_lens[k]
        pos += seg_len[k]
        docs_start[k] = dpos
        docs_len[k] = s.num_docs
        dpos += s.num_docs

    cap = _bucket(max(-(-pos // BLOCK) * BLOCK, 1), max(cmin, BLOCK))
    dcap = _bucket(max(dpos, 1), dmin)

    mcap = _bucket(max(mention_ids.shape[0], 1), mmin)
    m_ids = np.full(mcap, SENTINEL32, np.uint32)
    m_ids[: mention_ids.shape[0]] = mention_ids

    frame = {
        "seg_start": seg_start,
        "seg_len": seg_len,
        "docs_ids": _pack_runs([s.docs_ids for s in segments], dcap, SENTINEL32),
        "docs_alive": _pack_runs([s.docs_alive.astype(np.int32) for s in segments], dcap, np.int32(0)),
        "docs_start": docs_start,
        "docs_len": docs_len,
        "mention_ids": m_ids,
        "mention_len": np.int32(mention_ids.shape[0]),
    }
    return frame, cap


def pack_tier_np(
    segments: Sequence[Segment],
    slots: int,
    min_cap: int = 1024,
    min_slots: int = 0,
    min_caps: Optional[Tuple[int, int, int]] = None,
) -> Dict:
    """The reference's pack_tier up to its upload: every field as numpy
    (u32 tables as np.uint32), mention_len as np.int32."""
    live_items = filter_superseded(segments)
    frame, cap = tier_frame(segments, [h.shape[0] for h, _ in live_items], slots, min_cap, min_slots, min_caps)

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

    out = {"block_index": np.ascontiguousarray(hashes[::BLOCK]), **frame}
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
    (default: utils.device.device()): on the device from the segments' file
    bytes when every one is a card_tier.CardSegment that still holds them
    there (a restart's file tier), else with pack_tier_np and an upload."""
    if device is None:
        from ..utils.device import device as default_device

        device = default_device()
    from . import card_tier

    if card_tier.packs_on_card(segments, device):
        view = card_tier.pack_tier_card(segments, slots, min_cap, min_slots, min_caps, mentions=device_mentions)
    else:
        tier = pack_tier_np(segments, slots, min_cap, min_slots, min_caps)
        with trace("tier.upload"):
            view = tier_from_numpy(tier, device, mentions=device_mentions)
    view["view_token"] = next(_VIEW_TOKENS)
    return view


SEARCH_TIER_FIELDS = (
    "hashes",
    "docids",
    "inter",  # interleaved postings blocks (replaces hashes/docids on large tiers)
    "block_index",
    "seg_start",
    "seg_len",
    # Mention MEMBERSHIP table: within-tier supersession is resolved at
    # pack time, so the kernel only ever asks "does the memory tier mention
    # this doc" — no per-doc ordinal column needed.
    "mention_ids",
    "mention_len",
)


def tier_view_for_search(tier: Dict, mentions: bool = True) -> Dict:
    """The search program's input: postings (+ the mention membership table
    when `mentions` -- the memory tier)."""
    fields = SEARCH_TIER_FIELDS if mentions else tuple(
        f for f in SEARCH_TIER_FIELDS if not f.startswith("mention")
    )
    return {k: tier[k] for k in fields if k in tier}


@dataclass(frozen=True)
class Snapshot:
    """Immutable view of one index state. Cheap to copy-and-extend: the file
    tier's device buffers are shared by reference across snapshots."""

    file: Tuple[Segment, ...] = ()
    memory: Tuple[Segment, ...] = ()
    # Internal dense commit ids (newest committed / newest durable-in-file).
    commit_id: int = 0
    file_commit_id: int = 0
    # The same two points as upstream changelog positions (see segment.zig).
    version: int = 0
    file_version: int = 0
    external_versions: bool = False
    # Packed device views (built by Index; shared where unchanged).
    file_view: Optional[Dict] = None
    mem_view: Optional[Dict] = None

    # ---- host-side queries (API surface; search itself runs on device) ----

    def all_segments(self) -> Tuple[Segment, ...]:
        return self.file + self.memory

    def num_segments(self) -> int:
        return len(self.file) + len(self.memory)

    def num_docs(self) -> int:
        return sum(s.num_docs for s in self.all_segments())

    def min_doc_id(self) -> int:
        result = 0
        for s in self.all_segments():
            if s.min_doc_id != 0 and (result == 0 or s.min_doc_id < result):
                result = s.min_doc_id
        return result

    def max_doc_id(self) -> int:
        result = 0
        for s in self.all_segments():
            result = max(result, s.max_doc_id)
        return result

    def metadata(self) -> Dict[str, str]:
        md: Dict[str, str] = {}
        for s in self.all_segments():  # oldest -> newest, newest key wins
            md.update(s.metadata)
        return md

    def get_doc_info(self, doc_id: int):
        """Newest segment mentioning the doc wins (Segments.getDocInfo)."""
        for s in reversed(self.all_segments()):
            if s.min_doc_id <= doc_id <= s.max_doc_id:
                alive = s.doc_alive(doc_id)
                if alive is not None:
                    return (s.info.effective_version(), not alive)
        return None

    def has_newer_commit_batch(self, doc_ids: np.ndarray, commit_id: int) -> np.ndarray:
        """Vectorized hasNewerCommit over many doc ids (merge hot path)."""
        doc_ids = np.asarray(doc_ids, dtype=np.uint32)
        out = np.zeros(doc_ids.shape[0], dtype=bool)
        for s in self.all_segments():
            if s.info.commit_id <= commit_id or s.docs_ids.shape[0] == 0:
                continue
            idx = np.searchsorted(s.docs_ids, doc_ids)
            idx_c = np.clip(idx, 0, s.docs_ids.shape[0] - 1)
            out |= s.docs_ids[idx_c] == doc_ids
        return out

    def has_newer_commit(self, doc_id: int, commit_id: int) -> bool:
        """Any segment strictly newer than `commit_id` mentions the doc
        (Segments.hasNewerCommit, Index.zig:133-149)."""
        for s in reversed(self.all_segments()):
            if s.info.commit_id <= commit_id:
                return False
            if s.min_doc_id <= doc_id <= s.max_doc_id and s.mentions(doc_id):
                return True
        return False

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
  * the mesh is one controller over the process's cards, as the reference
    runs one SPMD program over its local devices: a `Mesh` of N shards
    names its cards as SLOTS, and shard k lives on slot k * S // N, so a
    slot holds a run of consecutive shards.  Slots may repeat a device
    (several slots on one card; the CPU tests).  No `torch.distributed`:
    what crosses cards per batch is small (the queries, the joined (B, W)
    hit lists, the mention answers, a few predicates and statistics), and
    peer copies carry it;
  * each slot's shards ship as ONE flat (n_slot * X,) tensor per field on
    the slot's device, the reference's flat layout cut at slot
    boundaries; shard k's local tier is a VIEW within its slot
    (`_local_tier`): no copy per batch;
  * a batch runs each slot's stages on the slot's device and stream
    (`_Batch`); the collectives are copies to slot 0, the scoring slot,
    then plain tensor operations in shard order 0..n-1: all_gather(axis=1,
    tiled) is `torch.cat(.., 1)`, pmax a max and psum a sum.  Scoring the
    joined stream once, on slot 0, replaces scoring it identically on
    every shard;
  * `lax.cond` on pmax'd predicates is a host-side branch: each decision
    point's predicates of ALL slots come to the host together (one pinned
    buffer, one event per slot, `_Batch.fetch`), so a batch makes at most
    two host syncs at any shard or slot count, as the single path does
    (ops/search_kernel.py);
  * each shard's range phase runs the port's kernels (K1, K2) through the
    single path's `_batch_ranges` on its slot's card, with its path
    decisions per shard.
`STATS` counts the branches each batch took.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from ..ops.search_kernel import _count as _count_single
from ..utils.profiling import bump, counters

MATRIX_MAX = 1024  # widest joined stream scored sort-free (the reference's)

# Per-process counts of the sharded program: batches, the path each took
# (direct with a live memory tier or without, P_SMALL gather, full-budget
# gather) and the scorer of the joined stream (equality matrix up to
# MATRIX_MAX wide, else the sort).  Host syncs count in
# ops/search_kernel.STATS["host_syncs"].
# They live in the span and counter registry (utils/profiling) as
# `sharded.<key>`.
STATS = counters("sharded", {"batches": 0, "direct_wide": 0, "direct_narrow": 0, "small": 0, "full": 0,
                             "select_matrix": 0, "select_sorted": 0})


def _count(*keys: str) -> None:
    for k in keys:
        bump(STATS, k)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `n_shards` shards over the devices `slots`: shard k
    lives on slot k * len(slots) // n_shards.  Slot 0 scores."""

    n_shards: int
    slots: Tuple[torch.device, ...]

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, not {self.n_shards}")
        if not 1 <= len(self.slots) <= self.n_shards:
            raise ValueError(f"{len(self.slots)} slots for {self.n_shards} shards: a mesh needs 1..n_shards slots")

    @property
    def device(self) -> torch.device:
        """The scoring slot's device: the program's inputs and outputs."""
        return self.slots[0]

    def slot_of(self, k: int) -> int:
        return k * len(self.slots) // self.n_shards

    def shard_range(self, s: int) -> Tuple[int, int]:
        """Slot s's run of shards [first, end)."""
        S, n = len(self.slots), self.n_shards
        return -(-s * n // S), -(-(s + 1) * n // S)


def _slot_device(d) -> torch.device:
    """A slot's device, its card named by index; raises when it is absent."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh slot {d}: CUDA is unavailable")
    if d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    if d.index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh slot {d}: only {torch.cuda.device_count()} cards are visible")
    return d


def make_mesh(n_shards: Optional[int] = 1, devices=None) -> Mesh:
    """`n_shards` shards (None: 1) over `devices`: a sequence names the
    slots one by one; one device, or None for utils.device.device(), gives
    one slot per visible card up to n_shards when it is `cuda` without an
    index, else one slot on it.  CUDA_VISIBLE_DEVICES picks the cards."""
    n = 1 if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    if devices is None:
        from ..utils.device import device as default_device

        devices = default_device()
    if isinstance(devices, (str, torch.device)):
        d = torch.device(devices)
        if d.type == "cuda" and d.index is None:
            if not torch.cuda.is_available():
                raise RuntimeError("a mesh over the visible cards: CUDA is unavailable")
            devices = [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
        else:
            devices = [d]
    return Mesh(n, tuple(_slot_device(d) for d in devices))


def describe_mesh(mesh: Mesh) -> str:
    """The shard -> card map, each card's name and memory, and whether each
    pair of cards reaches the other directly (peer access)."""
    parts = []
    for s, d in enumerate(mesh.slots):
        a, b = mesh.shard_range(s)
        what = str(d)
        if d.type == "cuda":
            prop = torch.cuda.get_device_properties(d)
            what += f" ({prop.name}, {prop.total_memory / 2**30:.1f} GiB)"
        parts.append(f"shards {a}-{b - 1} on slot {s}: {what}")
    cards = sorted({d.index for d in mesh.slots if d.type == "cuda"})
    peers = [f"{a}->{b} {'peer' if torch.cuda.can_device_access_peer(a, b) else 'through the host'}"
             for a in cards for b in cards if a != b]
    return f"{mesh.n_shards} shards over {len(mesh.slots)} slots: " + "; ".join(parts) + (
        f"; copies {', '.join(peers)}" if peers else "")


def hash_bounds(n_shards: int) -> np.ndarray:
    """Shard k owns hashes in [bounds[k], bounds[k+1])."""
    return np.array([(k * (1 << 32)) // n_shards for k in range(n_shards + 1)], dtype=np.uint64)


@dataclass
class ShardedView:
    """Both tiers packed per shard and placed by put_sharded: each slot's
    device fields under "slots", docs_* bookkeeping host-side numpy
    (n_shards, X)."""

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


def put_sharded(tier_np: Dict, mesh: Mesh, mentions: bool = True) -> Dict:
    """Place a packed sharded tier: each slot's run of shards as one flat
    (n_slot * X,) tensor per search field on the slot's device (u32 as
    int32 storage), under "slots"; docs_* bookkeeping stays host-side
    numpy.  `mentions=False` keeps the mention table host-side (the file
    tier: the search never reads it)."""
    n = mesh.n_shards
    placed = [k for k in SHARDED_DEVICE_FIELDS if k in tier_np and (mentions or not k.startswith("mention"))]
    out = {k: v for k, v in tier_np.items() if k not in placed}
    slots = []
    for s, dev in enumerate(mesh.slots):
        a, b = mesh.shard_range(s)
        part = {}
        for k in placed:
            x = tier_np[k].shape[0] // n  # mention_len is (n,): x = 1
            part[k] = tier_np[k][a * x : b * x]
        slots.append(tier_from_numpy(part, dev))
    out["slots"] = tuple(slots)
    return out


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


def slot_tiers(tier: Dict, mentions: bool = True) -> Tuple[Dict, ...]:
    """A placed tier's per-slot search fields, the program's input; the
    file tier's mention table is not consulted (supersession only asks the
    memory tier), as tier_view_for_search(..., mentions=False)."""
    return tuple({k: v for k, v in slot.items() if mentions or not k.startswith("mention")} for slot in tier["slots"])


def search_tiers(view: ShardedView) -> Tuple[Tuple[Dict, ...], Tuple[Dict, ...]]:
    """The (file, mem) per-slot fields the sharded program takes."""
    return slot_tiers(view.file_tier, mentions=False), slot_tiers(view.mem_tier)


def _local_tier(tier: Sequence[Dict], k: int, mesh: Mesh) -> Dict:
    """Shard k's tier: a view of the k-th block of each flat field within
    its slot (no copy), and its own mention_len."""
    s = mesh.slot_of(k)
    a, b = mesh.shard_range(s)
    j = k - a
    out = {}
    for key, v in tier[s].items():
        size = v.shape[0] // (b - a)
        out[key] = v[j] if key == "mention_len" else v[j * size : (j + 1) * size]
    return out


class _Batch:
    """Where one batch runs: each slot's device and stream, and the
    crossings between slot s and the scoring slot 0.

    On a card every slot has a stream (the caller's per-slot streams, or
    each device's current one); the program runs inside slot 0's, and a
    slot's stages inside its own (`on`).  A crossing to another card is a
    copy, which PyTorch orders after the source stream's work and before
    the destination stream's.  A crossing between two streams of one card
    is no copy: the consumer's stream waits on an event of the producer's,
    and the tensor is marked in use by the consumer's stream, so that the
    allocator does not hand its block to the producer's stream early."""

    def __init__(self, mesh: Mesh, streams=None):
        self.devices = mesh.slots
        self.streams = None
        if mesh.device.type == "cuda":
            self.streams = tuple(streams) if streams is not None else tuple(
                torch.cuda.current_stream(d) for d in mesh.slots)

    def on(self, s: int):
        return torch.cuda.stream(self.streams[s]) if self.streams else contextlib.nullcontext()

    def _cross(self, xs, src: int, dst: int):
        if self.streams is None or self.streams[src] == self.streams[dst]:
            return [x.to(self.devices[dst]) for x in xs]
        if self.devices[src] != self.devices[dst]:
            # Inside slot s's context both cards' current streams are the
            # slots' own; the copy runs on the source's.
            with self.on(src if dst == 0 else dst):
                return [x.to(self.devices[dst], non_blocking=True) for x in xs]
        ev = torch.cuda.Event()
        ev.record(self.streams[src])
        self.streams[dst].wait_event(ev)
        for x in xs:
            x.record_stream(self.streams[dst])
        return list(xs)

    def send(self, s: int, *xs):
        """Tensors made on slot 0's stream, for slot s's."""
        return xs if s == 0 else self._cross(xs, 0, s)

    def home(self, s: int, *xs):
        """Tensors made on slot s's stream, for slot 0's."""
        return xs if s == 0 else self._cross(xs, s, 0)

    def fetch(self, per_slot: Sequence[Sequence[torch.Tensor]]) -> List[List[bool]]:
        """Every slot's 0-d predicates to the host in one sync: each slot's
        copied into one pinned buffer behind an event on its stream, then
        one wait for them all."""
        _count_single("host_syncs")
        sizes = [len(ps) for ps in per_slot]
        if self.streams is None:  # the CPU
            flat = torch.stack([p for ps in per_slot for p in ps]).tolist()
        else:
            host = torch.empty(sum(sizes), dtype=torch.bool, pin_memory=True)
            events, off = [], 0
            for s, ps in enumerate(per_slot):
                with self.on(s):
                    host[off : off + len(ps)].copy_(torch.stack(ps), non_blocking=True)
                    events.append(torch.cuda.Event())
                    events[-1].record(self.streams[s])
                off += len(ps)
            for ev in events:
                ev.synchronize()
            flat = host.tolist()
        out, off = [], 0
        for n in sizes:
            out.append([bool(v) for v in flat[off : off + n]])
            off += n
        return out

    def join(self) -> None:
        """Slot 0's stream waits for everything every slot has queued."""
        for s in range(1, len(self.devices)):
            if self.streams is not None and self.streams[s] != self.streams[0]:
                ev = torch.cuda.Event()
                ev.record(self.streams[s])
                self.streams[0].wait_event(ev)


def _sharded_batch_impl(p: SearchParams, mesh: Mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts,
                        streams=None):
    """(B, Q) batch over the mesh's shards: the reference's shard body,
    branch for branch, each shard's stages on its slot's card, every branch
    decided on the host from all shards' predicates at once.  The inputs
    and outputs are on slot 0's device, the outputs queued on slot 0's
    stream; `streams` are the slots' streams (default: each device's
    current one)."""
    run = _Batch(mesh, streams)
    with run.on(0):
        out = _batch_body(p, mesh, run, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts)
        run.join()
    return out


def _batch_body(p, mesh, run, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    B = queries.shape[0]
    n, S = mesh.n_shards, len(mesh.slots)
    shards = [range(*mesh.shard_range(s)) for s in range(S)]
    f_loc = [_local_tier(file_tier, k, mesh) for k in range(n)]
    m_loc = [_local_tier(mem_tier, k, mesh) for k in range(n)]

    # Range phase per shard on its slot, whole batch at once; the emitting
    # lookup feeds the direct path.  Each slot's predicates are reduced
    # over its shards there (the pmax within the slot).
    want_emit = "inter" in file_tier[0] and p.query_len <= 256
    E_direct = 2 if p.query_len <= 128 else 1
    # candidate_cap against n * P_SMALL, not P_SMALL: the sorted ranker's
    # top C must fit the joined P_SMALL hit lists of every shard.
    small_ok = p.postings_budget > P_SMALL and p.candidate_cap <= n * P_SMALL
    f_lo, f_cnt, m_lo, m_cnt, r_trunc, emit = ([None] * n for _ in range(6))

    def smax(xs):
        return torch.stack(xs).amax()

    preds = []
    for s in range(S):
        with run.on(s):
            qs, lens = run.send(s, queries, q_lens)
            for k in shards[s]:
                f_lo[k], f_cnt[k], m_lo[k], m_cnt[k], r_trunc[k], emit[k] = _batch_ranges(
                    p, f_loc[k], m_loc[k], qs, lens, want_emit=want_emit)
            false = torch.zeros((), dtype=torch.bool, device=qs.device)
            small = direct = false
            if small_ok:
                small = smax([small_budget(p, f_cnt[k], m_cnt[k], B)[1].amax() for k in shards[s]]) <= P_SMALL
            if want_emit:
                ov = [torch.clamp(f_cnt[k] - torch.where(emit[k][1], E_direct, 0), min=0).sum(1).amax() for k in shards[s]]
                direct = (smax(ov) <= F_DIRECT) & (smax([m_cnt[k].sum(1).amax() for k in shards[s]]) <= P_MEM_DIRECT)
            preds.append([smax([m_cnt[k].sum() for k in shards[s]]) > 0,
                          mem_tier[s]["mention_len"].amax() > 0, small, direct])

    # Global predicates (the reference's pmax'd ones) from every slot's, one
    # host sync: any slot's memory hit or mention, every slot small / direct.
    got = run.fetch(preds)
    has_mem = any(g[0] for g in got)
    mem_mentions_any = any(g[1] for g in got)
    small = small_ok and all(g[2] for g in got)
    direct_ok = want_emit and all(g[3] for g in got)

    def combined_newest(d_flat, mask_flat):
        # Each candidate doc has one docid-range home shard; every shard
        # answers from its own table behind its own gate (the flag is
        # global, the range test local), and a max on slot 0 combines the
        # answers (the reference's pmax).  The candidates go to every slot;
        # all shards' gates reach the host in one sync.
        newest = torch.full_like(d_flat, -1)
        if not mem_mentions_any:
            return newest
        cands, gates = [], []
        for s in range(S):
            with run.on(s):
                cands.append(run.send(s, d_flat, mask_flat))
                gates.append([_newest_gate(m_loc[k], *cands[s], True) for k in shards[s]])
        live = run.fetch(gates)
        for s in range(S):
            with run.on(s):
                answers = [_newest_lookup(m_loc[k], *cands[s]) for i, k in enumerate(shards[s]) if live[s][i]]
                for a in run.home(s, *answers):
                    newest = torch.maximum(newest, a)
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

    # Per shard: its (d, o, inv) hit list, its (B,) postings total and
    # (B,) overflow flags; each slot's lists and statistics go to slot 0.
    if direct_ok:
        # Gather-free file-tier candidates per shard from the emitted rows;
        # with a live memory tier (global has_mem) its postings ride along
        # through a P_MEM_DIRECT gather.  A hash lives on one shard, so the
        # joined direct streams are the single-card stream of the union.
        _count("batches", "direct_wide" if has_mem else "direct_narrow")
        p_eff = p
        p_mem = dataclasses.replace(p, postings_budget=P_MEM_DIRECT)

        def shard_part(k):
            rows, covered = emit[k]
            d_f, inv_f, tot_f = _direct_candidates(p, f_loc[k], rows, covered, f_lo[k], f_cnt[k], E_direct)
            if not has_mem:
                return d_f, torch.zeros_like(d_f), inv_f, tot_f, None
            d_m, _o, inv_m, tot_m, _over = _plan_and_gather(
                p_mem, f_loc[k], m_loc[k], f_lo[k], torch.zeros_like(m_cnt[k]), m_lo[k], m_cnt[k],
                use_mem=True, use_file=False,
            )
            o = torch.cat([torch.zeros_like(d_f), torch.full_like(d_m, TIER_MEM)], 1)
            return torch.cat([d_f, d_m], 1), o, torch.cat([inv_f, inv_m], 1), tot_f + tot_m, None
    else:
        # Per-shard plan+gather at P_SMALL or at the full budget.
        p_eff = dataclasses.replace(p, postings_budget=P_SMALL) if small else p
        _count("batches", "small" if small else "full")

        def shard_part(k):
            return _plan_and_gather(p_eff, f_loc[k], m_loc[k], f_lo[k], f_cnt[k], m_lo[k], m_cnt[k], use_mem=has_mem)

    lists, stats = [], []  # (d, o, inv) of every shard in shard order; each slot's statistics
    for s in range(S):
        with run.on(s):
            parts = [shard_part(k) for k in shards[s]]
            tr = torch.stack([r_trunc[k] for k in shards[s]]).any().expand(B)
            for _d, _o, _inv, _tot, over in parts:
                if over is not None:
                    tr = tr | over
            # The slot's statistics, (4, B): postings (psum), truncation,
            # max postings of one hash and max blocks of one hash's run
            # (pmax: a hash's postings live on one shard).
            st = torch.stack([
                torch.stack([tot for *_, tot, _over in parts]).sum(0),
                tr.to(torch.int64),
                torch.stack([(f_cnt[k] + m_cnt[k]).amax(1) for k in shards[s]]).amax(0),
                torch.stack([(_tier_blocks(f_lo[k], f_cnt[k]) + _tier_blocks(m_lo[k], m_cnt[k])).amax(1)
                             for k in shards[s]]).amax(0),
            ])
            homed = run.home(s, st, *(t for part in parts for t in part[:3]))
        stats.append(homed[0])
        lists.extend(homed[1:])

    # The tiled all_gather, in shard order, and one scoring on slot 0.
    out, c_over = select_any(p_eff, *(torch.cat(lists[i::3], 1) for i in range(3)))
    st = torch.stack(stats)
    truncated = st[:, 1].amax(0) > 0
    if c_over is not None:
        truncated = truncated | c_over
    out["postings_scanned"] = st[:, 0].sum(0)
    out["truncated"] = truncated
    out["max_per_hash"] = st[:, 2].amax(0)
    out["max_blocks_per_hash"] = st[:, 3].amax(0)
    return out


@torch.inference_mode()
def sharded_search_batch(params: SearchParams, mesh: Mesh, file_tier, mem_tier, queries, q_lens, limits, min_scores, pcts):
    """(B, Q) batched hash-range-sharded search, the serving program: the
    tiers are search_tiers' per-slot fields; queries (B, Q) and the (B,)
    scalars are tensors, arrays or values.  Returns the single path's
    output dict of (B, ...) tensors on slot 0's device."""
    dev = mesh.device
    return _sharded_batch_impl(
        params, mesh, file_tier, mem_tier,
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
def sharded_search_batch_packed_io(params: SearchParams, mesh: Mesh, file_tier, mem_tier, packed_in, streams=None):
    """The sharded counterpart of search_segments_batch_packed_io: the
    int32 view of pack_inputs_np's array on slot 0's device in, the packed
    outputs out.  With `streams`, call it inside slot 0's stream: the
    outputs are queued there, behind every slot's work."""
    Q = params.query_len
    qs = u32(packed_in[:, :Q])
    lens, limits, min_scores, pcts = (packed_in[:, Q + k].to(torch.int64) for k in range(4))
    return pack_outputs(_sharded_batch_impl(params, mesh, file_tier, mem_tier, qs, lens, limits, min_scores, pcts, streams))


def sharded_ingest_step(mesh: Mesh, batch_hashes: np.ndarray, batch_ids: np.ndarray):
    """Partition an ingest batch by hash range on the host, sort each
    shard's (hash, docid) pairs on its slot's device
    (ops/build.sort_postings), and return the sorted runs stacked on slot
    0's device: two (n_shards, cap) int32 tensors of u32 patterns, SENTINEL
    behind each shard's pairs (the building block of a distributed segment
    build)."""
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
    runs = []
    for k in range(n):
        dev = mesh.slots[mesh.slot_of(k)]
        h_t, i_t = (torch.from_numpy(a[k].view(np.int32)).to(dev) for a in (h, i))
        runs.append([r.to(mesh.device) for r in sort_postings(h_t, i_t, int(cuts[k + 1] - cuts[k]))])
    return torch.stack([r[0] for r in runs]), torch.stack([r[1] for r in runs])

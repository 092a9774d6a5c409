"""Mesh-sharded serving (counterpart of acoustid_index_tpu/parallel/serving.py):
a drop-in BatchingSearcher that packs segment views by hash range over a
mesh (parallel/sharded.py: N shards over the slots' cards) and runs the
batched sharded program.

The engine stays oblivious: Index packs views through its searcher, so

  * the FILE tier's sharded view is rebuilt only at checkpoint and merge,
    and shared by reference across write snapshots;
  * the MEMORY tier repacks per write batch, partitioned by hash range on
    the host and placed on the slots' cards;
  * search coalesces concurrent requests exactly as BatchingSearcher does,
    and `_launch` queues ONE sharded program per batch: its inputs go up on
    slot 0's stream (the searcher's own), each slot's stages run on the
    slot's own stream (one per slot, so slots that share a card overlap
    too), slot 0's stream joins them, and the pinned copy-back waits behind
    an event there (Searcher._launch with the program and its tier fields
    swapped), so the native front and the legacy protocol pump through it
    unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..engine.searcher import BatchingSearcher
from ..engine.segments import _VIEW_TOKENS, FILE_SLOTS, MEMORY_SLOTS, slot_bucket
from .sharded import _pack_tier_sharded, make_mesh, put_sharded, sharded_search_batch_packed_io, slot_tiers


class ShardedBatchingSearcher(BatchingSearcher):
    """BatchingSearcher whose device views are hash-range sharded over a
    mesh and whose batch program is the sharded search."""

    def __init__(self, mesh=None, n_shards: Optional[int] = None, max_wait: float = 0.002, device=None):
        mesh = mesh if mesh is not None else make_mesh(n_shards, device)
        super().__init__(max_wait=max_wait, device=mesh.device)
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self._streams = None
        if self._stream is not None:
            self._streams = (self._stream, *(torch.cuda.Stream(d) for d in mesh.slots[1:]))

    # ---- view packing (called by the engine on tier changes) ----

    def _pack(self, segments: Sequence, slots: int, tier: str, owner) -> Dict:
        # Sticky high-water shapes per (owner, tier), as Searcher._pack_sticky
        # keeps them: a write-heavy index converges to one shape set per tier.
        with self._lock:
            hwm = list(self._hwm.get((owner, tier), (1024, 1024, 1024, 0)))
        view_np = _pack_tier_sharded(
            segments,
            self.n_shards,
            max(slot_bucket(len(segments), slots), min(hwm[3], slots)),
            min_caps=(hwm[0], hwm[1], hwm[2]),
        )
        # Device search fields are flat (n_shards * X,): per-shard caps
        # divide by the shard count.
        n = self.n_shards
        cap0 = view_np["inter"].shape[0] // (2 * n) if "inter" in view_np else view_np["hashes"].shape[0] // n
        grown = (
            int(cap0),
            int(view_np["docs_ids"].shape[1]),
            int(view_np["mention_ids"].shape[0] // n),
            int(view_np["seg_start"].shape[0] // n),
        )
        with self._lock:
            cur = self._hwm.setdefault((owner, tier), [1024, 1024, 1024, 0])
            for i in range(4):
                cur[i] = max(cur[i], grown[i])
        view = put_sharded(view_np, self.mesh, mentions=(tier == "mem"))  # only the memory tier's is read
        view["view_token"] = next(_VIEW_TOKENS)
        view["owner"] = owner
        return view

    def pack_file_tier(self, segments, owner=None) -> Dict:
        return self._pack(segments, FILE_SLOTS, "file", owner)

    def pack_mem_tier(self, segments, owner=None) -> Dict:
        return self._pack(segments, MEMORY_SLOTS, "mem", owner)

    # ---- batch execution ----

    @staticmethod
    def _search_views(snapshot):
        return slot_tiers(snapshot.file_view, mentions=False), slot_tiers(snapshot.mem_view)

    def _program(self, params, file_view, mem_view, inp):
        return sharded_search_batch_packed_io(params, self.mesh, file_view, mem_view, inp, self._streams)

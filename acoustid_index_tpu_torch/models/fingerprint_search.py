"""The exact-scoring fingerprint search program as a model (counterpart of
acoustid_index_tpu/models/fingerprint_search.py).

`ingest` builds the term table on the card (the "weights"), `forward` runs
the batched search program over a batch of queries (the "inference step").
The HTTP engine (engine/index.py) runs the same program through its
snapshots; this module is the direct surface for bulk workloads and
benchmarks.

What changed against the reference: the model is a torch.nn.Module on an
explicit device, and the term table is packed by the port's own packing
(engine/segments.pack_tier), so the search program gets the layout the
serving path gives a tier of that size (interleaved above the resident
cut-off, ops/layout.use_interleaved), not a hand-written dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.memseg import Segment
from ..engine.model import SegmentInfo
from ..engine.segments import pack_tier, tier_view_for_search
from ..ops.build import sort_postings
from ..ops.search_kernel import SearchParams, search_segments, search_segments_batch

FILE_SLOTS = 1  # bulk-load shape: one segment
MEMORY_SLOTS = 1


@dataclass
class TermTable:
    """A one-segment file tier with an empty memory tier -- the bulk-load
    shape: one immutable sorted table -- as the search program's views."""

    file_tier: dict
    mem_tier: dict
    n_postings: int
    n_docs: int


class FingerprintSearchModel(torch.nn.Module):
    def __init__(self, params: Optional[SearchParams] = None, device=None):
        super().__init__()
        self.params = params or SearchParams(query_len=64, postings_budget=8192)
        if device is None:
            from ..utils.device import device as default_device

            device = default_device()
        self.device = torch.device(device)

    # ---- "training": build the table on the device ----

    def ingest(self, hashes, doc_ids) -> TermTable:
        """Build a term table from (hash, doc_id) pairs, sorted on the
        device.  `hashes`/`doc_ids` are 1-D u32 arrays (one row per
        posting)."""
        hashes = np.ascontiguousarray(hashes, np.uint32)
        doc_ids = np.ascontiguousarray(doc_ids, np.uint32)
        if doc_ids.size and int(doc_ids.min()) == 0:
            # Doc id 0 is reserved engine-wide: the scoring key is docid-1,
            # and 0 would alias the invalid sentinel.
            raise ValueError("fingerprint id 0 is reserved")
        n = hashes.shape[0]
        d_ids = torch.from_numpy(doc_ids.view(np.int32)).to(self.device)
        h, d = sort_postings(torch.from_numpy(hashes.view(np.int32)).to(self.device), d_ids, n)
        docs = torch.unique(d_ids.to(torch.int64) & 0xFFFFFFFF).cpu().numpy().astype(np.uint32)
        seg = Segment(
            info=SegmentInfo(commit_id=1),
            hashes=h.cpu().numpy().view(np.uint32),
            docids=d.cpu().numpy().view(np.uint32),
            docs_ids=docs,
            docs_alive=np.ones(docs.shape[0], bool),
            min_doc_id=int(docs[0]) if docs.size else 0,
            max_doc_id=int(docs[-1]) if docs.size else 0,
        )
        del h, d, d_ids
        file_tier = pack_tier([seg], FILE_SLOTS, device_mentions=False, device=self.device)
        mem_tier = pack_tier([], MEMORY_SLOTS, device=self.device)
        return TermTable(
            file_tier=tier_view_for_search(file_tier, mentions=False),
            mem_tier=tier_view_for_search(mem_tier),
            n_postings=n,
            n_docs=int(docs.shape[0]),
        )

    # ---- "inference": batched search ----

    def forward(self, table: TermTable, queries, q_lens, limit: int = 10, min_score: int = 1, score_pct: int = 10):
        """Batched exact search.  `queries` is (B, Q) u32 (sorted, deduped,
        padded rows), `q_lens` is (B,).  Returns the program's output dict
        of (B, ...) tensors on the model's device."""
        B = queries.shape[0]
        return search_segments_batch(
            self.params,
            table.file_tier,
            table.mem_tier,
            queries,
            q_lens,
            np.full(B, limit),
            np.full(B, min_score),
            np.full(B, score_pct),
        )

    def forward_one(self, table: TermTable, query: Sequence[int], limit: int = 10, min_score: int = 1, score_pct: int = 10):
        q = np.unique(np.asarray(query, np.uint32))
        padded = np.zeros(self.params.query_len, np.uint32)
        padded[: q.shape[0]] = q
        return search_segments(self.params, table.file_tier, table.mem_tier, padded, q.shape[0], limit, min_score, score_pct)

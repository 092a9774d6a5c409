"""Driver entry point of the port (counterpart of the repository's
__graft_entry__.entry for the JAX package).

entry() -- the single-device forward step: the exact-scoring search program
over a packed two-tier view, on the port's device (the card unless
AITPU_TORCH_DEVICE says otherwise).  Returns (forward, example_args);
`forward(*example_args)` returns the output dict of one query.
"""

from __future__ import annotations

import numpy as np
import torch


def entry():
    from .engine.memseg import build_segment
    from .engine.model import Insert, SegmentInfo
    from .engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier, tier_view_for_search
    from .ops.search_kernel import SearchParams, _search_one
    from .utils.device import device

    dev = device()
    rng = np.random.default_rng(0)
    file_seg = build_segment(
        [Insert(id=i, hashes=rng.integers(0, 2**32, 16, dtype=np.uint32).tolist()) for i in range(1, 200)],
        SegmentInfo(commit_id=1),
    )
    mem_seg = build_segment(
        [Insert(id=i, hashes=rng.integers(0, 2**32, 16, dtype=np.uint32).tolist()) for i in range(150, 220)],
        SegmentInfo(commit_id=2),
    )
    file_view = tier_view_for_search(pack_tier([file_seg], FILE_SLOTS, device=dev))
    mem_view = tier_view_for_search(pack_tier([mem_seg], MEMORY_SLOTS, device=dev))

    params = SearchParams(query_len=64, postings_budget=4096)

    def forward(file_tier, mem_tier, query, q_len, limit, min_score, pct):
        return _search_one(params, file_tier, mem_tier, query, q_len, limit, min_score, pct)

    query = np.zeros(64, np.int64)
    query[:16] = np.sort(file_seg.hashes[:16])
    example_args = (
        file_view,
        mem_view,
        torch.from_numpy(query).to(dev),
        *(torch.tensor(v, device=dev) for v in (16, 10, 1, 10)),
    )
    return forward, example_args

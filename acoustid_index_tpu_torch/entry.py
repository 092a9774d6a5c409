"""Driver entry point of the port (counterpart of the repository's
__graft_entry__.entry for the JAX package).

entry() -- the single-device forward step: the exact-scoring search program
over a packed two-tier view, on the port's device (the card unless
AITPU_TORCH_DEVICE says otherwise).  Returns (forward, example_args);
`forward(*example_args)` returns the output dict of one query.

dryrun_multichip(n) -- the sharded path at n shards (parallel/): a sharded
ingest step, one sharded search, and an Index served by a
ShardedBatchingSearcher through write, checkpoint, write + delete and
search.  The n shards spread over the visible cards, up to one per shard
(all on the one card of a one-card host), unless the caller passes
`device` (make_mesh's devices) or AITPU_TORCH_DEVICE names one; it prints
the shard -> card map.  The reference's version forces n virtual CPU
devices instead.
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


def dryrun_multichip(n_devices: int, device=None) -> None:
    import tempfile

    from .engine.index import Index
    from .engine.memseg import build_segment
    from .engine.model import Delete, Insert, SearchOptions, SegmentInfo
    from .engine.segments import Snapshot
    from .ops.search_kernel import SearchParams
    from .parallel.serving import ShardedBatchingSearcher
    from .parallel.sharded import (
        build_sharded_view,
        describe_mesh,
        hash_bounds,
        make_mesh,
        sharded_ingest_step,
        sharded_search,
    )

    mesh = make_mesh(n_devices, device)
    print(f"dryrun_multichip({n_devices}): {describe_mesh(mesh)}")
    rng = np.random.default_rng(1)

    # Ingest step: hash-partition a write batch, sort per shard on the device.
    batch_h = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    batch_i = rng.integers(1, 500, 4096, dtype=np.uint32)
    sh, _si = sharded_ingest_step(mesh, batch_h, batch_i)
    sh = sh.cpu().numpy().view(np.uint32)
    bounds = hash_bounds(n_devices)
    for k in range(n_devices):
        run = sh[k][sh[k] != 0xFFFFFFFF].astype(np.int64)
        assert (np.diff(run) >= 0).all() and (run.size == 0 or bounds[k] <= run[0] and run[-1] < bounds[k + 1]), k

    # Search step: two-tier sharded snapshot, exact scoring across shards.
    docs1 = {i: rng.integers(0, 2**32, 24, dtype=np.uint32).tolist() for i in range(1, 60)}
    docs2 = {i: rng.integers(0, 2**32, 24, dtype=np.uint32).tolist() for i in range(50, 80)}
    f1 = build_segment([Insert(id=i, hashes=h) for i, h in docs1.items()], SegmentInfo(commit_id=1))
    m1 = build_segment(
        [Insert(id=i, hashes=h) for i, h in docs2.items()] + [Delete(id=5)],
        SegmentInfo(commit_id=2),
    )
    view = build_sharded_view(Snapshot(file=(f1,), memory=(m1,)), mesh)
    params = SearchParams(query_len=64, postings_budget=2048)
    q = np.unique(np.asarray(docs1[7] + docs2[55][:8], np.uint32))
    padded = np.zeros(64, np.uint32)
    padded[: q.shape[0]] = q
    out = sharded_search(params, mesh, view, padded, int(q.shape[0]), 10, 1, 10)
    n = int(out["count"])
    ids = out["ids"][:n].tolist()
    assert n >= 1 and 7 in ids, (ids, out)

    # Serving path: an Index whose searcher shards every view over the mesh
    # and dispatches the batched sharded program (--mesh-shards), through
    # write -> checkpoint -> write + delete -> batched search.
    with tempfile.TemporaryDirectory() as tmp:
        searcher = ShardedBatchingSearcher(mesh=mesh)
        idx = Index.open(tmp, checkpoint_age=None, searcher=searcher)
        try:
            idx.update([Insert(id=i, hashes=h) for i, h in docs1.items()])
            idx.checkpoint(force=True)  # sharded file-tier repack
            idx.update([Insert(id=i, hashes=h) for i, h in docs2.items()] + [Delete(id=5)])
            res, _ = idx.search(docs1[7], SearchOptions(max_results=5, min_score=1))
            assert res and res[0].id == 7, res
            res5, _ = idx.search(docs1[5], SearchOptions(max_results=5, min_score=1, min_score_pct=0))
            assert all(r.id != 5 for r in res5), res5  # tombstoned across shards
        finally:
            idx.close()
            searcher.close()

    cards = ", ".join(str(d) for d in dict.fromkeys(mesh.slots))
    print(f"dryrun_multichip({n_devices}): ingest + sharded search + sharded serving OK on {cards}, top={ids[:3]}")

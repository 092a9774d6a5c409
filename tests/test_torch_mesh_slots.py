"""The port's mesh over several cards (acoustid_index_tpu_torch/parallel/),
on the CPU.

A Mesh names its devices as slots; shard k lives on slot k * S // n, so a
slot holds a run of consecutive shards, and slots may repeat a device (the
CPU cases below run 2 and 3 slots, each a CPU device).  Here:

  * make_mesh's defaults and errors with the card count patched to 1, 2
    and 4: `cuda` without an index spreads up to one card per shard, an
    explicit card or the CPU gives one slot, a missing card raises, and
    there is no CPU fallback;
  * the shard -> slot map, and each shard's tier a view within its slot;
  * ShardedBatchingSearcher at 3 slots through an Index (writes,
    supersession, a checkpoint): answers equal to the oracle, at most two
    host syncs per batch;
  * sharded_ingest_step at 2 slots equal to one slot's, stacked on slot 0;
  * bench_100m.shard_tier of a window of the 134M corpus (build_tier on
    the CPU) equal to _pack_tier_sharded of the same postings field for
    field, at one slot (views) and at two (copies), and its answers through
    ShardedBatchingSearcher byte-equal to the single program's over the
    unsharded window and equal to the analytic oracle.

The cross-card copies themselves need several cards: chip_smoke.py phase
1e and `python -m acoustid_index_tpu_torch.bench_100m --mesh-shards 4`
run them where the host has them.
"""

import os

import numpy as np
import pytest
import torch

from acoustid_index_tpu_torch import bench_100m
from acoustid_index_tpu_torch.engine.index import Index
from acoustid_index_tpu_torch.engine.memseg import Segment
from acoustid_index_tpu_torch.engine.model import Delete, Insert, SearchOptions, SegmentInfo
from acoustid_index_tpu_torch.engine.searcher import Searcher
from acoustid_index_tpu_torch.engine.segments import MEMORY_SLOTS
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.ops import search_kernel as sk
from acoustid_index_tpu_torch.parallel import sharded as sh
from acoustid_index_tpu_torch.parallel.serving import ShardedBatchingSearcher

from oracle import OracleSegment, oracle_search


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


def _cards(monkeypatch, count):
    """A host with `count` visible cards, as make_mesh sees it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cuda")


# ---- make_mesh ----


@pytest.mark.parametrize("count", [1, 2, 4])
def test_make_mesh_spreads_over_the_visible_cards(monkeypatch, count):
    _cards(monkeypatch, count)
    for n in (1, 2, 3, 4, 8):
        mesh = sh.make_mesh(n)
        assert mesh.n_shards == n
        assert mesh.slots == tuple(torch.device("cuda", i) for i in range(min(n, count))), n
        assert mesh.device == torch.device("cuda", 0)
        # --mesh-shards N and dryrun_multichip(n) take this default.
        assert sh.make_mesh(n, "cuda").slots == mesh.slots
    assert sh.make_mesh(8, f"cuda:{count - 1}").slots == (torch.device("cuda", count - 1),)
    assert sh.make_mesh(8, "cpu").slots == (torch.device("cpu"),)
    assert sh.make_mesh(None).n_shards == 1


@pytest.mark.parametrize("count", [1, 2, 4])
def test_make_mesh_raises_with_no_fallback(monkeypatch, count):
    _cards(monkeypatch, count)
    for n in (0, -1):
        with pytest.raises(ValueError):
            sh.make_mesh(n)
    with pytest.raises(ValueError):  # more slots than shards
        sh.make_mesh(2, ["cuda:0"] * 3)
    with pytest.raises(RuntimeError):  # a slot whose card is absent
        sh.make_mesh(8, f"cuda:{count}")
    with pytest.raises(RuntimeError):
        sh.make_mesh(8, [f"cuda:{i}" for i in range(count + 1)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):  # no card: an error, not the CPU
        sh.make_mesh(4)
    with pytest.raises(RuntimeError):
        sh.make_mesh(4, ["cuda:0"])


@pytest.mark.parametrize("n,slots,runs", [(1, 1, [1]), (2, 2, [1, 1]), (8, 1, [8]), (8, 3, [3, 3, 2]), (4, 4, [1] * 4),
                                          (5, 2, [3, 2]), (8, 8, [1] * 8)])
def test_shard_to_slot_map(n, slots, runs):
    mesh = sh.make_mesh(n, ["cpu"] * slots)
    ranges = [mesh.shard_range(s) for s in range(slots)]
    assert [b - a for a, b in ranges] == runs
    assert ranges[0][0] == 0 and ranges[-1][1] == n and all(ranges[s][1] == ranges[s + 1][0] for s in range(slots - 1))
    assert [mesh.slot_of(k) for k in range(n)] == [s for s, r in enumerate(runs) for _ in range(r)]
    assert [mesh.slot_of(k) for k in range(n)] == [k * slots // n for k in range(n)]


def _docs(rng, ids, width=12):
    return {i: rng.integers(0, 2**32, width, dtype=np.uint32).tolist() for i in ids}


def test_local_tier_is_a_view_within_its_slot():
    from acoustid_index_tpu_torch.engine.memseg import build_segment
    from acoustid_index_tpu_torch.engine.segments import Snapshot

    rng = np.random.default_rng(5)
    f1 = build_segment([Insert(id=i, hashes=h) for i, h in _docs(rng, range(1, 80)).items()], SegmentInfo(commit_id=1))
    m1 = build_segment([Insert(id=i, hashes=h) for i, h in _docs(rng, range(70, 90)).items()], SegmentInfo(commit_id=2))
    mesh = sh.make_mesh(8, ["cpu"] * 3)
    view = sh.build_sharded_view(Snapshot(file=(f1,), memory=(m1,)), mesh)
    mem_np = sh._pack_tier_sharded([m1], 8, 8)
    f_t, m_t = sh.search_tiers(view)
    assert "mention_ids" not in f_t[0] and "mention_len" in m_t[0]
    for tier in (f_t, m_t):
        for k in range(8):
            s = mesh.slot_of(k)
            a, b = mesh.shard_range(s)
            local = sh._local_tier(tier, k, mesh)
            for key, v in local.items():
                assert v.untyped_storage().data_ptr() == tier[s][key].untyped_storage().data_ptr(), key
                if key == "mention_len":
                    assert int(v) == int(mem_np["mention_len"][k])
                else:
                    assert v.shape[0] * (b - a) == tier[s][key].shape[0]
                    assert v.storage_offset() == (k - a) * v.shape[0]


# ---- serving at 3 slots ----


def test_sharded_searcher_at_three_slots_matches_oracle(tmp_path):
    rng = np.random.default_rng(12)
    searcher = ShardedBatchingSearcher(sh.make_mesh(8, ["cpu"] * 3))
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    try:
        docs = _docs(rng, range(1, 121))
        idx.update([Insert(id=i, hashes=h) for i, h in docs.items()])
        assert idx.checkpoint(force=True)
        rewritten = _docs(rng, (4, 60, 100))
        docs.update(rewritten)
        idx.update([Insert(id=i, hashes=h) for i, h in rewritten.items()] + [Delete(id=9), Delete(id=77)])
        docs.pop(9), docs.pop(77)
        snapshot = idx.acquire_reader()
        segs = [OracleSegment(list(zip(s.hashes.tolist(), s.docids.tolist())), dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())))
                for s in snapshot.all_segments()]
        syncs = batches = 0
        for target in (4, 9, 30, 60, 77, 100, 118):
            base = docs.get(target, rng.integers(0, 2**32, 12, dtype=np.uint32).tolist())
            query = list(base[:9]) + rng.integers(0, 2**32, 3, dtype=np.uint32).tolist()
            syncs0, batches0 = sk.STATS["host_syncs"], sh.STATS["batches"]
            res, _stats = idx.search(query, SearchOptions(max_results=20, min_score=1, min_score_pct=0))
            syncs += sk.STATS["host_syncs"] - syncs0
            batches += sh.STATS["batches"] - batches0
            got = [(r.id, r.score) for r in res]
            assert got == oracle_search(segs, query, limit=20, min_score=1, pct=0), target
            if target in docs:
                assert got[0][0] == target
        assert batches == 7 and syncs <= 2 * batches
        # The mention gate opened (the memory tier mentions candidates): two
        # syncs in those batches, one fetch of every slot's gates.
        assert syncs > batches
    finally:
        idx.close()
        searcher.close()


def test_ingest_step_at_two_slots():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    i = rng.integers(1, 1000, 3000, dtype=np.uint32)
    want = sh.sharded_ingest_step(sh.make_mesh(4, "cpu"), h, i)
    got = sh.sharded_ingest_step(sh.make_mesh(4, ["cpu"] * 2), h, i)
    for g, w in zip(got, want):
        assert g.device == torch.device("cpu") and g.shape[0] == 4
        assert torch.equal(g, w)


# ---- bench_100m's 134M tier over 4 shards, on a window ----

P0, P1 = (1 << 21) - (1 << 14), (1 << 21) + (1 << 14)  # 2^15 positions: 2^16 postings per shard, interleaved
HOT = [j * bench_100m.BAND + ((1 << 21) - 64 * j) * 4 for j in range(8)]  # band j's hot run in the window


@pytest.fixture(scope="module")
def window():
    """(the window's single tier, its Segment) built on the CPU."""
    old = os.environ.get("AITPU_RESIDENT_MAX_BYTES")
    os.environ["AITPU_RESIDENT_MAX_BYTES"] = str(64 * 1024)
    try:
        snap = bench_100m.build_tier("cpu", P0, P1)
    finally:
        if old is None:
            os.environ.pop("AITPU_RESIDENT_MAX_BYTES")
        else:
            os.environ["AITPU_RESIDENT_MAX_BYTES"] = old
    pos = np.arange(P0, P1)
    hs = np.concatenate([(np.uint64(j) * bench_100m.BAND + bench_100m._f_np(pos, j)).astype(np.uint32) for j in range(8)])
    ds = np.tile(bench_100m.np_bitrev27(pos) + np.uint32(1), 8)
    order = np.lexsort((ds, hs))
    ids = np.unique(ds)
    seg = Segment(SegmentInfo(commit_id=1), hs[order], ds[order], ids, np.ones(ids.shape[0], bool), int(ids[0]), int(ids[-1]))
    return snap, seg


@pytest.mark.parametrize("slots", [1, 2])
def test_shard_tier_equals_pack_tier_sharded(window, slots, monkeypatch):
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))
    snap, seg = window
    mesh = sh.make_mesh(bench_100m.MESH_SHARDS, ["cpu"] * slots)
    got = bench_100m.shard_tier(snap, mesh)
    want = sh.put_sharded(sh._pack_tier_sharded([seg], mesh.n_shards, 1), mesh, mentions=False)
    assert "inter" in want["slots"][0]
    for s in range(slots):
        g, w = got.file_view["slots"][s], want["slots"][s]
        assert set(g) == set(w), s
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if k != "inter":
                assert torch.equal(g[k], w[k]), k
        # Same hashes entry for entry; the same (hash, docid) pairs in the
        # slot (within a run of one hash the tier keeps position order).
        g2, w2 = (t["inter"].view(-1, 2, 1024) for t in (g, w))
        assert torch.equal(g2[:, 0], w2[:, 0])
        pairs = [np.sort((t[:, 0].numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
                         | t[:, 1].numpy().view(np.uint32), axis=None) for t in (g2, w2)]
        np.testing.assert_array_equal(*pairs)
        shares = g["inter"].untyped_storage().data_ptr() == snap.file_view["inter"].untyped_storage().data_ptr()
        assert shares == (slots == 1)  # views on one slot, copies on several
    mem = sh.put_sharded(sh._pack_tier_sharded([], mesh.n_shards, MEMORY_SLOTS), mesh)
    for s in range(slots):
        assert all(torch.equal(got.mem_view["slots"][s][k], mem["slots"][s][k]) for k in mem["slots"][s])


def _window_batches(seed):
    rng = np.random.default_rng(seed)
    batches = [bench_100m.make_queries(rng, 8, P0, P1), bench_100m.boundary_queries(rng, 8, P1)]
    targets, qs, lens = bench_100m.make_queries(rng, 8, P0, P1)
    for b in range(0, 8, 2):  # hot hashes: the gather branches
        q = np.unique(np.concatenate([qs[b, : lens[b]], np.asarray(HOT[: 1 + b], np.uint32)]))
        qs[b, : q.shape[0]], lens[b] = q, q.shape[0]
    return batches + [(targets, qs, lens)]


@pytest.mark.parametrize("slots", [1, 2])
def test_shard_tier_answers_equal_single_program_and_oracle(window, slots):
    snap, _ = window
    mesh = sh.make_mesh(bench_100m.MESH_SHARDS, ["cpu"] * slots)
    sharded = bench_100m.shard_tier(snap, mesh)
    searcher, single = ShardedBatchingSearcher(mesh), Searcher("cpu")
    p = bench_100m.params()
    launches0 = dict(port_bl.LAUNCHES)
    for label, (targets, qs, lens) in zip(("batch", "boundary", "hot"), _window_batches(9)):
        packed = bench_100m.pack(qs, lens)
        syncs0 = sk.STATS["host_syncs"]
        got = searcher._fetch(searcher._launch(sharded, p, packed))
        assert sk.STATS["host_syncs"] - syncs0 <= 2
        want = single._fetch(single._launch(snap, p, packed))
        np.testing.assert_array_equal(got, want, err_msg=label)  # the packed outputs, byte for byte
        out = sk.unpack_outputs_np(got, p.out_len)

        def oracle(q):
            return oracle_search([OracleSegment(bench_100m.oracle_postings(q, P0, P1), {})], q, limit=bench_100m.LIMIT,
                                 min_score=bench_100m.MIN_SCORE, pct=bench_100m.PCT)

        bench_100m.check_answers(label, targets, qs, lens, out["ids"], out["scores"], out["count"], oracle)
    assert launches0 == port_bl.LAUNCHES  # the CPU runs the kernels' plain versions

"""The port's device merge (ops/build.py, engine/device_merge.py) against
the JAX package's and against the host merger, bit for bit.

The kernels' functions of both packages get the same packed numpy inputs
(padded as the reference pads them) and must agree on the live prefixes;
the port's merge_segments_device and merge_segments_auto must give the
host memseg.merge_segments Segment in every field.  Edge cases: hash and
doc id 0xFFFFFFFF, one posting, empty and tombstone-only sources, 64
sources.  Runs with AITPU_TORCH_DEVICE=cpu.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acoustid_index_tpu.ops import build as ref_build
from acoustid_index_tpu_torch.engine import device_merge
from acoustid_index_tpu_torch.engine.memseg import build_segment, merge_segments
from acoustid_index_tpu_torch.engine.model import Delete, Insert, SegmentInfo
from acoustid_index_tpu_torch.engine.segments import Snapshot
from acoustid_index_tpu_torch.ops import build as port_build

FFFF = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("AITPU_DEVICE_MERGE_MIN_POSTINGS", raising=False)


def _segments(seed, n_src, n_ids=50, max_h=8, ffff=False, empty=(), tomb_only=(), one=False):
    """Sources oldest -> newest (commit ids 1..n_src): random re-inserts and
    deletes across sources; `ffff` adds doc 0xFFFFFFFF (inserted, re-inserted
    and deleted in turn) and hash 0xFFFFFFFF in every inserting source."""
    rng = np.random.default_rng(seed)
    segs = []
    for k in range(n_src):
        if one:
            changes = [Insert(id=int(rng.integers(1, n_ids)), hashes=[int(rng.integers(0, 2**32))])]
        elif k in empty:
            changes = []
        elif k in tomb_only:
            changes = [Delete(id=int(i)) for i in rng.integers(1, n_ids, 3)]
        else:
            docs = {
                int(rng.integers(1, n_ids)): rng.integers(0, 1000, int(rng.integers(1, max_h)), dtype=np.uint32).tolist()
                for _ in range(int(rng.integers(2, 10)))
            }
            deletes = [int(x) for x in rng.integers(1, n_ids, 2) if int(x) not in docs]
            changes = [Insert(id=i, hashes=h) for i, h in docs.items()] + [Delete(id=i) for i in deletes]
            if ffff:
                changes.append(Insert(id=int(rng.integers(1, n_ids)), hashes=[FFFF, 7]))
                changes.append(Delete(id=FFFF) if k % 3 == 2 else Insert(id=FFFF, hashes=[FFFF, FFFF, k + 1]))
        segs.append(build_segment(changes, SegmentInfo(commit_id=k + 1)))
    return segs


def _pack(segments, cap, dcap):
    """The reference tests' contiguous packing, padded to (cap, dcap)."""
    S = len(segments)
    out = {
        "hashes": np.full(cap, FFFF, np.uint32),
        "docids": np.full(cap, FFFF, np.uint32),
        "seg_start": np.zeros(S, np.int32),
        "seg_len": np.zeros(S, np.int32),
        "docs_ids": np.full(dcap, FFFF, np.uint32),
        "docs_alive": np.zeros(dcap, np.int32),
        "docs_start": np.zeros(S, np.int32),
        "docs_len": np.zeros(S, np.int32),
    }
    pos = dpos = 0
    for k, s in enumerate(segments):
        out["seg_start"][k], out["seg_len"][k] = pos, s.num_items
        out["hashes"][pos : pos + s.num_items] = s.hashes
        out["docids"][pos : pos + s.num_items] = s.docids
        pos += s.num_items
        out["docs_start"][k], out["docs_len"][k] = dpos, s.num_docs
        out["docs_ids"][dpos : dpos + s.num_docs] = s.docs_ids
        out["docs_alive"][dpos : dpos + s.num_docs] = s.docs_alive
        dpos += s.num_docs
    return list(out.values())


def _torch(a):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u32(t):
    return t.numpy().view(np.uint32)


def _segments_equal(a, b):
    assert a.info == b.info
    for f in ("hashes", "docids", "docs_ids", "docs_alive"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.min_doc_id, a.max_doc_id) == (b.min_doc_id, b.max_doc_id)
    assert dict(a.metadata) == dict(b.metadata)


SORT_CASES = {
    "random": (1000, 1000, False),
    "padded": (1024, 700, False),
    "ffff": (1024, 900, True),
    "one_posting": (1024, 1, False),
    "empty": (1024, 0, False),
}


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_sort_postings_matches_reference(case):
    size, n, ffff = SORT_CASES[case]
    rng = np.random.default_rng(len(case))
    h = rng.integers(0, 2**32, size, dtype=np.uint32)
    d = rng.integers(1, 2**32, size, dtype=np.uint32)
    h[::7] = h[3]  # equal hashes, ids decide
    if ffff:
        h[::5], d[::3] = FFFF, FFFF
    want_h, want_d = (np.asarray(x) for x in ref_build.sort_postings(jnp.asarray(h), jnp.asarray(d), n))
    got_h, got_d = port_build.sort_postings(_torch(h), _torch(d), n)
    assert got_h.shape == (size,) and got_d.shape == (size,)
    assert np.array_equal(_u32(got_h), want_h) and np.array_equal(_u32(got_d), want_d)


MERGE_CASES = {
    "random": dict(seed=1, n_src=4),
    "ffff": dict(seed=2, n_src=6, ffff=True),
    "one_posting": dict(seed=3, n_src=1, one=True),
    "empty_and_tombstone_only": dict(seed=4, n_src=6, empty=(0, 3), tomb_only=(1, 5)),
    "all_empty": dict(seed=5, n_src=3, empty=(0, 1, 2)),
    "sources_64": dict(seed=6, n_src=64, n_ids=200, ffff=True),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_postings_live_matches_reference(case):
    segs = _segments(**MERGE_CASES[case])
    total = sum(s.num_items for s in segs)
    dtotal = sum(s.num_docs for s in segs)
    packed = _pack(segs, cap=-(-max(total, 1) // 1024) * 1024, dcap=-(-max(dtotal, 1) // 256) * 256)
    want = [np.asarray(x) for x in ref_build.merge_postings_live(*(jnp.asarray(a) for a in packed))]
    got = port_build.merge_postings_live(*(_torch(a) for a in packed))
    n_kept, n_docs = int(want[2]), int(want[5])
    assert (int(got[2]), int(got[5])) == (n_kept, n_docs)
    assert np.array_equal(_u32(got[0])[:n_kept], want[0][:n_kept])
    assert np.array_equal(_u32(got[1])[:n_kept], want[1][:n_kept])
    assert np.array_equal(_u32(got[3])[:n_docs], want[3][:n_docs])
    assert np.array_equal(got[4].numpy()[:n_docs], want[4][:n_docs])

    # The same run without padding (as device_merge packs it), against the
    # host merger with the run as the whole collection.
    host = merge_segments(segs, Snapshot(file=tuple(segs)))
    exact = port_build.merge_postings_live(*(_torch(a) for a in _pack(segs, total, dtotal)))
    n_kept, n_docs = host.num_items, host.num_docs
    assert (int(exact[2]), int(exact[5])) == (n_kept, n_docs)
    assert np.array_equal(_u32(exact[0])[:n_kept], host.hashes) and np.array_equal(_u32(exact[1])[:n_kept], host.docids)
    assert np.array_equal(_u32(exact[3])[:n_docs], host.docs_ids)
    assert np.array_equal(exact[4].numpy()[:n_docs].astype(bool), host.docs_alive)
    # Behind the live prefixes: SENTINEL padding, tombstone flags 0.
    assert (_u32(exact[0])[n_kept:] == FFFF).all() and (_u32(exact[3])[n_docs:] == FFFF).all()
    assert not exact[4].numpy()[n_docs:].any()


# ---- tests/test_device_merge.py, mirrored on the port ----


def test_device_merge_matches_host_merger():
    segs = _segments(seed=1, n_src=4)
    collection = Snapshot(file=tuple(segs), memory=())
    want = merge_segments(segs, collection)
    h, d, n_kept, did, dalive, n_docs = port_build.merge_postings_live(*(_torch(a) for a in _pack(segs, 1024, 256)))
    n_kept, n_docs = int(n_kept), int(n_docs)
    assert n_kept == want.num_items and n_docs == want.num_docs
    assert np.array_equal(_u32(h)[:n_kept], want.hashes)
    assert np.array_equal(_u32(d)[:n_kept], want.docids)
    assert np.array_equal(_u32(did)[:n_docs], want.docs_ids)
    assert np.array_equal(dalive.numpy()[:n_docs].astype(bool), want.docs_alive)


@pytest.mark.parametrize("ffff", [False, True], ids=["random", "ffff"])
def test_engine_device_merge_matches_host_bit_for_bit(ffff):
    """merge_segments_device == merge_segments, including supersession from
    OUTSIDE the run: docs rewritten or deleted in segments newer than the
    merged run are dropped by both paths."""
    segs = _segments(seed=3, n_src=5, n_ids=80, max_h=10, ffff=ffff)
    collection = Snapshot(file=tuple(segs), memory=())
    for run in (segs[:3], segs[1:4], segs):  # 4-5, 5 and nothing newer than the run
        _segments_equal(device_merge.merge_segments_device(run, collection), merge_segments(run, collection))


def test_checkpoint_runs_device_merge_and_matches(tmp_path, monkeypatch):
    """An Index checkpoint above the device threshold runs the device merge,
    counts it, and writes the same file segment as the host path."""
    from acoustid_index_tpu_torch.engine.index import Index
    from acoustid_index_tpu_torch.engine.searcher import Searcher

    calls = {"device": 0}
    orig = device_merge.merge_segments_device

    def spy(sources, collection):
        calls["device"] += 1
        return orig(sources, collection)

    monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", 100)
    monkeypatch.setattr(device_merge, "merge_segments_device", spy)

    rng = np.random.default_rng(4)
    all_changes = []
    searcher = Searcher(device="cpu")
    idx = Index.open(str(tmp_path / "dev"), checkpoint_age=None, searcher=searcher)
    try:
        for batch in range(3):
            changes = [
                Insert(id=batch * 30 + i, hashes=rng.integers(0, 2**32, 8, dtype=np.uint32).tolist())
                for i in range(1, 31)
            ]
            all_changes.append(changes)
            idx.update(changes)
        assert idx.checkpoint(force=True)
        assert calls["device"] == 1
        assert idx.merge_counts.as_dict() == {"device": 1, "host": 0, "fallback": 0}
        dev_seg = idx.acquire_reader().file[0]
    finally:
        idx.close()

    # Host reference: same batches, threshold too high for the device path.
    monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", 10**12)
    idx2 = Index.open(str(tmp_path / "host"), checkpoint_age=None, searcher=searcher)
    try:
        for changes in all_changes:
            idx2.update(changes)
        assert idx2.checkpoint(force=True)
        assert idx2.merge_counts.as_dict() == {"device": 0, "host": 1, "fallback": 0}
        host_seg = idx2.acquire_reader().file[0]
    finally:
        idx2.close()
    assert calls["device"] == 1
    _segments_equal(dev_seg, host_seg)


# ---- routing and the visible fallback ----


ROUTES = {
    # (sources, threshold, env override, expected route)
    "device": (4, 10, None, "device"),
    "below_threshold": (4, 10**9, None, "host"),
    "env_override": (4, 10**9, "10", "device"),
    "one_source": (1, 0, None, "host"),
    "over_64_sources": (65, 0, None, "host"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_merge_segments_auto_routes(case, monkeypatch):
    n_src, threshold, env, route = ROUTES[case]
    monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", threshold)
    if env:
        monkeypatch.setenv("AITPU_DEVICE_MERGE_MIN_POSTINGS", env)
    segs = _segments(seed=7, n_src=n_src, n_ids=300)
    collection = Snapshot(file=tuple(segs))
    counts = device_merge.MergeCounts()
    _segments_equal(device_merge.merge_segments_auto(segs, collection, counts), merge_segments(segs, collection))
    assert counts.as_dict() == {"device": int(route == "device"), "host": int(route == "host"), "fallback": 0}


def test_device_failure_falls_back_visibly(monkeypatch, caplog):
    """A device merge that raises is redone on the host, logged with its
    traceback and counted; the result is the host merger's."""
    from acoustid_index_tpu_torch.server import metrics

    def boom(sources, collection):
        raise RuntimeError("device merge exploded")

    monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", 1)
    monkeypatch.setattr(device_merge, "merge_segments_device", boom)
    segs = _segments(seed=8, n_src=4)
    collection = Snapshot(file=tuple(segs))
    counts = device_merge.MergeCounts()
    before = metrics.render()
    with caplog.at_level("ERROR", logger="acoustid_index_tpu_torch.device_merge"):
        got = device_merge.merge_segments_auto(segs, collection, counts)
    _segments_equal(got, merge_segments(segs, collection))
    assert counts.as_dict() == {"device": 0, "host": 1, "fallback": 1}
    assert any(r.exc_info and "device merge exploded" in str(r.exc_info[1]) for r in caplog.records)
    assert "aitpu_merges_fallback_total" in metrics.render() and metrics.render() != before

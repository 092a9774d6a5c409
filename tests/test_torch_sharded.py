"""The port's hash-range sharded program (acoustid_index_tpu_torch/parallel/)
against the JAX package's, exactly.

The cases are those of tests/test_sharded.py and tests/test_sharded_blocked.py,
one for one, each at (shards, slots) = (1, 1), (2, 1), (2, 2), (8, 1) and
(8, 3): three slots over 8 shards hold runs of 3, 3 and 2.  Every case
builds its segments in both packages from the same changes (each package
with its own model and memseg), checks that both packages'
_pack_tier_sharded agree field for field, and feeds one packed query batch
to:

  * the reference's sharded_search_batch on the virtual 8-device CPU mesh
    of tests/conftest.py (Pallas in interpret mode), once per case and
    shard count (`_reference`);
  * the port's sharded_search_batch_packed (N shards over the slots, each
    slot a CPU device; the kernels' plain versions);
  * the port's single path (search_segments_batch_packed_io).

All seven output fields must equal the reference's (tolerance 0: integers
and flags); ids, scores and counts must equal the port's single path and,
where no row truncated, tests/oracle.py.  Each batch asserts the branches it
took (parallel.sharded.STATS) and at most two host syncs.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustid_index_tpu.engine import memseg as ref_memseg
from acoustid_index_tpu.engine import model as ref_model
from acoustid_index_tpu.engine.segments import Snapshot as RefSnapshot
from acoustid_index_tpu.ops import search_kernel as ref_sk
from acoustid_index_tpu.parallel import sharded as ref_sharded
from acoustid_index_tpu_torch.engine import memseg as port_memseg
from acoustid_index_tpu_torch.engine import model as port_model
from acoustid_index_tpu_torch.engine import segments as port_segments
from acoustid_index_tpu_torch.engine.segments import FILE_SLOTS, MEMORY_SLOTS
from acoustid_index_tpu_torch.engine.segments import Snapshot as PortSnapshot
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.ops import search_kernel as port_sk
from acoustid_index_tpu_torch.ops.layout import BLOCK
from acoustid_index_tpu_torch.parallel import sharded as port_sharded

from oracle import OracleSegment, oracle_search

os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

FIELDS = ("ids", "scores", "count", "postings_scanned", "truncated", "max_per_hash", "max_blocks_per_hash")
B = 8  # every batch pads to 8 rows
# (shards, slots); the ids of one slot are the shard counts alone.
MESHES = [pytest.param(1, 1, id="1"), pytest.param(2, 1, id="2"), pytest.param(2, 2, id="2x2"),
          pytest.param(8, 1, id="8"), pytest.param(8, 3, id="8x3")]
_REFERENCE = {}  # (shards, inputs digest) -> the reference's outputs


@pytest.fixture(autouse=True)
def _small_interpret_steps(monkeypatch):
    # Results do not depend on the reference kernels' lookups per grid
    # step; small steps keep their interpret-mode runs fast.
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


def seg_from_docs(docs, commit_id, deletes=()):
    """(reference segment, port segment) of the same inserts then deletes."""
    out = []
    for model, memseg in ((ref_model, ref_memseg), (port_model, port_memseg)):
        changes = [model.Insert(id=int(i), hashes=list(h)) for i, h in docs.items()]
        changes += [model.Delete(id=int(i)) for i in deletes]
        out.append(memseg.build_segment(changes, model.SegmentInfo(commit_id=commit_id)))
    return tuple(out)


def to_oracle(seg):
    return OracleSegment(
        list(zip(seg.hashes.tolist(), seg.docids.tolist())),
        dict(zip(seg.docs_ids.tolist(), seg.docs_alive.tolist())),
    )


def assert_packs_equal(segs, n, slots):
    """Both packages' _pack_tier_sharded, field for field."""
    want = ref_sharded._pack_tier_sharded([r for r, _ in segs], n, slots)
    got = port_sharded._pack_tier_sharded([p for _, p in segs], n, slots)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _reference(file_segs, mem_segs, params, n, batch):
    """The reference's sharded_search_batch at n shards, and its packing
    held to the port's, once per case and shard count: the meshes of one
    shard count share it."""
    digest = hashlib.sha256(repr((params, os.environ.get("AITPU_RESIDENT_MAX_BYTES"))).encode())
    for tier in (file_segs, mem_segs):
        digest.update(b"|")
        for _, seg in tier:
            for a in (seg.hashes, seg.docids, seg.docs_ids, seg.docs_alive):
                digest.update(np.ascontiguousarray(a).tobytes())
    for a in batch:
        digest.update(a.tobytes())
    key = (n, digest.hexdigest())
    if key not in _REFERENCE:
        assert_packs_equal(file_segs, n, 16)
        assert_packs_equal(mem_segs, n, 8)
        mesh = ref_sharded.make_mesh(n)
        view = ref_sharded.build_sharded_view(
            RefSnapshot(file=tuple(r for r, _ in file_segs), memory=tuple(r for r, _ in mem_segs)), mesh)
        _REFERENCE[key] = jax.device_get(ref_sharded.sharded_search_batch(
            params, mesh, *ref_sharded.search_tiers(view), *(jnp.asarray(a) for a in batch)))
    return _REFERENCE[key]


def run_sharded(file_segs, mem_segs, requests, params, n, branches, slots=1):
    """One batch of `requests` [(query, limit, min_score, pct)] through both
    packages' sharded programs at n shards (the port's over `slots` CPU
    slots) and the port's single path; `branches` are the
    parallel.sharded.STATS keys the batch must bump.  Returns the port's
    outputs as numpy."""
    Q = params.query_len

    qs = np.zeros((B, Q), np.uint32)
    lens = np.zeros(B, np.int32)
    limits = np.ones(B, np.int32)
    min_scores = np.zeros(B, np.int32)
    pcts = np.zeros(B, np.int32)
    for i, (q, limit, ms, pct) in enumerate(requests):
        q = np.unique(np.asarray(q, np.uint32))[:Q]
        qs[i, : q.shape[0]] = q
        lens[i], limits[i], min_scores[i], pcts[i] = q.shape[0], limit, ms, pct

    want = _reference(file_segs, mem_segs, params, n, (qs, lens, limits, min_scores, pcts))

    pmesh = port_sharded.make_mesh(n, ["cpu"] * slots)
    pview = port_sharded.build_sharded_view(
        PortSnapshot(file=tuple(p for _, p in file_segs), memory=tuple(p for _, p in mem_segs)), pmesh
    )
    stats0, syncs0 = dict(port_sharded.STATS), port_sk.STATS["host_syncs"]
    got = port_sharded.sharded_search_batch_packed(
        params, pmesh, *port_sharded.search_tiers(pview), qs, lens, limits, min_scores, pcts
    )
    taken = {k: port_sharded.STATS[k] - stats0[k] for k in port_sharded.STATS if port_sharded.STATS[k] != stats0[k]}
    assert taken == {"batches": 1, **{b: 1 for b in branches}}, taken
    assert port_sk.STATS["host_syncs"] - syncs0 <= 2
    got = port_sk.unpack_outputs_np(got.numpy().view(np.uint32), params.out_len)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f].astype(np.int64), np.asarray(want[f]).astype(np.int64), err_msg=f)

    # The port's single path on the same segments and batch.
    f_view = port_segments.tier_view_for_search(
        port_segments.pack_tier([p for _, p in file_segs], FILE_SLOTS, device_mentions=False, device="cpu"), mentions=False
    )
    m_view = port_segments.tier_view_for_search(port_segments.pack_tier([p for _, p in mem_segs], MEMORY_SLOTS, device="cpu"))
    packed = port_sk.pack_inputs_np(qs, lens.astype(np.uint32), limits.astype(np.uint32), min_scores.astype(np.uint32), pcts.astype(np.uint32))
    single = port_sk.unpack_outputs_np(
        port_sk.search_segments_batch_packed_io(params, f_view, m_view, torch.from_numpy(packed.view(np.int32))).numpy().view(np.uint32),
        params.out_len,
    )
    for f in ("ids", "scores", "count"):
        np.testing.assert_array_equal(got[f].astype(np.int64), single[f].astype(np.int64), err_msg=f)

    oracle_segs = [to_oracle(p) for _, p in list(file_segs) + list(mem_segs)]
    for i, (q, limit, ms, pct) in enumerate(requests if not got["truncated"].any() else ()):
        c = int(got["count"][i])
        res = list(zip(got["ids"][i, :c].tolist(), got["scores"][i, :c].tolist()))
        assert res == oracle_search(oracle_segs, q, limit=limit, min_score=ms, pct=pct), i
    return got


def results(out, i):
    c = int(out["count"][i])
    return list(zip(out["ids"][i, :c].tolist(), out["scores"][i, :c].tolist()))


def gather_branches(params, n, total_small=True):
    """The gather path's branch keys at n shards, by the reference's static
    rules: P_SMALL when candidate_cap <= n * P_SMALL and every shard's rough
    total fits; the joined width decides the scorer."""
    small = total_small and params.postings_budget > port_sk.P_SMALL and params.candidate_cap <= n * port_sk.P_SMALL
    width = n * (port_sk.P_SMALL if small else params.postings_budget)
    return ["small" if small else "full", "select_matrix" if width <= port_sharded.MATRIX_MAX else "select_sorted"]


# ---- tests/test_sharded.py ----


@pytest.mark.parametrize("n,slots", MESHES)
def test_sharded_matches_single_device_basic(n, slots):
    rng = np.random.default_rng(42)
    # Hashes spread over the whole u32 space so every shard owns some.
    docs1 = {i: rng.integers(0, 2**32, 20, dtype=np.uint32).tolist() for i in range(1, 30)}
    docs2 = {i: rng.integers(0, 2**32, 20, dtype=np.uint32).tolist() for i in range(25, 40)}
    f1 = seg_from_docs(docs1, 1)
    m1 = seg_from_docs(docs2, 2, deletes=[3, 7])
    query = docs1[5][:10] + docs2[30][:10] + docs1[3][:5]
    params = ref_sk.SearchParams(query_len=64, postings_budget=4096)
    out = run_sharded([f1], [m1], [(query, 20, 1, 0)], params, n, gather_branches(params, n), slots)
    assert results(out, 0)[:2] == [(5, 10), (30, 10)]


@pytest.mark.parametrize("n,slots", MESHES)
@pytest.mark.parametrize("seed", range(3))
def test_sharded_matches_single_device_randomized(seed, n, slots):
    rng = np.random.default_rng(seed)
    segs = []
    commit = 1
    for _ in range(int(rng.integers(1, 4))):
        docs = {
            int(rng.integers(1, 60)): rng.integers(0, 2**32, int(rng.integers(1, 15)), dtype=np.uint32).tolist()
            for _ in range(int(rng.integers(1, 10)))
        }
        deletes = [int(x) for x in rng.integers(1, 60, int(rng.integers(0, 3)))]
        deletes = [x for x in deletes if x not in docs]
        segs.append(seg_from_docs(docs, commit, deletes))
        commit += 1
    n_file = int(rng.integers(0, len(segs) + 1))
    file_segs, mem_segs = segs[:n_file], segs[n_file:]
    hashes = [p.hashes for _, p in segs if p.num_items]
    all_hashes = np.concatenate(hashes) if hashes else np.array([1], np.uint32)
    requests = [
        (rng.choice(all_hashes, size=min(12, all_hashes.shape[0]), replace=False).tolist(), 10, 1, 10)
        for _ in range(5)
    ]
    params = ref_sk.SearchParams(query_len=64, postings_budget=4096)
    run_sharded(file_segs, mem_segs, requests, params, n, gather_branches(params, n), slots)


@pytest.mark.parametrize("n,slots", MESHES)
def test_sharded_ingest_sorts_per_shard(n, slots):
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    i = rng.integers(1, 1000, 5000, dtype=np.uint32)
    want_h, want_i = jax.device_get(ref_sharded.sharded_ingest_step(ref_sharded.make_mesh(n), h, i))
    sh, si = port_sharded.sharded_ingest_step(port_sharded.make_mesh(n, ["cpu"] * slots), h, i)
    sh, si = sh.numpy().view(np.uint32), si.numpy().view(np.uint32)
    np.testing.assert_array_equal(sh, want_h)
    np.testing.assert_array_equal(si, want_i)
    bounds = port_sharded.hash_bounds(n)
    total = 0
    for k in range(n):
        valid = sh[k] != 0xFFFFFFFF
        vals = sh[k][valid].astype(np.int64)
        pairs = vals * 2**32 + si[k][valid].astype(np.int64)
        assert np.all(np.diff(pairs) >= 0)  # sorted by (hash, docid)
        if vals.size:
            assert vals.min() >= bounds[k] and vals.max() < bounds[k + 1]
        total += int(valid.sum())
    assert total == 5000


@pytest.mark.parametrize("n,slots", MESHES)
def test_sharded_big_budget_branch_matches_single_device(n, slots):
    """A hot hash with > P_SMALL postings forces the full-budget branch."""
    rng = np.random.default_rng(9)
    hot = 123456
    docs = {i: [hot, int(rng.integers(0, 10_000))] for i in range(1, 400)}
    docs[777] = [hot, 42, 43, 44]
    segs = [seg_from_docs(docs, commit_id=1)]
    params = ref_sk.SearchParams(query_len=64, postings_budget=4096)
    out = run_sharded(segs, [], [([hot, 42, 43, 44], 5, 2, 0)], params, n, ["full", "select_sorted"], slots)
    assert results(out, 0)[0] == (777, 4)


# ---- tests/test_sharded_blocked.py ----


def _corpus(seed, n_docs=25_000):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, 2**32, (n_docs, 24), dtype=np.uint32)


def _doc_queries(rng, doc_hashes, targets):
    return [
        (np.concatenate([doc_hashes[t - 1][:14], rng.integers(0, 2**32, 4, dtype=np.uint32)]).tolist(), 10, 2, 10)
        for t in targets
    ]


@pytest.fixture(scope="module")
def blocked_corpus():
    rng, doc_hashes = _corpus(21)
    return rng, doc_hashes, seg_from_docs({i + 1: doc_hashes[i] for i in range(len(doc_hashes))}, 1)


@pytest.mark.parametrize("n,slots", MESHES)
def test_sharded_blocked_path_matches_single_device(n, slots, blocked_corpus):
    """Per-shard tables big enough for the two-level lookup (25,000 docs,
    ~600k postings)."""
    _, doc_hashes, seg = blocked_corpus
    rng = np.random.default_rng(100 + n)
    view = port_sharded._pack_tier_sharded([seg[1]], n, 16)
    assert view["block_index"].shape[0] // n * BLOCK >= 64 * BLOCK  # the blocked lookup's size
    targets = rng.integers(1, len(doc_hashes) + 1, 3)
    params = ref_sk.SearchParams(query_len=64, postings_budget=512, candidate_cap=256)
    out = run_sharded([seg], [], _doc_queries(rng, doc_hashes, targets), params, n, gather_branches(params, n), slots)
    for i, t in enumerate(targets):
        assert results(out, i)[0][0] == t


@pytest.fixture(scope="module")
def direct_corpus():
    """25,000 docs in the file tier; a memory tier re-inserting 40 of them
    with fresh hashes and tombstoning 40 others, whose file postings live
    on OTHER hash shards than their mention entries."""
    rng, doc_hashes = _corpus(31)
    seg1 = seg_from_docs({i + 1: doc_hashes[i] for i in range(len(doc_hashes))}, 1)
    upd = rng.choice(np.arange(1, len(doc_hashes) + 1), 80, replace=False)
    new_hashes = rng.integers(0, 2**32, (40, 24), dtype=np.uint32)
    seg2 = seg_from_docs({int(upd[i]): new_hashes[i] for i in range(40)}, 2, deletes=[int(x) for x in upd[40:]])
    return rng, doc_hashes, upd, new_hashes, seg1, seg2


@pytest.mark.parametrize("n,slots", MESHES)
def test_sharded_direct_path_supersession_matches_single_device(n, slots, direct_corpus, monkeypatch):
    """The direct path (emitting lookup, gather-free candidates, joined
    streams) with a live memory tier: cross-shard supersession decides.
    Forced interleaved so the emit path engages at this size.  A second
    batch, of untouched docs only, takes the narrow direct path."""
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))
    rng, doc_hashes, upd, new_hashes, seg1, seg2 = direct_corpus
    assert "inter" in port_sharded._pack_tier_sharded([seg1[1]], n, 16)
    params = ref_sk.SearchParams(query_len=64, postings_budget=512, candidate_cap=256)
    # Per shard the direct stream is 2 * 64 + 16 lanes, + P_MEM_DIRECT wide.
    scorer = lambda w: "select_matrix" if n * w <= port_sharded.MATRIX_MAX else "select_sorted"  # noqa: E731

    # An updated doc (new hashes find it), one whose tombstone must hide it,
    # and an untouched one.
    victims = [int(upd[0]), int(upd[40]), int(rng.integers(1, len(doc_hashes)))]
    probes = [new_hashes[0], doc_hashes[upd[40] - 1], doc_hashes[victims[2] - 1]]
    reqs = [(np.concatenate([hs[:14], rng.integers(0, 2**32, 4, dtype=np.uint32)]).tolist(), 10, 2, 10) for hs in probes]
    out = run_sharded([seg1], [seg2], reqs, params, n, ["direct_wide", scorer(2 * 64 + 16 + 64)], slots)
    assert results(out, 0)[0][0] == victims[0]
    assert all(d != victims[1] for d, _ in results(out, 1))

    untouched = [t for t in rng.integers(1, len(doc_hashes) + 1, 12).tolist() if t not in set(upd.tolist())][:4]
    out = run_sharded([seg1], [seg2], _doc_queries(rng, doc_hashes, untouched), params, n,
                      ["direct_narrow", scorer(2 * 64 + 16)], slots)
    for i, t in enumerate(untouched):
        assert results(out, i)[0][0] == t


@pytest.mark.parametrize("n,slots", MESHES)
def test_sharded_hot_hash_full_budget_matches_single_device(n, slots, monkeypatch):
    """A hot hash (> P_SMALL postings on one shard) forces the full-budget
    gather and the sort of the joined stream (n * 2048 > MATRIX_MAX)."""
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))
    rng, doc_hashes = _corpus(47)
    hot = np.uint32(0x7F000001)
    doc_hashes[: port_sk.P_SMALL + 200, 0] = hot
    seg = seg_from_docs({i + 1: doc_hashes[i] for i in range(len(doc_hashes))}, 1)
    params = ref_sk.SearchParams(query_len=64, postings_budget=2048, candidate_cap=1024)
    t = 17  # a hot-hash member: its query includes the hot run
    out = run_sharded([seg], [], _doc_queries(rng, doc_hashes, [t]), params, n, ["full", "select_sorted"], slots)
    assert results(out, 0)[0][0] == t


# ---- cases of the port's own ----


@pytest.mark.parametrize("delete_ffff", [False, True])
def test_empty_mention_shard_beside_a_live_one(delete_ffff):
    """At 8 shards a memory tier of small doc ids mentions docs on shard 0
    only: every other shard's mention table is empty, so its gate reads
    0xFFFFFFFF sentinels for lo and hi while the global flag is set.  A
    candidate doc 0xFFFFFFFF passes those shards' range test; the answer
    must still be the reference's (and, with the doc deleted in the memory
    tier, shard 7 holds the mention that kills it)."""
    rng = np.random.default_rng(3)
    docs = {i: rng.integers(0, 2**32, 12, dtype=np.uint32).tolist() for i in range(1, 40)}
    docs[0xFFFFFFFF] = docs[1][:6] + rng.integers(0, 2**32, 6, dtype=np.uint32).tolist()
    f1 = seg_from_docs(docs, 1)
    m1 = seg_from_docs({5: docs[5][:3]}, 2, deletes=[0xFFFFFFFF] if delete_ffff else [])
    mem_np = port_sharded._pack_tier_sharded([m1[1]], 8, 8)
    assert mem_np["mention_len"][0] > 0 and (mem_np["mention_len"][1:7] == 0).all()
    params = ref_sk.SearchParams(query_len=64, postings_budget=4096)
    for slots in (1, 3):  # the live shard and the empty ones on one slot, then apart
        out = run_sharded([f1], [m1], [(docs[1], 10, 1, 0), (docs[0xFFFFFFFF], 10, 1, 0)], params, 8,
                          gather_branches(params, 8), slots)
        assert (0xFFFFFFFF in [d for d, _ in results(out, 1)]) != delete_ffff


def test_local_tier_is_a_view():
    """Shard k's tier is a view within its slot's flat fields (no copy per
    batch), at one slot and at two."""
    rng = np.random.default_rng(4)
    f1 = seg_from_docs({i: rng.integers(0, 2**32, 12, dtype=np.uint32).tolist() for i in range(1, 50)}, 1)
    for slots in (1, 2):
        mesh = port_sharded.make_mesh(4, ["cpu"] * slots)
        view = port_sharded.build_sharded_view(PortSnapshot(file=(f1[1],), memory=(f1[1],)), mesh)
        f_t, m_t = port_sharded.search_tiers(view)
        for tier in (f_t, m_t):
            assert len(tier) == slots
            for k in range(4):
                s = mesh.slot_of(k)
                j = k - mesh.shard_range(s)[0]
                local = port_sharded._local_tier(tier, k, mesh)
                for key, v in local.items():
                    assert v.untyped_storage().data_ptr() == tier[s][key].untyped_storage().data_ptr(), key
                    if key != "mention_len":
                        assert v.shape[0] * (4 // slots) == tier[s][key].shape[0]
                        assert v.storage_offset() == j * v.shape[0]

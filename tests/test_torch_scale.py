"""The 134M-fingerprint scale point (acoustid_index_tpu_torch/bench_100m.py)
against the root bench_100m.py, the JAX package and the oracle, exactly.

The corpus is bench_100m.py's: 2^27 docs of 8 hashes, 2^30 postings, an
interleaved tier of 2^31 entries.  On the CPU:

  * the port's copies of np_bitrev27, _f_np and doc_hashes_np equal the
    root script's (which imports only numpy at its top) on seeded samples
    of positions with the band edges, the hot runs and p = 2^27 - 1;
  * inter_chunk, build_tier's pure function of the flat index, equals a
    numpy model of bench_100m.py's make_tiers at flat offsets straddling
    2^30, 2^31 - 2048 and in the last block, without allocating the tier:
    the port's counterpart of tests/test_134m_trace.py;
  * a sub-tier, positions [2^21 - 2^13, 2^21 + 2^13) of every band (all 8
    bands' first hot runs and their pair runs, 131,072 postings), built by
    build_tier on the CPU, has the layout engine/segments.pack_tier gives
    the same postings; searched by the port (plain versions), it equals
    the JAX package's search_segments_batch over the same arrays (Pallas in
    interpret mode) in all seven output fields, on batches that take the
    direct, matrix and sort branches, and both equal oracle_search over an
    explicit OracleSegment of the window and over the analytic sub-oracle
    (oracle_postings), which equals the explicit postings;
  * measure.staged_search (the stage calls of `measure.py --stages`) gives
    the same output as _search_batch_impl on each branch.

Every output is an integer or a flag: the tolerance is 0.  The
`test_cuda_*` cases build the full 134M tier on a card and hold one batch
of 256 and the boundary batch to the analytic oracle, and K1 and K2 at
shapes (e), (f) and (g) to their plain versions
(`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scale.py -k cuda`
on the card); they skip here.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_100m as ref_bench  # the root script: numpy only at its top
from acoustid_index_tpu.ops import search_kernel as ref_sk
from acoustid_index_tpu_torch import bench_100m as port_bench
from acoustid_index_tpu_torch import measure
from acoustid_index_tpu_torch.engine.memseg import Segment
from acoustid_index_tpu_torch.engine.model import SegmentInfo
from acoustid_index_tpu_torch.engine.searcher import Searcher
from acoustid_index_tpu_torch.engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier, tier_view_for_search
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.ops import layout as port_layout
from acoustid_index_tpu_torch.ops import search_kernel as port_sk

from oracle import OracleSegment, oracle_search

os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")

FIELDS = ("ids", "scores", "count", "postings_scanned", "truncated", "max_per_hash", "max_blocks_per_hash")
N = ref_bench.N_DOCS
P0, P1 = (1 << 21) - (1 << 13), (1 << 21) + (1 << 13)  # the sub-tier's window of positions
HOT = [j * ref_bench.BAND + ((1 << 21) - 64 * j) * 4 for j in range(8)]  # band j's hot run in the window
B = 4  # rows per sub-tier batch: the reference's interpret-mode run stays short


@pytest.fixture(autouse=True)
def _small_interpret_steps(monkeypatch):
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


# ---- the corpus functions ----


def _positions(seed):
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, 63, 64, N - 2, N - 1] + [(1 << 21) - 64 * j + d for j in range(8) for d in (-1, 0, 1, 63, 64)]
    return np.concatenate([np.asarray(edges, np.int64), rng.integers(0, N, 4096)])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["np_bitrev27", "_f_np", "doc_hashes_np"])
def test_corpus_functions_match_reference(fn, seed):
    p = _positions(seed)
    if fn == "np_bitrev27":
        np.testing.assert_array_equal(port_bench.np_bitrev27(p), ref_bench.np_bitrev27(p))
    elif fn == "_f_np":
        for j in range(8):
            np.testing.assert_array_equal(port_bench._f_np(p, j), ref_bench._f_np(p, j), err_msg=f"band {j}")
    else:
        ids = (p + 1).astype(np.uint32)  # docs 1 .. 2^27
        np.testing.assert_array_equal(port_bench.doc_hashes_np(ids), ref_bench.doc_hashes_np(ids))
    # The band edges: band 7's last hash is 0xFFFFFFFC, the tier's last.
    assert int(ref_bench.doc_hashes_np(np.asarray([N], np.uint32))[0, 7]) == 0xFFFFFFFC


# ---- build_tier's chunk function at 2^30 .. 2^31 ----


def _model_inter(i):
    """bench_100m.py's make_tiers (hash_at and the select), entry by entry
    in numpy over uint64: the value of inter at flat entries i."""
    i = i.astype(np.uint64)
    blk, w = i >> np.uint64(11), i & np.uint64(2047)
    k = blk * np.uint64(1024) + (w & np.uint64(1023))
    j, p = k >> np.uint64(27), k & np.uint64(N - 1)
    h = j * np.uint64(ref_bench.BAND) + ref_bench._f_np(p, j)
    d = ref_bench.np_bitrev27(p).astype(np.uint64) + np.uint64(1)
    return np.where(w < np.uint64(1024), h, d)


@pytest.mark.parametrize("start", [0, (1 << 30) - 3000, (1 << 31) - 2048 - 3000, (1 << 31) - 2048])
def test_inter_chunk_matches_reference_model(start):
    i = np.arange(start, min(start + 6000, 1 << 31), dtype=np.int64)
    got = port_bench.inter_chunk(torch.from_numpy(i))
    want = _model_inter(i)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    # Stored as the tier stores it: int32 bit patterns of the u32 values.
    np.testing.assert_array_equal(port_layout.to_storage(got).numpy().view(np.uint32), want.astype(np.uint32))
    if i[-1] == (1 << 31) - 1:
        # The last block ends the tier: its last hash 0xFFFFFFFC, its last
        # docid that of position 2^27 - 1.
        assert want[-1025] == 0xFFFFFFFC and want[-1] == int(ref_bench.np_bitrev27(np.asarray([N - 1]))[0]) + 1


def test_layout_positions_at_2_31():
    """The posting-to-entry arithmetic of a 2^31-entry tier, on a meta
    tensor (nothing allocated): the last posting's hash and docid sit at
    2^31 - 1025 and 2^31 - 1, the capacity is 2^30, K1/K2's argument
    checks take the table."""
    tier = {"inter": torch.empty(1 << 31, dtype=torch.int32, device="meta")}
    assert port_layout.postings_cap(tier) == 1 << 30
    idx = torch.tensor([0, 1023, 1024, (1 << 30) - 1024, (1 << 30) - 1], dtype=torch.int64)
    assert port_layout._inter_pos(idx, payload=False).tolist() == [0, 1023, 2048, (1 << 31) - 2048, (1 << 31) - 1025]
    assert port_layout._inter_pos(idx, payload=True).tolist() == [1024, 2047, 3072, (1 << 31) - 1024, (1 << 31) - 1]
    blk = torch.empty(4, dtype=torch.int32, device="meta")
    port_bl._check(tier["inter"], blk, blk, 2)


# ---- the sub-tier ----


@pytest.fixture(scope="module")
def window():
    """(snapshot, explicit OracleSegment, sorted (hashes, docids)) of the
    window [P0, P1) of every band."""
    snap = port_bench.build_tier("cpu", P0, P1)
    pos = np.arange(P0, P1)
    h = np.concatenate([(np.uint64(j) * ref_bench.BAND + ref_bench._f_np(pos, j)).astype(np.uint32) for j in range(8)])
    d = np.tile(ref_bench.np_bitrev27(pos) + np.uint32(1), 8)
    order = np.lexsort((d, h))
    return snap, OracleSegment(list(zip(h.tolist(), d.tolist())), {}), (h[order], d[order])


def test_sub_tier_layout_matches_pack_tier(window, monkeypatch):
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))
    snap, _, (h, d) = window
    ids = np.unique(d)
    seg = Segment(SegmentInfo(commit_id=1), h, d, ids, np.ones(ids.shape[0], bool), int(ids[0]), int(ids[-1]))
    want = tier_view_for_search(pack_tier([seg], FILE_SLOTS, device_mentions=False, device="cpu"), mentions=False)
    got = tier_view_for_search(snap.file_view, mentions=False)
    assert "inter" in want and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k != "inter":
            assert torch.equal(got[k], want[k]), k
    # Same hashes entry for entry; the same (hash, docid) postings (within a
    # run of one hash build_tier keeps bench_100m.py's position order).
    g2, w2 = (t["inter"].view(-1, 2, 1024) for t in (got, want))
    assert torch.equal(g2[:, 0], w2[:, 0])
    pairs = [np.sort((t[:, 0].numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)) | t[:, 1].numpy().view(np.uint32), axis=None)
             for t in (g2, w2)]
    np.testing.assert_array_equal(*pairs)
    mem_want = tier_view_for_search(pack_tier([], MEMORY_SLOTS, device="cpu"))
    mem_got = tier_view_for_search(snap.mem_view)
    assert set(mem_got) == set(mem_want) and all(torch.equal(mem_got[k], mem_want[k]) for k in mem_want)


def _window_batch(seed, hot_rows):
    """B queries of the bench's shape over the window (targets off the hot
    runs); row r also carries the first hot_rows[r] hot hashes."""
    rng = np.random.default_rng(seed)
    p = rng.integers(P0, P1, 64)
    p = p[~np.isin(p >> 6, [((1 << 21) >> 6) - j for j in range(8)])][:B]
    targets = port_bench.np_bitrev27(p) + np.uint32(1)
    hs = port_bench.doc_hashes_np(targets)[:, :6]
    qs = np.zeros((B, port_bench.QUERY_LEN), np.uint32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        extra = np.asarray(HOT[: hot_rows[b]], np.uint32)
        q = np.unique(np.concatenate([hs[b], rng.integers(0, 2**32, 4, dtype=np.uint32), extra]))
        qs[b, : q.shape[0]], lens[b] = q, q.shape[0]
    return targets, qs, lens


BRANCHES = {"direct": (0, 0, 0, 0), "matrix": (1, 0, 0, 0), "sort": (5, 1, 0, 0)}


def _oracles(q, explicit):
    kw = dict(limit=port_bench.LIMIT, min_score=port_bench.MIN_SCORE, pct=port_bench.PCT)
    return (oracle_search([explicit], q, **kw),
            oracle_search([OracleSegment(port_bench.oracle_postings(q, P0, P1), {})], q, **kw))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_sub_tier_search_matches_reference_and_oracle(window, branch):
    snap, explicit, _ = window
    targets, qs, lens = _window_batch(7, BRANCHES[branch])
    packed = port_bench.pack(qs, lens)
    p = port_bench.params()

    before = dict(port_sk.STATS)
    s = Searcher("cpu")
    got = port_sk.unpack_outputs_np(s._fetch(s._launch(snap, p, packed)), p.out_len)
    assert [k for k in ("direct", "matrix", "sort") if port_sk.STATS[k] != before[k]] == [branch]

    def np_view(view):  # u32 tables as uint32, mention_len 0-d, as the reference packs them
        return {k: jnp.asarray(v.numpy().view(np.uint32) if k in ("inter", "block_index", "hashes", "docids", "mention_ids")
                               else v.numpy().reshape(()) if k == "mention_len" else v.numpy()) for k, v in view.items()}

    ref_p = ref_sk.SearchParams(query_len=64, postings_budget=512, candidate_cap=256)
    want = ref_sk.search_segments_batch(
        ref_p, np_view(tier_view_for_search(snap.file_view, mentions=False)), np_view(tier_view_for_search(snap.mem_view)),
        *(jnp.asarray(a) for a in (qs, lens, np.full(B, port_bench.LIMIT, np.int32), np.full(B, port_bench.MIN_SCORE, np.int32),
                                   np.full(B, port_bench.PCT, np.int32))),
    )
    for f in FIELDS:
        np.testing.assert_array_equal(got[f].astype(np.int64), np.asarray(want[f]).astype(np.int64), err_msg=f)

    assert (got["ids"][:, 0] == targets).all() and (got["scores"][:, 0] == 6).all()
    for b in range(B):
        q = qs[b, : lens[b]].tolist()
        n = int(got["count"][b])
        res = list(zip(got["ids"][b, :n].tolist(), got["scores"][b, :n].tolist()))
        w_explicit, w_analytic = _oracles(q, explicit)
        assert res == w_explicit == w_analytic, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_postings_match_explicit(window, seed):
    """The analytic sub-oracle's postings equal the explicit window's for
    stored hashes (hot, pair and single runs, the window's first and last
    positions in every band) and for hashes no posting holds."""
    _, explicit, (h, _) = window
    rng = np.random.default_rng(seed)
    qh = np.concatenate([rng.choice(h, 200), np.asarray(HOT, np.uint32), h[:: len(h) // 16], h[-1:],
                         rng.integers(0, 2**32, 50, dtype=np.uint32), h[rng.integers(0, len(h), 50)] + np.uint32(1)])
    for x in qh.tolist():
        got = sorted(port_bench.oracle_postings([x], P0, P1))
        assert got == sorted((x, dd) for dd in explicit.postings(x)), x
    assert len(port_bench.oracle_postings(HOT, P0, P1)) == 8 * 64


# ---- the stage calls of measure.py --stages ----


@pytest.mark.parametrize("sort_path", [False, True])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_staged_search_matches_search_batch_impl(window, branch, sort_path):
    snap, _, _ = window
    _, qs, lens = _window_batch(11, BRANCHES[branch])
    p = port_bench.params()
    x = torch.from_numpy(port_bench.pack(qs, lens).view(np.int32))
    file_view = tier_view_for_search(snap.file_view, mentions=False)
    mem_view = tier_view_for_search(snap.mem_view)
    args = port_sk.unpack_inputs(p, x)
    want = port_sk._search_batch_impl(p, file_view, mem_view, *args)
    stages = []

    def stage(name):
        stages.append(name)
        return measure._no_stage(name)

    before = dict(port_sk.STATS)
    got, taken = measure.staged_search(p, file_view, mem_view, *args, stage=stage, sort_path=sort_path)
    assert taken == ("sort" if sort_path else branch)
    assert [k for k in ("direct", "matrix", "sort") if port_sk.STATS[k] != before[k]] == [taken]
    assert stages == list(measure.STAGES[:-1])
    fields = ("ids", "scores", "count") if sort_path else FIELDS  # the sort path's own budget flags
    for f in fields:
        assert torch.equal(got[f].to(torch.int64), want[f].to(torch.int64)), f


# ---- the full tier on a card ----


@pytest.fixture(scope="module")
def tier134m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the 134M tier is 8 GiB and the kernels have no CPU mode")
    snap = port_bench.build_tier(torch.device("cuda"))
    yield snap
    del snap
    torch.cuda.empty_cache()


def _analytic_oracle(q):
    return oracle_search([OracleSegment(port_bench.oracle_postings(q), {})], q, limit=port_bench.LIMIT,
                         min_score=port_bench.MIN_SCORE, pct=port_bench.PCT)


def test_cuda_134m_batches_match_oracle(tier134m):
    assert tier134m.file_view["inter"].numel() == 1 << 31 and tier134m.file_view["block_index"].numel() == 1 << 20
    rng = np.random.default_rng(5)
    p = port_bench.params()
    s = Searcher(torch.device("cuda"))
    for label, batch in (("batch", port_bench.make_queries(rng)), ("boundary", port_bench.boundary_queries(rng))):
        targets, qs, lens = batch
        out = port_sk.unpack_outputs_np(s._fetch(s._launch(tier134m, p, port_bench.pack(qs, lens))), p.out_len)
        port_bench.check_answers(label, targets, qs, lens, out["ids"], out["scores"], out["count"], _analytic_oracle)


def test_cuda_134m_kernels_match_plain(tier134m):
    qpool = measure.scale_qpool(np.random.default_rng(6), torch.device("cuda"))[:2]
    g = torch.Generator(device="cuda").manual_seed(6)
    for case in measure.scale_cases(tier134m.file_view["inter"], qpool, g):
        case["sets"] = case["sets"][:2]
        rec = measure.check_case(case)
        assert rec["max_abs_err"] == 0, rec["shape"]

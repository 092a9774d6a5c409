"""The port's batched search program against the JAX package, exactly.

Each case builds its segments in both packages from the same changes (each
package with its own model and memseg), packs them with each package's
pack_tier, and feeds the same packed query batch (pack_inputs_np) to both
packages' search_segments_batch_packed_io; the two packed tiers must be
equal field for field.  All seven output fields must be equal
(tolerance 0: they are integers and flags), and each query's results must
equal tests/oracle.py.  Every case also asserts which branch the batch
took (direct / matrix / sort), so all three stay covered.

The reference runs on the CPU as its own tests run it (Pallas in interpret
mode); the port runs its kernels' plain versions on CPU tensors.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from acoustid_index_tpu.engine import memseg as ref_memseg
from acoustid_index_tpu.engine import model as ref_model
from acoustid_index_tpu.engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier, tier_view_for_search
from acoustid_index_tpu.ops import search_kernel as ref_sk
from acoustid_index_tpu_torch.engine import memseg as port_memseg
from acoustid_index_tpu_torch.engine import model as port_model
from acoustid_index_tpu_torch.engine import segments as port_segments
from acoustid_index_tpu_torch.engine.searcher import Searcher, _params_for
from acoustid_index_tpu_torch.engine.segments import tier_from_numpy
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.ops import search_kernel as port_sk

from oracle import OracleSegment, oracle_search

os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")

FIELDS = ("ids", "scores", "count", "postings_scanned", "truncated", "max_per_hash", "max_blocks_per_hash")
B = 8  # every batch pads to 8 rows, so cases share compiled reference programs


@pytest.fixture(autouse=True)
def _small_interpret_steps(monkeypatch):
    # Results do not depend on the reference kernels' lookups per grid
    # step; small steps keep their interpret-mode runs fast.
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    # Every table the search program hands K1/K2 must suit their search.
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


def seg_from_docs(docs, commit_id, deletes=()):
    """(reference segment, port segment) of the same inserts then deletes,
    each built by its own package from its own change objects."""
    out = []
    for model, memseg in ((ref_model, ref_memseg), (port_model, port_memseg)):
        changes = [model.Insert(id=i, hashes=h) for i, h in docs.items()]
        changes += [model.Delete(id=i) for i in deletes]
        out.append(memseg.build_segment(changes, model.SegmentInfo(commit_id=commit_id)))
    assert isinstance(out[1], port_memseg.Segment) and not isinstance(out[1], ref_memseg.Segment)
    return tuple(out)


def to_oracle(seg):
    return OracleSegment(
        list(zip(seg.hashes.tolist(), seg.docids.tolist())),
        dict(zip(seg.docs_ids.tolist(), seg.docs_alive.tolist())),
    )


def run_both(file_segs, mem_segs, requests, branch, oracle=True):
    """requests: [(query, limit, min_score, pct)].  Runs both packages on
    one batch, checks all fields equal, that the batch took `branch`, and
    (with `oracle`; a truncated scan differs from it by design) each
    query against the oracle.  Returns the port's unpacked outputs.
    Segments are (reference, port) pairs from seg_from_docs."""
    import torch

    f_np = tier_view_for_search(pack_tier([r for r, _ in file_segs], FILE_SLOTS, device_mentions=False), mentions=False)
    m_np = tier_view_for_search(pack_tier([r for r, _ in mem_segs], MEMORY_SLOTS))
    f_np = {k: np.asarray(v) for k, v in f_np.items()}
    m_np = {k: np.asarray(v) for k, v in m_np.items()}
    f_port = port_segments.tier_view_for_search(
        port_segments.pack_tier([p for _, p in file_segs], FILE_SLOTS, device_mentions=False, device="cpu"),
        mentions=False,
    )
    m_port = port_segments.tier_view_for_search(
        port_segments.pack_tier([p for _, p in mem_segs], MEMORY_SLOTS, device="cpu")
    )
    for want_np, got_t in ((f_np, f_port), (m_np, m_port)):
        assert set(got_t) == set(want_np)
        for k, v in got_t.items():
            np.testing.assert_array_equal(torch.as_tensor(v).numpy().view(want_np[k].dtype), want_np[k], err_msg=k)

    searcher = Searcher(device="cpu")
    rows = [searcher.prepare_query(q) for q, *_ in requests]
    bucket = next(b for b in (64, 128, 256, 1024, 4096) if b >= max(n for _, n in rows))
    params = _params_for(bucket)
    qs = np.zeros((B, bucket), np.uint32)
    lens = np.zeros(B, np.uint32)
    limits = np.ones(B, np.uint32)
    min_scores = np.zeros(B, np.uint32)
    pcts = np.zeros(B, np.uint32)
    for i, ((q, n), (_, limit, ms, pct)) in enumerate(zip(rows, requests)):
        qs[i, :n] = q
        lens[i], limits[i], min_scores[i], pcts[i] = n, limit, ms, pct
    packed = ref_sk.pack_inputs_np(qs, lens, limits, min_scores, pcts)

    want = np.asarray(
        ref_sk.search_segments_batch_packed_io(
            params, {k: jnp.asarray(v) for k, v in f_np.items()}, {k: jnp.asarray(v) for k, v in m_np.items()},
            jnp.asarray(packed),
        )
    )
    before = dict(port_sk.STATS)
    got = port_sk.search_segments_batch_packed_io(
        params, f_port, m_port, torch.from_numpy(packed.view(np.int32)),
    ).numpy().view(np.uint32)
    taken = [k for k in ("direct", "matrix", "sort") if port_sk.STATS[k] != before[k]]
    assert taken == [branch], taken

    out_w = ref_sk.unpack_outputs_np(want, params.out_len)
    out_g = port_sk.unpack_outputs_np(got, params.out_len)
    for f in FIELDS:
        np.testing.assert_array_equal(out_g[f], out_w[f], err_msg=f)

    oracle_segs = [to_oracle(p) for _, p in list(file_segs) + list(mem_segs)]
    for i, (q, limit, ms, pct) in enumerate(requests if oracle else ()):
        n = int(out_g["count"][i])
        res = list(zip(out_g["ids"][i, :n].tolist(), out_g["scores"][i, :n].tolist()))
        assert res == oracle_search(oracle_segs, q, limit=limit, min_score=ms, pct=pct), i
    return out_g


# ---- tests/test_search_kernel.py cases ----


def _small_cases():
    f_a = seg_from_docs({1: [10, 20], 2: [10, 30]}, commit_id=1)
    return {
        "single_segment": ([], [seg_from_docs({1: [10, 20, 30], 2: [20, 30, 40], 3: [99]}, 1)], [([20, 30, 40], 10, 1, 10)]),
        "dup_hashes_in_doc": ([], [seg_from_docs({7: [5, 5, 5]}, 1)], [([5], 10, 1, 10)]),
        "dup_query_hashes": ([], [seg_from_docs({7: [5, 6]}, 1)], [([5, 5, 5, 6], 10, 1, 10)]),
        "newer_segment_wins": (
            [], [seg_from_docs({1: [10, 20, 30]}, 1), seg_from_docs({1: [10]}, 2)], [([10, 20, 30], 10, 1, 10)]
        ),
        "tombstone": (
            [], [seg_from_docs({1: [10, 20], 2: [10, 20]}, 1), seg_from_docs({}, 2, deletes=[1])], [([10, 20], 10, 1, 10)]
        ),
        "file_and_memory": (
            [seg_from_docs({1: [10, 20], 2: [30]}, 1), seg_from_docs({3: [10, 40]}, 2)],
            [seg_from_docs({2: [10, 20, 40]}, 3)],
            [([10, 20, 30, 40], 10, 1, 10), ([40], 10, 1, 0)],
        ),
        "mem_mention_no_hash_overlap": ([f_a], [seg_from_docs({1: [99]}, 2)], [([10, 20, 30], 10, 1, 0)]),
        "mem_delete_only": ([f_a], [seg_from_docs({}, 2, deletes=[1])], [([10, 20, 30], 10, 1, 0)]),
        "min_score": ([], [seg_from_docs({1: [10], 2: [10, 20], 3: [10, 20, 30]}, 1)], [([10, 20, 30], 10, 2, 0)]),
        "pct_anchor_on_survivor": (
            [],
            [seg_from_docs({1: [10, 20, 30, 40, 50], 2: [10, 20]}, 1), seg_from_docs({1: [99]}, 2)],
            [([10, 20, 30, 40, 50], 10, 1, 60)],
        ),
        "limit_tiebreak": ([], [seg_from_docs({i: [10] for i in range(1, 20)}, 1)], [([10], 5, 1, 0), ([10], 3, 0, 0)]),
        "sentinel_hash": ([], [seg_from_docs({1: [0xFFFFFFFF, 5]}, 1)], [([0xFFFFFFFF, 5], 10, 1, 10), ([0xFFFFFFFF], 10, 1, 10)]),
        "empty_tiers": ([], [], [([1, 2, 3], 10, 1, 10)]),
    }


SMALL = _small_cases()


@pytest.mark.parametrize("case", list(SMALL))
def test_small_cases_match_reference(case):
    file_segs, mem_segs, requests = SMALL[case]
    run_both(file_segs, mem_segs, requests, "matrix")


@pytest.mark.parametrize("seed", range(6))
def test_randomized_parity(seed):
    rng = np.random.default_rng(seed)
    n_file = int(rng.integers(0, 4))
    n_mem = int(rng.integers(0, 5)) or (0 if n_file else 1)
    commit = 1
    file_segs, mem_segs = [], []
    for out, n in ((file_segs, n_file), (mem_segs, n_mem)):
        for _ in range(n):
            docs = {}
            for _ in range(int(rng.integers(1, 12))):
                docs[int(rng.integers(1, 40))] = [int(h) for h in rng.integers(0, 60, rng.integers(1, 10))]
            deletes = [int(d) for d in rng.integers(1, 40, rng.integers(0, 3)) if int(d) not in docs]
            out.append(seg_from_docs(docs, commit, deletes))
            commit += 1
    requests = [
        (
            [int(h) for h in rng.integers(0, 60, int(rng.integers(1, 15)))],
            int(rng.integers(1, 8)),
            int(rng.integers(0, 3)),
            int(rng.choice([0, 10, 50, 90])),
        )
        for _ in range(B)
    ]
    run_both(file_segs, mem_segs, requests, "matrix")


def test_uniform_fast_path_matches_sort_path():
    """One live segment vs the same corpus split in two: equal results."""
    rng = np.random.default_rng(42)
    docs = {i: [int(h) for h in rng.integers(0, 50, rng.integers(2, 9))] for i in range(1, 30)}
    one = [seg_from_docs(docs, 1)]
    two = [seg_from_docs({i: h for i, h in docs.items() if i < 15}, 1), seg_from_docs({i: h for i, h in docs.items() if i >= 15}, 2)]
    requests = [
        ([int(h) for h in rng.integers(0, 50, rng.integers(2, 12))], 7, 1, int(rng.choice([0, 10, 80])))
        for _ in range(B)
    ]
    r1 = run_both([], one, requests, "matrix")
    r2 = run_both(two, [], requests, "matrix")
    for f in ("ids", "scores", "count"):
        np.testing.assert_array_equal(r1[f], r2[f])


def test_big_budget_sort_path_matches_reference():
    """A hot hash with > P_SMALL postings forces the full-budget sort path,
    with supersession across tiers in play."""
    rng = np.random.default_rng(7)
    hot = 999
    docs_a = {i: [hot, int(rng.integers(0, 400))] for i in range(1, 350)}
    docs_b = {i: [int(h) for h in rng.integers(0, 400, 4)] for i in range(340, 360)}
    requests = [(q, 8, 1, 0) for q in ([hot, 42, 43], [hot], [hot, 0, 1, 2, 3], [7, 8])]
    run_both([seg_from_docs(docs_a, 1)], [seg_from_docs(docs_b, 2, deletes=[5, 17])], requests, "sort")


def test_hot_hash_degenerate_skew():
    """A 10^5-posting hot hash: the capped window truncates with the flag,
    max_per_hash reports the cap, and every other hash scores exactly."""
    hot = 4_000_000_000
    a, b, c = 10, 20, 30
    docs = {i: [hot] for i in range(1, 100_001)}
    docs[50] = [hot, a, b, c]
    requests = [([hot, a, b, c], 10, 2, 10), ([hot, a, b, c], 5, 1, 0), ([hot], 3, 1, 0)]
    out = run_both([seg_from_docs(docs, 1)], [seg_from_docs({}, 2)], requests, "sort", oracle=False)
    assert out["truncated"][:3].all()
    assert (out["max_per_hash"][:3] == _params_for(64).per_hash_cap).all()
    # As tests/test_search_kernel.py pins: doc 50 scores 3 (its hot posting
    # lies outside the capped window), then the window's docid-ascending slice.
    assert out["count"][0] == 1 and (out["ids"][0, 0], out["scores"][0, 0]) == (50, 3)
    assert out["ids"][1, :5].tolist() == [50, 98302, 98303, 98304, 98305]
    assert out["ids"][2, :3].tolist() == [98302, 98303, 98304]


# ---- tests/test_interleaved.py cases (forced interleaved layout) ----


@pytest.fixture
def force_interleave(monkeypatch):
    # Test tables are far below the 6 MB default residency budget; force
    # the blocked + interleaved path like a production table (both packages
    # read the same variable).
    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))


def _random_docs(rng, n_docs):
    return {i: rng.integers(0, 2**32, 24, dtype=np.uint32).tolist() for i in range(1, n_docs + 1)}


@pytest.mark.parametrize("with_hot", [False, True])
def test_direct_path_with_tombstones(force_interleave, with_hot):
    """One live file segment and a tombstone-only memory segment: the
    direct path engages; adding a hot-80 hash overflows F_DIRECT and sends
    the batch back to the base cascade."""
    rng = np.random.default_rng(23)
    n_docs = 3000
    doc_hashes = _random_docs(rng, n_docs)
    warm = np.uint32(0x6060_6060)
    for i in range(50, 60):
        doc_hashes[i][5] = int(warm)
    hot = np.uint32(0x5050_5050)
    for i in range(200, 280):
        doc_hashes[i][3] = int(hot)
    f1 = seg_from_docs({i: doc_hashes[i] for i in range(1, n_docs + 1)}, 1)
    del_ids = [int(i) for i in rng.choice(np.arange(1, n_docs + 1), 40, replace=False)]
    m1 = seg_from_docs({}, 2, deletes=del_ids)
    requests = []
    for trial in range(B):
        t = del_ids[trial] if trial % 3 == 0 else int(rng.integers(1, n_docs + 1))
        extra = [warm, hot] if with_hot and trial == 1 else [warm]
        q = np.unique(np.concatenate([np.asarray(doc_hashes[t][:15], np.uint32), np.asarray(extra, np.uint32),
                                      rng.integers(0, 2**32, 4, dtype=np.uint32)]))
        requests.append((q.tolist(), 10, 1, 10))
    run_both([f1], [m1], requests, "matrix" if with_hot else "direct")


@pytest.mark.parametrize("with_hot", [False, True])
def test_interleaved_multisegment(force_interleave, with_hot):
    """Two file segments and a memory segment of re-inserts and deletes:
    supersession across tiers through the direct path's wide (mem-live)
    variant, or the matrix path when a hot hash overflows."""
    rng = np.random.default_rng(77)
    n_docs = 3500
    doc_hashes = _random_docs(rng, n_docs)
    hot = np.uint32(0x5050_5050)
    for i in range(100, 180):
        doc_hashes[i][3] = int(hot)
    half = n_docs // 2
    f1 = seg_from_docs({i: doc_hashes[i] for i in range(1, half + 1)}, 1)
    f2 = seg_from_docs({i: doc_hashes[i] for i in range(half + 1, n_docs + 1)}, 2)
    re_ids = [int(i) for i in rng.choice(np.arange(1, n_docs + 1), 50, replace=False)]
    del_ids = [int(i) for i in rng.choice(np.arange(1, n_docs + 1), 30, replace=False) if int(i) not in re_ids]
    for i in re_ids:
        doc_hashes[i] = rng.integers(0, 2**32, 24, dtype=np.uint32).tolist()
    m1 = seg_from_docs({i: doc_hashes[i] for i in re_ids}, 3, deletes=del_ids)
    requests = []
    for trial in range(B):
        t = re_ids[trial] if trial % 2 == 0 else int(rng.integers(1, n_docs + 1))
        extra = [hot] if with_hot and trial == 1 else []
        q = np.unique(np.concatenate([np.asarray(doc_hashes[t][:15], np.uint32), np.asarray(extra, np.uint32),
                                      rng.integers(0, 2**32, 5, dtype=np.uint32)]))
        requests.append((q.tolist(), 10, 2, 10))
    run_both([f1, f2], [m1], requests, "matrix" if with_hot else "direct")


# ---- packing: the port's numpy pack is the reference's, byte for byte ----


@pytest.mark.parametrize("case", ["empty", "supersession", "interleaved"])
def test_pack_tier_np_matches_reference(case, monkeypatch):
    import torch

    from acoustid_index_tpu_torch.engine.segments import pack_tier_np
    from acoustid_index_tpu_torch.ops.layout import docid_gather, hash_gather

    if case == "empty":
        segs = []
    elif case == "supersession":
        segs = [
            seg_from_docs({1: [10, 20], 2: [10, 30], 3: [7]}, 1),
            seg_from_docs({1: [99], 4: [10]}, 2, deletes=[3]),
        ]
    else:
        monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", str(64 * 1024))
        rng = np.random.default_rng(5)
        segs = [seg_from_docs(_random_docs(rng, 3000), 1)]
    for slots, mentions in ((FILE_SLOTS, False), (MEMORY_SLOTS, True)):
        want = pack_tier([r for r, _ in segs], slots, device_mentions=mentions)
        got = pack_tier_np([p for _, p in segs], slots)
        assert set(got) == set(want) - {"view_token"}
        for k, v in got.items():
            w = np.asarray(want[k])
            assert v.dtype == w.dtype and v.shape == w.shape, k
            np.testing.assert_array_equal(v, w, err_msg=k)
        if case == "interleaved":
            # The carried-across tier reads back through the layout helpers.
            tier = tier_from_numpy(got, "cpu", mentions=mentions)
            assert "inter" in tier and "hashes" not in tier
            seg = segs[0][1]
            idx = torch.arange(seg.num_items)
            np.testing.assert_array_equal(hash_gather(tier, idx).numpy(), seg.hashes)
            np.testing.assert_array_equal(docid_gather(tier, idx).numpy(), seg.docids)

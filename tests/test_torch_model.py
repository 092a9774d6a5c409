"""The port's model wrapper (models/fingerprint_search.py) and driver entry
(entry.py) against the JAX package's, exactly.

Both models ingest the same seeded (hash, doc id) pairs and answer the same
query batch; every output field must be equal (tolerance 0: integers and
flags).  The port packs its table with its own packing, so a table of
64K+ postings takes the interleaved layout when AITPU_RESIDENT_MAX_BYTES
is small, and the port then searches it through K1/K2's plain versions.
The reference runs on the CPU as its own tests run it (Pallas in
interpret mode).  Runs with AITPU_TORCH_DEVICE=cpu.
"""

import numpy as np
import pytest
import torch

from acoustid_index_tpu.models.fingerprint_search import FingerprintSearchModel as RefModel
from acoustid_index_tpu.ops.search_kernel import SearchParams as RefParams
from acoustid_index_tpu_torch.models.fingerprint_search import FingerprintSearchModel
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.ops.search_kernel import SearchParams

from oracle import OracleSegment, oracle_search

FIELDS = ("ids", "scores", "count", "postings_scanned", "truncated", "max_per_hash", "max_blocks_per_hash")
Q = 64


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


def _corpus(n_docs, k, seed, hash_range=2**32):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, hash_range, (n_docs, k), dtype=np.uint32)
    ids = np.arange(1, n_docs + 1, dtype=np.uint32)
    return h, ids


def _queries(h, seed, B=8):
    rng = np.random.default_rng(seed)
    qs = np.zeros((B, Q), np.uint32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        doc = int(rng.integers(0, h.shape[0]))
        q = np.unique(np.concatenate([h[doc, :10], h[(doc + 1) % h.shape[0], :3], rng.integers(0, 2**32, 20, dtype=np.uint32)]))
        qs[b, : q.shape[0]], lens[b] = q, q.shape[0]
    return qs, lens


CASES = {
    # name: (docs, hashes per doc, hash range, force the interleaved layout)
    "dense": (150, 16, 2**32, False),
    "resident": (400, 16, 2**32, False),
    "shared_hashes": (300, 16, 500, False),
    "interleaved": (4100, 16, 2**32, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case, monkeypatch):
    n_docs, k, hash_range, inter = CASES[case]
    if inter:
        monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", "4096")
    h, ids = _corpus(n_docs, k, seed=n_docs, hash_range=hash_range)
    flat_h, flat_d = h.reshape(-1), np.repeat(ids, k)
    qs, lens = _queries(h, seed=1)

    ref = RefModel(RefParams(query_len=Q, postings_budget=8192))
    want = ref.forward(ref.ingest(flat_h, flat_d), qs, lens, limit=10, min_score=2, score_pct=10)
    model = FingerprintSearchModel(SearchParams(query_len=Q, postings_budget=8192), device="cpu")
    table = model.ingest(flat_h, flat_d)
    assert ("inter" in table.file_tier) == inter
    assert (table.n_postings, table.n_docs) == (n_docs * k, n_docs)
    got = model(table, qs, lens, limit=10, min_score=2, score_pct=10)
    for f in FIELDS:
        assert np.array_equal(got[f].to(torch.int64).numpy(), np.asarray(want[f]).astype(np.int64)), f

    oracle = [OracleSegment(list(zip(flat_h.tolist(), flat_d.tolist())), {int(i): True for i in ids})]
    for b in range(qs.shape[0]):
        n = int(got["count"][b])
        pairs = list(zip(got["ids"][b, :n].tolist(), got["scores"][b, :n].tolist()))
        assert pairs == oracle_search(oracle, qs[b, : lens[b]].tolist(), limit=10, min_score=2, pct=10)

    # forward_one: one raw query (unsorted, duplicated), the same answer.
    raw = np.concatenate([qs[0, : lens[0]][::-1], qs[0, :3]])
    want1 = ref.forward_one(ref.ingest(flat_h, flat_d), raw, limit=10, min_score=2)
    got1 = model.forward_one(table, raw, limit=10, min_score=2)
    for f in FIELDS:
        assert np.array_equal(np.asarray(got1[f].to(torch.int64)), np.asarray(want1[f]).astype(np.int64)), f


def test_doc_id_zero_is_reserved():
    model = FingerprintSearchModel(device="cpu")
    with pytest.raises(ValueError, match="reserved"):
        model.ingest(np.array([1, 2], np.uint32), np.array([0, 3], np.uint32))


def test_entry_matches_reference_entry():
    from __graft_entry__ import entry as ref_entry

    from acoustid_index_tpu_torch.entry import entry

    forward, args = entry()
    assert args[2].device.type == "cpu"
    got = forward(*args)
    ref_forward, ref_args = ref_entry()
    want = ref_forward(*ref_args)
    assert int(got["count"]) >= 1
    for f in FIELDS:
        assert np.array_equal(np.asarray(got[f].to(torch.int64)), np.asarray(want[f]).astype(np.int64)), f

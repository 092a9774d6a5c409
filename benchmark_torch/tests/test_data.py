"""The data directory, the corpus and the traffic."""

import struct

import msgpack
import numpy as np
import pytest
import torch

from benchmark_torch import corpus, reference, segfile, traffic

SPECS = [
    ("uniform", {"kind": "uniform", "docs": 3000, "hashes_per_doc": 24}),
    ("bands", {"kind": "bands", "doc_bits": 12, "hashes_per_doc": 8}),
]
QUERY = {"uniform": {"target_hashes": 20, "noise_hashes": 100, "limit": 10, "min_score": 6, "pct": 10},
         "bands": {"target_hashes": 6, "noise_hashes": 4, "limit": 10, "min_score": 2, "pct": 10}}


@pytest.mark.parametrize("kind,spec", SPECS, ids=[k for k, _ in SPECS])
def test_data_dir_opens_in_the_port_and_answers_as_the_reference(tmp_path, kind, spec):
    from acoustid_index_tpu_torch.engine import filefmt
    from acoustid_index_tpu_torch.engine.model import SegmentInfo
    from acoustid_index_tpu_torch.multi.multi_index import MultiIndex, SearchRequestParams

    seed = 2**33 + 7
    c = corpus.make(spec, seed)
    root = str(tmp_path / "d")
    segfile.write_data_dir(root, "main", c, torch.device("cpu"))

    # The port's reader gets back exactly the sorted postings and docs.
    seg = filefmt.read_segment(str(tmp_path / "d" / "main" / "v000001" / "data"), SegmentInfo(1, 0, None))
    h, d = zip(*corpus.make(spec, seed).sorted_chunks(torch.device("cpu")))
    assert np.array_equal(seg.hashes.astype(np.int64), torch.cat(h).numpy())
    assert np.array_equal(seg.docids.astype(np.int64), torch.cat(d).numpy())
    assert np.array_equal(seg.docs_ids, np.arange(1, c.n_docs + 1, dtype=np.uint32)) and seg.docs_alive.all()

    mi = MultiIndex.open(root)
    try:
        q = traffic.make_queries(c, QUERY[kind], 64, seed)
        want = reference.search([c], q.hashes, q.limit, q.min_score, q.pct)
        got = [[(r.id, r.score) for r in mi.search("main", SearchRequestParams(
            query=row, limit=q.limit, min_score=q.min_score, score_pct=q.pct))] for row in q.hashes.tolist()]
    finally:
        mi.close()
    assert got == want
    assert sum(a[0][0] == t for a, t in zip(want, q.targets.tolist()) if a) >= 60  # the targets are found


def test_varints_match_the_codec():
    """The card-side varints equal the program's C++ codec's bytes."""
    from acoustid_index_tpu_torch.utils import native

    g = torch.Generator().manual_seed(5)
    h = torch.sort(torch.randint(0, 2**32, (5000,), generator=g, dtype=torch.int64)).values
    h[100:140] = h[100]  # a run of equal hashes
    d = torch.randint(1, 2**27, (5000,), generator=g, dtype=torch.int64)
    parts = []
    segfile.encode_postings([(h[:2500], d[:2500]), (h[2500:], d[2500:])], parts.append)
    want = native.encode_postings(h.numpy().astype(np.uint32), d.numpy().astype(np.uint32))
    assert b"".join(p.tobytes() for p in parts) == want


@pytest.mark.parametrize("kind,spec", SPECS, ids=[k for k, _ in SPECS])
def test_corpus_and_traffic_are_fixed_by_the_seed(kind, spec):
    def make(seed):
        c = corpus.make(spec, seed)
        chunks = [torch.cat(x) for x in zip(*c.sorted_chunks(torch.device("cpu")))]
        q = traffic.make_queries(c, QUERY[kind], 256, seed)
        return chunks, q, traffic.search_requests(q, "main", 10_000)

    big = 2**31 + 12345  # more than 32 signed bits
    a, b, other = make(big), make(big), make(big + 1)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and a[2] == b[2]
    assert torch.equal(a[1].hashes, b[1].hashes)
    assert not torch.equal(a[1].hashes, other[1].hashes) and a[2] != other[2]
    if kind == "uniform":
        assert not torch.equal(a[0][0], other[0][0])
    else:  # the hashes are the bench's; the seed moves the doc ids
        assert torch.equal(a[0][0], other[0][0]) and not torch.equal(a[0][1], other[0][1])


def test_requests_are_the_wire_format():
    c = corpus.make(SPECS[0][1], 3)
    q = traffic.make_queries(c, QUERY["uniform"], 4, 3)
    buf = traffic.search_requests(q, "main", 10_000)
    (n,) = struct.unpack_from("<Q", buf)
    (length,) = struct.unpack_from("<I", buf, 8)
    req = buf[12 : 12 + length]
    head, body = req.split(b"\r\n\r\n", 1)
    assert n == 4 and head.startswith(b"POST /main/_search HTTP/1.1")
    assert int(head.split(b"Content-Length: ")[1]) == len(body)
    assert msgpack.unpackb(body) == {"q": q.hashes[0].tolist(), "l": 10, "m": 6, "s": 10, "t": 10_000}

    upd = traffic.Updates(c.n_docs + 1, 640, 20, 24, 3)
    buf = traffic.Updates.requests(upd, "main", 31, 33)
    (length,) = struct.unpack_from("<I", buf, 8)
    body = buf[12 : 12 + length].split(b"\r\n\r\n", 1)[1]
    ids, v = upd.ids_versions(31)
    changes = msgpack.unpackb(body)["c"]
    assert [ch["i"]["i"] for ch in changes] == ids.tolist() and v == 0
    assert changes[0]["i"]["h"] == upd.hashes(ids, v)[0].tolist()
    ids, newest, prev = upd.final(64)  # two cycles: every id at version 1, before it 0
    assert torch.equal(newest, upd.hashes(ids, 1)) and torch.equal(prev, upd.hashes(ids, 0))


def test_reference_and_control():
    """The reference on a hand-made source; the control (half the hashes)
    changes the answers."""
    src = reference.Postings(torch.tensor([5, 5, 5, 7, 7, 9, 11]), torch.tensor([1, 2, 3, 1, 3, 1, 4]))
    q = torch.tensor([[5, 7, 9, 9, 11, 13]])
    assert reference.search([src], q, 10, 1, 10) == [[(1, 3), (3, 2), (2, 1), (4, 1)]]
    assert reference.search([src], q, 2, 1, 10) == [[(1, 3), (3, 2)]]
    assert reference.search([src], q, 10, 1, 67) == [[(1, 3), (3, 2)]]  # pct: nothing below 3 * 67 // 100
    assert reference.search([src], q, 10, 3, 10) == [[(1, 3)]]
    assert reference.search([src], q, 10, 1, 10, control=True) == [[(1, 3), (3, 2), (2, 1)]]  # 5, 7, 9 only

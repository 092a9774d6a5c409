"""One cluster, two packages: the changelog, meta-feed and snapshot wire
formats agree between the reference (acoustid_index_tpu) and the port
(acoustid_index_tpu_torch).

Every node is its package's own CLI in a subprocess on the CPU:
- a reference coordinator feeding a port replica (beside a reference one);
- a port coordinator (durable, `--coordinator-dir`) feeding a reference
  replica (beside a port one);
- a reference and a port replica, then, after the changelog's retention is
  truncated below its head, a late joiner of each package that must
  bootstrap from the OTHER package's `/_snapshot`.

In each case writes go through replicas of both packages, every search
answer on every replica equals tests/oracle.py over the corpus, and the
port's response bodies are byte-equal to the reference's.
"""

import numpy as np
import requests

from oracle import OracleSegment, oracle_search
from server_fixture import Server as RefServer
from test_torch_cluster import wait_until
from test_torch_refcases import Server as PortServer
from test_torch_refcases import post_search

N_DOCS = 48
N_QUERIES = 12


def _corpus(seed):
    """docid -> 12 hashes: 11 random and one shared by each group of 4 docs."""
    rng = np.random.default_rng(seed)
    return {i: [int(h) for h in rng.integers(1, 2**32 - 1, 11, dtype=np.uint64)] + [1000 + i // 4]
            for i in range(1, N_DOCS + 1)}


def _queries(docs, seed, extra=()):
    """6 hashes of a stored doc, its group's hash and 6 of noise; `extra`
    are queried as they are (a deleted doc's hashes)."""
    rng = np.random.default_rng(seed)
    ids = sorted(docs)
    out = []
    for _ in range(N_QUERIES):
        d = docs[ids[int(rng.integers(len(ids)))]]
        out.append(d[:6] + [d[-1]] + [int(h) for h in rng.integers(1, 2**32 - 1, 6, dtype=np.uint64)])
    return out + list(extra)


def _write(node, docs, ids):
    changes = [{"insert": {"id": i, "hashes": docs[i]}} for i in ids]
    r = requests.post(node.url("/idx/_update"), json={"changes": changes})
    assert r.status_code == 200, r.text
    return r.json()["version"]


def _version(node):
    return requests.get(node.url("/idx/_status")).json()["version"]


def _check(nodes, docs, queries):
    """Every node answers every query as the oracle does, and every body is
    byte-equal to the first node's."""
    seg = OracleSegment([(h, d) for d, hs in docs.items() for h in set(hs)], {d: True for d in docs})
    for q in queries:
        want = [{"id": d, "score": s} for d, s in oracle_search([seg], q, limit=10, min_score=2, pct=10)]
        bodies = []
        for node in nodes:
            r = post_search(node.url("/idx/_search"), json={"query": q, "limit": 10, "min_score": 2, "score_pct": 10})
            assert r.status_code == 200, r.text
            assert r.json()["results"] == want, (node.proc.args, q)
            bodies.append(r.content)
        assert all(b == bodies[0] for b in bodies), bodies


def _replica(cls, path, coord, peers=(), extra=("--checkpoint-age-ms", "0")):
    args = ["--coordinator-url", f"http://127.0.0.1:{coord.port}", *extra]
    if peers:
        args += ["--peers", ",".join(f"http://127.0.0.1:{p.port}" for p in peers)]
    return cls(path, extra_args=args)


def _two_replicas(coord_cls, coord_args, tmp_path, seed):
    """A coordinator of one package, a port and a reference replica; the
    corpus written half through each, then a delete and a re-insert."""
    procs = []
    try:
        coord = coord_cls(tmp_path / "coord", extra_args=["--coordinator", *coord_args]).start()
        procs.append(coord)
        port = _replica(PortServer, tmp_path / "port", coord).start()
        procs.append(port)
        ref = _replica(RefServer, tmp_path / "ref", coord).start()
        procs.append(ref)
        docs = _corpus(seed)

        assert requests.put(port.url("/idx")).status_code == 200
        wait_until(lambda: requests.head(ref.url("/idx")).status_code == 200, what="create on the reference", timeout=90)
        half = N_DOCS // 2
        _write(port, docs, range(1, half + 1))
        _write(ref, docs, range(half + 1, N_DOCS + 1))
        assert requests.delete(ref.url(f"/idx/{N_DOCS}")).status_code == 200
        gone = docs.pop(N_DOCS)
        old = docs[1]
        docs[1] = docs[1][:6] + docs[2][6:]  # a re-insert through the port
        last = _write(port, docs, [1])
        for node in (port, ref):
            wait_until(lambda: _version(node) >= last, what="convergence", timeout=90)
        _check([ref, port], docs, _queries(docs, seed, extra=[gone, old]))
    finally:
        for p in procs:
            p.stop()


def test_reference_coordinator_feeds_port_replica(tmp_path):
    _two_replicas(RefServer, [], tmp_path, seed=71)


def test_port_coordinator_feeds_reference_replica(tmp_path):
    _two_replicas(PortServer, ["--coordinator-dir", str(tmp_path / "log")], tmp_path, seed=72)


def test_late_joiners_bootstrap_from_the_other_package(tmp_path):
    """After a retention truncation, a late port replica bootstraps from
    the reference replica's snapshot and a late reference replica from the
    port replica's; all four then serve the corpus and a later write."""
    procs = []
    fast = ("--checkpoint-threshold", "10", "--checkpoint-age-ms", "500")
    try:
        coord = PortServer(tmp_path / "coord", extra_args=["--coordinator"]).start()
        procs.append(coord)
        ref = _replica(RefServer, tmp_path / "ref", coord, extra=fast).start()
        procs.append(ref)
        port = _replica(PortServer, tmp_path / "port", coord, extra=fast).start()
        procs.append(port)
        docs = _corpus(73)
        queries = _queries(docs, 73)

        assert requests.put(ref.url("/idx")).status_code == 200
        wait_until(lambda: requests.head(port.url("/idx")).status_code == 200, what="create on the port", timeout=90)
        half = N_DOCS // 2
        _write(ref, docs, range(1, half + 1))
        version = _write(port, docs, range(half + 1, N_DOCS + 1))
        for node in (ref, port):  # each donor's snapshot covers the corpus
            wait_until(lambda: requests.get(node.url("/idx/_status")).json()["file_version"] >= version,
                       what="file_version", timeout=90)
        gen = requests.get(ref.url("/idx/_status")).json()["generation"]
        r = requests.post(coord.url(f"/_truncate/idx/{gen}"), params={"floor": version})
        assert r.status_code == 200, r.text

        late_port = _replica(PortServer, tmp_path / "late_port", coord, peers=[ref]).start()
        procs.append(late_port)
        late_ref = _replica(RefServer, tmp_path / "late_ref", coord, peers=[port]).start()
        procs.append(late_ref)
        for node in (late_port, late_ref):
            wait_until(lambda: requests.get(node.url("/idx/_health")).status_code == 200
                       and _version(node) >= version, what="bootstrap", timeout=90)
        nodes = [ref, port, late_port, late_ref]
        _check(nodes, docs, queries)

        # A later write reaches every replica by the changelog.
        docs[N_DOCS + 1] = [7, 8, 9, 10] + docs[3][4:]
        last = _write(late_port, docs, [N_DOCS + 1])
        for node in nodes:
            wait_until(lambda: _version(node) >= last, what="post-bootstrap consumption", timeout=90)
        _check(nodes, docs, queries + [docs[N_DOCS + 1][:8]])
    finally:
        for p in procs:
            p.stop()

"""The 134M corpus through the front door (bench_100m.load_through_server),
on a window of it, against the JAX package's CLI server and the oracle.

A window of 2^13 whole docs of the corpus, positions [2^21 - 2^12, 2^21 +
2^12) (65,536 postings; the hot runs of all 8 bands and their pair runs),
goes as the same msgpack `_bulk` bodies (256 docs each, so the memory tier
merges during the stream) with the same flags (checkpoint threshold one
below the window's postings, no age trigger, the native front) to the
port's CLI server, in this process through main.build_server
(AITPU_TORCH_DEVICE=cpu), and to the JAX package's, as
tests/server_fixture.py runs it (JAX_PLATFORMS=cpu).  Both take the load
in one threshold checkpoint whose merges run on the device-merge route
(its threshold lowered; CPU tensors in the port), with a file tier small
enough to interleave (AITPU_RESIDENT_MAX_BYTES), and both restart on
their directories.  Then:

  * each manifest names exactly one file segment; the port counted device
    merges and no fallback, and serves the restarted file tier
    interleaved;
  * 256 queries of bench_100m.make_queries over the window and a boundary
    batch give the same ids, scores and order on both servers, equal to
    tests/oracle.py over the analytic oracle_postings of the window; the
    port's native front answers byte-equal to its Python server;
  * the write mix through `_update` (new docs above 2^27, stored docs
    rewritten with new hashes, deletes) reads back on both, and the
    searches for the written docs and for the targets they replaced give
    the same answers on both, equal to the oracle with the changes applied.

Every compared value is an integer: the tolerance is 0.
"""

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import requests

from acoustid_index_tpu_torch import bench_100m as b
from acoustid_index_tpu_torch import main as cli
from acoustid_index_tpu_torch.engine import device_merge, manifest

from oracle import OracleSegment, oracle_search
from server_fixture import Server, post_search

P0, P1 = (1 << 21) - (1 << 12), (1 << 21) + (1 << 12)
POSTINGS = b.HASHES_PER_DOC * (P1 - P0)
BODY_DOCS = 256
ENV = {"AITPU_RESIDENT_MAX_BYTES": str(64 * 1024), "AITPU_DEVICE_MERGE_MIN_POSTINGS": "1"}
# The JAX server's Pallas kernels run in interpret mode here: fewer lookups
# per grid step compile and run faster and change no result.
INTERPRET_G = {k: "8" for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G")}
N_NEW, N_REWRITE, N_DELETE = 64, 5, 5


def _index_dir(root):
    return os.path.join(root, "main", "v000001")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(the port's restarted build_server tuple, its load figures, the JAX
    package's restarted Server, the JAX directory)."""
    import torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AITPU_TORCH_DEVICE", "cpu")
        mp.setenv("AITPU_RESIDENT_MAX_BYTES", ENV["AITPU_RESIDENT_MAX_BYTES"])
        mp.delenv("AITPU_DEVICE_MERGE_MIN_POSTINGS", raising=False)
        mp.setattr(device_merge, "DEVICE_MERGE_MIN_POSTINGS", 1)
        served, fig = b.load_through_server(torch.device("cpu"), str(tmp_path_factory.mktemp("port")), P0, P1,
                                            body_docs=BODY_DOCS, log=lambda msg: None)
        jax_dir = str(tmp_path_factory.mktemp("jax"))
        ref = Server(jax_dir, ["--checkpoint-threshold", str(POSTINGS - 1), "--checkpoint-age-ms", "0",
                               "--search-port", "-1"], env_extra={**ENV, **INTERPRET_G, "JAX_PLATFORMS": "cpu"}).start()
        try:
            assert requests.put(ref.url("/main"), timeout=60).status_code == 200
            b._post_bodies(ref.port, P0, P1, BODY_DOCS, b.LOAD_THREADS)
            data = os.path.join(_index_dir(jax_dir), "data")
            for _ in range(1200):  # the threshold checkpoint writes one segment at once
                if manifest.read_manifest(data):
                    break
                time.sleep(0.05)
            ref.restart()
            yield served, fig, ref, jax_dir
        finally:
            ref.stop()
            cli.stop_server(*served)


def _jax_search(ref, queries):
    """The raw _search bodies of the JAX server for `queries`, from
    b.THREADS clients, each retried through the 503 that a search queued
    behind a cold program compile gets (server_fixture.post_search)."""

    def one(q):
        r = post_search(ref.url("/main/_search"), retry_s=300, timeout=120,
                        json={"query": q, "limit": b.LIMIT, "min_score": b.MIN_SCORE, "score_pct": b.PCT,
                              "timeout": 10_000})
        assert r.status_code == 200, r.text
        return r.content

    with ThreadPoolExecutor(b.THREADS) as pool:
        return list(pool.map(one, queries))


def _results(raw):
    return [(r["id"], r["score"]) for r in json.loads(raw)["results"]]


def _oracle(segments, q, min_score=b.MIN_SCORE):
    return oracle_search(segments, q, limit=b.LIMIT, min_score=min_score, pct=b.PCT)


def test_load_is_one_device_merged_file_segment(servers):
    served, fig, _, jax_dir = servers
    assert fig["bodies"] == (P1 - P0) // BODY_DOCS
    assert fig["merges"]["device"] >= 2 and fig["merges"]["fallback"] == 0  # memory merges and the checkpoint
    port_dir = os.path.dirname(os.path.dirname(b._index(served[1]).path))
    for root in (port_dir, jax_dir):
        (info,) = manifest.read_manifest(os.path.join(_index_dir(root), "data"))
        assert info.commit_id == 1 and info.last_commit_id() == fig["bodies"]


def test_restart_serves_the_interleaved_file_tier(servers):
    served, fig, _, _ = servers
    snap = b._index(served[1]).ensure_views(b._index(served[1]).acquire_reader())
    assert len(snap.file) == 1 and not snap.memory and snap.file[0].num_items == POSTINGS
    assert snap.file_view["inter"].numel() == fig["file_tier_entries"] == 2 * POSTINGS
    assert fig["restart_s"] > fig["reopen_s"] > 0


def test_searches_equal_across_packages_and_oracle(servers):
    served, _, ref, _ = servers
    rng = np.random.default_rng(21)
    batches = [b.make_queries(rng, 256, P0, P1), b.boundary_queries(rng, 64, P1)]
    corpus = [b.OracleCorpus(P0, P1)]
    fig = b.serve_fronts(served, batches, lambda q: _oracle(corpus, q), log=lambda msg: None)
    assert fig["searches"] == 320
    queries = [qs[i, : lens[i]].tolist() for _, qs, lens in batches for i in range(qs.shape[0])]
    port, _ = b.search_http(served[0].port, queries)
    jax = _jax_search(ref, queries)
    for q, x, y in zip(queries, port, jax):
        assert _results(x) == _results(y) == _oracle(corpus, q)


def test_write_mix_equal_across_packages_and_oracle(servers):
    served, _, ref, _ = servers
    rng = np.random.default_rng(22)
    targets = b.np_bitrev27(rng.choice(np.arange(P0, P1), N_REWRITE + N_DELETE, replace=False)) + np.uint32(1)
    new_ids = np.arange(b.N_DOCS + 1, b.N_DOCS + 1 + N_NEW, dtype=np.uint32)
    latest = {int(i): rng.integers(0, 2**32, b.HASHES_PER_DOC, dtype=np.uint32).tolist() for i in new_ids}
    latest.update({int(t): rng.integers(0, 2**32, b.HASHES_PER_DOC, dtype=np.uint32).tolist()
                   for t in targets[:N_REWRITE]})
    deleted = [int(t) for t in targets[N_REWRITE:]]
    changes = [{"insert": {"id": i, "hashes": h}} for i, h in latest.items()] + [{"delete": {"id": i}} for i in deleted]
    for base in (f"http://127.0.0.1:{served[0].port}", ref.url("")):
        r = requests.post(f"{base}/main/_update", json={"changes": changes}, timeout=60)
        assert r.status_code == 200, r.text
        for i in list(latest)[:8] + [int(t) for t in targets[:N_REWRITE]]:
            assert requests.get(f"{base}/main/{i}", timeout=60).status_code == 200
        for i in deleted:
            assert requests.get(f"{base}/main/{i}", timeout=60).status_code == 404

    segments = [b.OracleCorpus(P0, P1),
                OracleSegment([(h, d) for d, hs in latest.items() for h in hs],
                              {**{d: True for d in latest}, **{d: False for d in deleted}})]
    noise = rng.integers(0, 2**32, (len(latest), 4), dtype=np.uint32)
    queries = [sorted(set(h[:6]) | set(noise[k].tolist())) for k, h in enumerate(latest.values())]
    queries += [b.doc_hashes_np(np.asarray([t], np.uint32))[0, :6].tolist() for t in targets]
    port, _ = b.search_http(served[0].port, queries)
    jax = _jax_search(ref, queries)
    for k, (q, x, y) in enumerate(zip(queries, port, jax)):
        assert _results(x) == _results(y) == _oracle(segments, q)
        if k < len(latest):
            assert _results(x)[0] == (list(latest)[k], 6)
        else:
            assert int(targets[k - len(latest)]) not in [d for d, _ in _results(x)]

"""The port's headline benchmark (acoustid_index_tpu_torch/bench.py and
bench_client.py) against the root bench.py, the JAX package and the oracle.

On the CPU (AITPU_TORCH_DEVICE=cpu), at a small size:

  (a) doc_hashes and make_queries equal the root bench's (which imports only
      the standard library and numpy at its top) bit for bit at one seed;
  (b) the parity gate's snapshot, drawn as the root bench draws it, gives the
      same answers in the port's Searcher (both file-tier layouts) and in the
      reference's Searcher (Pallas in interpret mode, as the JAX tests run
      it), and both equal tests/oracle.py;
  (c) the kernel phase's table at 20K docs (measure.pack_10m) equals the root
      bench's sort_postings + interleave_jnp of the same postings bit for
      bit, and one batch's ids, scores and count equal the reference's
      search_segments_batch on the root bench's tiers;
  (d) a whole run (--no-134m --client python, 20K docs, 0.5 s windows)
      prints a last line of the root bench's headline keys plus
      pipeline_qps, with no miss, e2e_rw_segments > 1, stubbed windows that
      ran no program, and the root BENCH_DETAIL.json byte-unchanged;
  (e) bench_client.py against the port's Python front counts a wrong
      expected blob as a miss, and a right one as a hit;
  (f) importing the bench and its client imports neither jax nor the JAX
      package.

Every compared output is an integer: the tolerance is 0.  Device rates are
not measured on the CPU (the bench writes null for them); they come only
from a card (`python -m acoustid_index_tpu_torch.bench`).
"""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import bench as ref_bench  # the root script: stdlib and numpy only at its top
from acoustid_index_tpu_torch import bench as port_bench
from acoustid_index_tpu_torch import measure
from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher, Searcher, _params_for
from acoustid_index_tpu_torch.ops import block_lookup as port_bl

from oracle import OracleSegment, oracle_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = 20_000  # docs in the 10M phase's place and in E2E_DOCS' place


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    # The reference kernels run in interpret mode here; results do not
    # depend on their lookups per grid step, and small steps keep it fast.
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


# ---- (a) the corpus and the queries ----


@pytest.mark.parametrize("seed", [0, 1])
def test_doc_hashes_and_make_queries_match_root_bench(seed):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.array([0, 1, 2, ref_bench.N_DOCS, 2**32 - 1], np.uint32),
                          rng.integers(1, ref_bench.N_DOCS + 1, 4096, dtype=np.uint32)])
    want = ref_bench.doc_hashes(ids, ref_bench.HASHES_PER_DOC)
    got = port_bench.doc_hashes(ids)
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)

    want = ref_bench.make_queries(np.random.default_rng(seed), 64, 128, ref_bench.N_DOCS)
    got = port_bench.make_queries(np.random.default_rng(seed), 64, 128, ref_bench.N_DOCS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (port_bench.N_DOCS, port_bench.HASHES_PER_DOC, port_bench.NOISE_HASHES) == (
        ref_bench.N_DOCS, ref_bench.HASHES_PER_DOC, ref_bench.NOISE_HASHES)


# ---- (b) the parity gate ----


def _root_gate_draws():
    """bench.py's parity_gate draws (:79-91, :114-117), in its order."""
    rng = np.random.default_rng(77)
    dh = {i: rng.integers(0, 2**32, 24, dtype=np.uint32).tolist() for i in range(1, 4001)}
    first = dict(dh)
    redo = {}
    for i in [1, 7, 3999]:
        dh[i] = redo[i] = rng.integers(0, 2**32, 24, dtype=np.uint32).tolist()
    queries = [
        np.unique(np.concatenate([np.asarray(dh[t][:20], np.uint32), rng.integers(0, 2**32, 100, dtype=np.uint32)])).tolist()
        for t in (1, 7, 42, 100, 2000, 3999)
    ]
    return first, redo, queries


def test_parity_gate_matches_reference_searcher_and_oracle():
    from acoustid_index_tpu.engine import model as ref_model
    from acoustid_index_tpu.engine.memseg import build_segment as ref_build_segment
    from acoustid_index_tpu.engine.searcher import Searcher as RefSearcher
    from acoustid_index_tpu.engine.segments import FILE_SLOTS, MEMORY_SLOTS, Snapshot, pack_tier

    first, redo, queries = port_bench.gate_corpus()
    assert (first, redo, queries) == _root_gate_draws()
    assert port_bench.GATE_TARGETS == (1, 7, 42, 100, 2000, 3999) and port_bench.GATE_DELETE == 42

    f1, f2, m1 = port_bench.gate_segments(ref_model, ref_build_segment, first, redo)
    ref_snap = Snapshot(file=(f1, f2), memory=(m1,), file_view=pack_tier([f1, f2], FILE_SLOTS),
                        mem_view=pack_tier([m1], MEMORY_SLOTS))
    ref_opts = ref_model.SearchOptions(max_results=15, min_score=2, min_score_pct=10)
    ref_searcher = RefSearcher()
    want = [[(r.id, r.score) for r in ref_searcher.search(ref_snap, q, ref_opts)[0]] for q in queries]

    segs = [OracleSegment(list(zip(s.hashes.tolist(), s.docids.tolist())), dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())))
            for s in (f1, f2, m1)]
    assert want == [oracle_search(segs, q, limit=15, min_score=2, pct=10) for q in queries]
    assert all(r[0] != 42 for r in want[2])  # the deleted target is not found
    assert all(w and w[0][0] == t for w, t in zip(want, port_bench.GATE_TARGETS) if t != 42)

    snaps, port_segs = port_bench.gate_snapshots(CPU)
    assert set(snaps) == {"plain", "interleaved"}
    assert "hashes" in snaps["plain"].file_view and "inter" in snaps["interleaved"].file_view
    for ps, rs in zip(port_segs, (f1, f2, m1)):
        assert np.array_equal(ps.hashes, rs.hashes) and np.array_equal(ps.docids, rs.docids)
    searcher = Searcher(CPU)
    opts = port_bench._options(15, 2, 10)
    for snap in snaps.values():
        assert [[(r.id, r.score) for r in searcher.search(snap, q, opts)[0]] for q in queries] == want
    out = port_bench.parity_gate(CPU)
    assert out["parity_gate"] == "ok" and out["parity_gate_launches"]["programs"] == 2 * len(queries)


# ---- (c) the kernel phase ----


def test_kernel_table_and_batch_match_reference(monkeypatch):
    from acoustid_index_tpu.engine.searcher import _params_for as ref_params_for
    from acoustid_index_tpu.ops import search_kernel as ref_sk
    from acoustid_index_tpu.ops.build import sort_postings
    from acoustid_index_tpu.ops.layout import interleave_jnp

    monkeypatch.setenv("AITPU_RESIDENT_MAX_BYTES", "65536")  # the 10M tier's layout at 20K docs
    snap, _ = measure.pack_10m(CPU, SMALL)
    n = SMALL * ref_bench.HASHES_PER_DOC
    cap = 1 << (n - 1).bit_length()  # the root bench's power-of-two table
    ids = np.arange(1, SMALL + 1, dtype=np.uint32)
    h, d = sort_postings(jnp.asarray(ref_bench.doc_hashes(ids, ref_bench.HASHES_PER_DOC).reshape(-1)),
                         jnp.asarray(np.repeat(ids, ref_bench.HASHES_PER_DOC)), n)
    h_pad = np.full(cap, 0xFFFFFFFF, np.uint32)
    d_pad = np.full(cap, 0xFFFFFFFF, np.uint32)
    h_pad[:n], d_pad[:n] = np.asarray(h), np.asarray(d)
    want_inter = np.asarray(interleave_jnp(jnp.asarray(h_pad), jnp.asarray(d_pad)))
    got_inter = snap.file_view["inter"].numpy().view(np.uint32)
    assert got_inter.shape == want_inter.shape and np.array_equal(got_inter, want_inter)
    assert np.array_equal(snap.file_view["block_index"].numpy().view(np.uint32), h_pad[::1024])
    assert [s.num_docs for s in snap.file] == [SMALL]

    params = _params_for(128)
    targets, qs, lens = port_bench.make_queries(np.random.default_rng(17), 8, params.query_len, SMALL)
    got = port_bench._search(Searcher(CPU), snap, params, port_bench._pack(qs, lens))
    file_tier = {
        "inter": jnp.asarray(want_inter), "block_index": jnp.asarray(h_pad[::1024]),
        "seg_start": jnp.zeros(1, jnp.int32), "seg_len": jnp.full(1, n, jnp.int32),
        "mention_ids": jnp.full(1 << 15, 0xFFFFFFFF, jnp.uint32).at[:SMALL].set(jnp.asarray(ids)),
        "mention_len": jnp.int32(SMALL),
    }
    mem_tier = {
        "hashes": jnp.full(1024, 0xFFFFFFFF, jnp.uint32), "docids": jnp.full(1024, 0xFFFFFFFF, jnp.uint32),
        "block_index": jnp.full(1, 0xFFFFFFFF, jnp.uint32), "seg_start": jnp.zeros(1, jnp.int32),
        "seg_len": jnp.zeros(1, jnp.int32), "mention_ids": jnp.full(1024, 0xFFFFFFFF, jnp.uint32),
        "mention_len": jnp.int32(0),
    }
    b = qs.shape[0]
    want = ref_sk.search_segments_batch(ref_params_for(128), file_tier, mem_tier, qs, lens, np.full(b, 10, np.int32),
                                        np.full(b, 6, np.int32), np.full(b, 10, np.int32))
    for k in ("ids", "scores", "count"):
        assert np.array_equal(got[k], np.asarray(want[k]).astype(got[k].dtype)), k
    assert np.array_equal(got["ids"][:, 0], targets)


# ---- (d) a whole run ----


def _root_headline_keys():
    """The `headline_keys` list of the root bench's main()."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "headline_keys":
            return ast.literal_eval(node.value)
    raise AssertionError("bench.py has no headline_keys")


def test_whole_run_headline_and_checks(tmp_path):
    root_detail = os.path.join(REPO, "BENCH_DETAIL.json")
    with open(root_detail, "rb") as f:
        root_before = f.read()
    out = tmp_path / "detail.json"
    env = dict(os.environ, AITPU_TORCH_DEVICE="cpu", AITPU_RESIDENT_MAX_BYTES="65536",
               AITPU_DEVICE_MERGE_MIN_POSTINGS="1000")
    cmd = [sys.executable, "-m", "acoustid_index_tpu_torch.bench", "--no-134m", "--client", "python",
           "--docs", str(SMALL), "--e2e-docs", str(SMALL), "--seconds", "0.5", "--e2e-threads", "4",
           "--inflight", "64", "--native-procs", "2", "--native-conns", "4", "--native-pumps", "2",
           "--out", str(out)]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])

    ref_keys = _root_headline_keys()
    assert port_bench.HEADLINE_KEYS == ref_keys[:14] + ["pipeline_qps"] + ref_keys[14:]
    skipped = {"qps_134M", "hit_rate_134M", "n_docs_134M"}  # --no-134m
    want = {k for k in ref_keys if not k.endswith("_error") and k not in skipped} | {"pipeline_qps", "detail"}
    assert set(line) == want
    assert line["parity_gate"] == "ok" and line["device"] == "cpu" and line["detail"] == str(out)
    assert line["self_retrieval_hit_rate"] > 0.95 and line["e2e_rw_segments"] > 1
    # No device rate is measured on the CPU.
    assert line["value"] is None and line["sharded_qps_mesh1"] is None and line["e2e_rw_device_qps"] is None
    for k in ("pipeline_qps", "e2e_pipeline_qps", "e2e_native_qps", "e2e_hostonly_qps", "e2e_native_hostonly_qps",
              "e2e_pyhttp_hostonly_qps", "e2e_rw_qps", "e2e_http_ingest_docs_per_s"):
        assert line[k] > 0, k

    with open(out) as f:
        detail = json.load(f)
    for k in ("e2e_miss_rate", "e2e_pipeline_miss_rate", "e2e_native_miss_rate", "e2e_rw_miss_rate"):
        assert detail[k] == 0, k
    assert detail["sharded_hit_rate"] > 0.95
    assert detail["e2e_checkpoint_merges"] == {"device": 1, "host": 0, "fallback": 0}
    assert detail["e2e_checkpoint_sources"] == 8
    stubs = detail["stubbed_windows"]
    assert set(stubs) == {"e2e_native_hostonly", "e2e_pyhttp_hostonly", "e2e_hostonly"}
    assert all(v == {"block_count": 0, "block_count_emit": 0, "programs": 0} for v in stubs.values()), stubs
    assert detail["e2e_native_launches"]["programs"] > 0 and detail["kernel_launches"]["programs"] > 0
    assert not [k for k in detail if k.endswith("_error")]
    with open(root_detail, "rb") as f:
        assert f.read() == root_before


# ---- (e) the load client ----


def test_bench_client_counts_wrong_blob_as_miss(tmp_path):
    from acoustid_index_tpu_torch.multi.multi_index import MultiIndex
    from acoustid_index_tpu_torch.server.app import App
    from acoustid_index_tpu_torch.server.http import HttpServer

    searcher = BatchingSearcher(device=CPU)
    mi = MultiIndex.open(str(tmp_path / "idx"), checkpoint_age=None, sync=False, searcher=searcher)
    mi.create_index("main")
    ref = mi._get_ref("main")
    ids = np.arange(1, 201, dtype=np.uint32)
    ref.index.bulk_insert(ids, port_bench.doc_hashes(ids))
    mi._release_ref(ref)
    app = App(mi)
    server = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
    thread = server.serve_background()
    try:
        rng = np.random.default_rng(3)
        reqs = []
        for t in (5, 50, 150):
            body = json.dumps({"query": port_bench._query(rng, t), "limit": 40, "min_score": 6, "score_pct": 10,
                               "timeout": 10000}).encode()
            reqs.append((t, b"POST /main/_search HTTP/1.1\r\nHost: b\r\nContent-Type: application/json\r\n"
                            b"Content-Length: %d\r\n\r\n%s" % (len(body), body)))
        runs = {}
        for label, shift in (("right", 0), ("wrong", 1)):
            path = tmp_path / f"{label}.blobs"
            path.write_bytes(msgpack.packb([(b'"results": [{"id": %d,' % (t + shift), req) for t, req in reqs]))
            r = subprocess.run([sys.executable, os.path.join(REPO, "acoustid_index_tpu_torch", "bench_client.py"),
                                "--port", str(server.port), "--seconds", "1", "--conns", "2", "--blobs", str(path)],
                               capture_output=True, text=True, timeout=120)
            assert r.returncode == 0, r.stderr[-2000:]
            runs[label] = json.loads(r.stdout.strip().splitlines()[-1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        mi.close()
        searcher.close()
    assert runs["right"]["count"] > 0 and runs["right"]["miss"] == 0, runs
    assert runs["wrong"]["count"] > 0 and runs["wrong"]["miss"] == runs["wrong"]["count"], runs


# ---- (f) imports ----


def test_bench_imports_no_jax():
    code = ("import sys, acoustid_index_tpu_torch.bench, acoustid_index_tpu_torch.bench_client; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'acoustid_index_tpu', 'probes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

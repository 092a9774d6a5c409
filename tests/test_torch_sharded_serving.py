"""End-to-end mesh-sharded serving in the port (parallel/serving.py): the
cases of tests/test_sharded_serving.py against the port, on the CPU.

An Index whose searcher is the port's ShardedBatchingSearcher (N shards as
slices of the CPU device) must answer as the reference's Index over its own
ShardedBatchingSearcher (the virtual 8-device mesh of tests/conftest.py)
fed the same writes -- results and all four statistics -- and as the
oracle and the port's single-device searcher, through writes, deletes,
supersession and checkpoints; the CLI must serve identically under
--mesh-shards, on its HTTP and native ports, across a restart.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import replace

import jax
import numpy as np
import pytest
import requests

from acoustid_index_tpu.engine.index import Index as RefIndex
from acoustid_index_tpu.engine.model import Delete as RefDelete
from acoustid_index_tpu.engine.model import Insert as RefInsert
from acoustid_index_tpu.engine.model import SearchOptions as RefSearchOptions
from acoustid_index_tpu.parallel.serving import ShardedBatchingSearcher as RefShardedSearcher
from acoustid_index_tpu_torch.engine.index import Index
from acoustid_index_tpu_torch.engine.model import Delete, Insert, SearchOptions
from acoustid_index_tpu_torch.engine.searcher import Searcher
from acoustid_index_tpu_torch.engine.segments import FILE_SLOTS, MEMORY_SLOTS, pack_tier
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.ops import search_kernel as port_sk
from acoustid_index_tpu_torch.parallel import sharded as port_sharded
from acoustid_index_tpu_torch.parallel.serving import ShardedBatchingSearcher

from oracle import OracleSegment, oracle_search
from server_fixture import post_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


def snapshot_oracle(snapshot, query, limit=10, min_score=1, pct=10):
    segs = [
        OracleSegment(
            list(zip(s.hashes.tolist(), s.docids.tolist())),
            dict(zip(s.docs_ids.tolist(), s.docs_alive.tolist())),
        )
        for s in snapshot.all_segments()
    ]
    return oracle_search(segs, query, limit=limit, min_score=min_score, pct=pct)


def single_device(snapshot, query, limit=10, min_score=1, pct=10):
    snap = replace(
        snapshot,
        file_view=pack_tier(list(snapshot.file), FILE_SLOTS, device="cpu"),
        mem_view=pack_tier(list(snapshot.memory), MEMORY_SLOTS, device="cpu"),
    )
    res, _ = Searcher(device="cpu").search(
        snap, query, SearchOptions(max_results=limit, min_score=min_score, min_score_pct=pct)
    )
    return [(r.id, r.score) for r in res]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_index_lifecycle_matches_oracle(tmp_path, n):
    rng = np.random.default_rng(11)
    searcher = ShardedBatchingSearcher(n_shards=n, device="cpu")
    ref_searcher = RefShardedSearcher(n_shards=n)
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    ref = RefIndex.open(str(tmp_path / "ref"), checkpoint_age=None, searcher=ref_searcher)
    try:
        def update(changes):
            idx.update([(Insert(id=c[1], hashes=c[2]) if c[0] == "i" else Delete(id=c[1])) for c in changes])
            ref.update([(RefInsert(id=c[1], hashes=c[2]) if c[0] == "i" else RefDelete(id=c[1])) for c in changes])

        docs = {}
        # Several write batches; hashes span the whole u32 space.
        for batch in range(4):
            changes = []
            for i in range(batch * 40 + 1, batch * 40 + 41):
                h = rng.integers(0, 2**32, 12, dtype=np.uint32).tolist()
                docs[i] = h
                changes.append(("i", i, h))
            update(changes)
        # Checkpoint moves everything into the file tier (sharded repack).
        assert idx.checkpoint(force=True) and ref.checkpoint(force=True)

        # Supersession pressure: re-insert some, delete others, leave in memory.
        re_ins = []
        for i in (3, 50, 90):
            h = rng.integers(0, 2**32, 12, dtype=np.uint32).tolist()
            docs[i] = h
            re_ins.append(("i", i, h))
        update(re_ins)
        update([("d", 7, None), ("d", 120, None)])
        docs.pop(7), docs.pop(120)

        snapshot = idx.acquire_reader()
        assert snapshot.file_view["mention_len"].shape == (n,)  # host-side, never read
        assert sum(slot["mention_len"].shape[0] for slot in snapshot.mem_view["slots"]) == n  # on the slots
        syncs = batches = 0
        for target in (3, 7, 12, 50, 90, 120, 155):
            base = docs.get(target, rng.integers(0, 2**32, 12, dtype=np.uint32).tolist())
            query = list(base[:9]) + rng.integers(0, 2**32, 3, dtype=np.uint32).tolist()
            want = snapshot_oracle(snapshot, query, limit=20, min_score=1, pct=0)
            syncs0, batches0 = port_sk.STATS["host_syncs"], port_sharded.STATS["batches"]
            res, stats = idx.search(query, SearchOptions(max_results=20, min_score=1, min_score_pct=0))
            syncs += port_sk.STATS["host_syncs"] - syncs0
            batches += port_sharded.STATS["batches"] - batches0
            ref_res, ref_stats = ref.search(query, RefSearchOptions(max_results=20, min_score=1, min_score_pct=0))
            got = [(r.id, r.score) for r in res]
            assert got == want, (target, got, want)
            assert got == single_device(snapshot, query, limit=20, min_score=1, pct=0)
            assert got == [(r.id, r.score) for r in ref_res]
            assert (stats.postings_scanned, stats.truncated, stats.max_per_hash, stats.max_blocks_per_hash) == (
                ref_stats.postings_scanned, ref_stats.truncated, ref_stats.max_per_hash, ref_stats.max_blocks_per_hash
            )
        assert batches == 7 and syncs <= 2 * batches
    finally:
        idx.close()
        ref.close()
        searcher.close()
        ref_searcher.close()


def test_sharded_concurrent_searches_coalesce(tmp_path):
    rng = np.random.default_rng(5)
    searcher = ShardedBatchingSearcher(n_shards=8, max_wait=0.02, device="cpu")
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    try:
        docs = {i: rng.integers(0, 2**32, 16, dtype=np.uint32).tolist() for i in range(1, 120)}
        idx.update([Insert(id=i, hashes=h) for i, h in docs.items()])
        idx.search(docs[1], SearchOptions())

        results = {}
        errors = []

        def one(i):
            try:
                res, _ = idx.search(docs[i], SearchOptions(max_results=5))
                results[i] = [(r.id, r.score) for r in res]
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        batches0 = port_sharded.STATS["batches"]
        threads = [threading.Thread(target=one, args=(i,)) for i in range(1, 33)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        for i in range(1, 33):
            assert results[i][0] == (i, 16), (i, results[i])
        assert port_sharded.STATS["batches"] - batches0 < 32  # requests shared batches
    finally:
        idx.close()
        searcher.close()


def test_dryrun_multichip_on_cpu(capsys):
    from acoustid_index_tpu_torch.entry import dryrun_multichip

    batches0 = port_sharded.STATS["batches"]
    dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): ingest + sharded search + sharded serving OK on cpu" in capsys.readouterr().out
    assert port_sharded.STATS["batches"] - batches0 >= 3


class _CliServer:
    """The port's CLI in its own process on the CPU, announcing its ports."""

    ARGS = ("--mesh-shards", "8", "--search-port", "-1", "--profile-port", "-1", "--checkpoint-age-ms", "0")

    def __init__(self, data_dir):
        self.data_dir = str(data_dir)
        self.proc = None
        self.ports = {}

    def start(self):
        env = dict(os.environ, PYTHONPATH=REPO, AITPU_TORCH_DEVICE="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "acoustid_index_tpu_torch.main", "--dir", self.data_dir, "--port", "0", *self.ARGS],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO,
        )
        self.ports = {}
        deadline = time.time() + 120
        while len(self.ports) < 3 and time.time() < deadline:
            line = self.proc.stdout.readline()
            word, _, port = line.partition(" ")
            if word in ("LISTENING", "SEARCHPLANE", "PROFILER"):
                self.ports[word] = int(port)
            elif not line and self.proc.poll() is not None:
                raise RuntimeError("server died on startup")
        assert len(self.ports) == 3, self.ports

    def url(self, word, path):
        return f"http://127.0.0.1:{self.ports[word]}{path}"

    def stop(self):
        if self.proc is None:
            return None
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.proc = None
        return rc


def test_http_server_mesh_shards(tmp_path):
    """--mesh-shards 8 with the native search front: the HTTP answer, the
    native body byte-equal to it, a profiler capture holding a sharded
    batch, and the same answer after a restart."""
    s = _CliServer(tmp_path / "data")
    s.start()
    try:
        u = lambda path: s.url("LISTENING", path)  # noqa: E731
        assert requests.put(u("/main"), json={}).status_code == 200
        for i in range(1, 40):
            r = requests.put(u(f"/main/{i}"), json={"hashes": [i * 7, i * 7 + 1, 2**31 + i]})
            assert r.status_code == 200, r.text
        body = {"query": [21, 22, 2**31 + 3], "min_score": 1, "score_pct": 0}
        r = post_search(u("/main/_search"), json=body)
        assert r.status_code == 200, r.text
        assert r.json()["results"][0] == {"id": 3, "score": 3}

        # The native front pumps through the same sharded searcher.
        rn = post_search(s.url("SEARCHPLANE", "/main/_search"), json=body)
        assert rn.status_code == 200 and rn.content == r.content

        # A capture window that holds searches (sent until it returns: the
        # profiler's start takes part of the window).
        got = {}
        t = threading.Thread(target=lambda: got.update(r=requests.get(s.url("PROFILER", "/capture?ms=2500"), timeout=120)))
        t.start()
        while t.is_alive():
            assert post_search(u("/main/_search"), json=body).content == r.content
            time.sleep(0.05)
        t.join(timeout=120)
        assert got["r"].status_code == 200
        names = {e.get("name", "") for e in json.loads(got["r"].content)["traceEvents"]}
        assert any(n.startswith("search_dispatch[") for n in names), sorted(names)[:20]

        assert s.stop() == 0  # durability through a restart
        s.start()
        r = post_search(u("/main/_search"), json=body)
        assert r.json()["results"][0] == {"id": 3, "score": 3}
        assert post_search(s.url("SEARCHPLANE", "/main/_search"), json=body).content == r.content
    finally:
        s.stop()

"""The port's native search-plane front (acoustid_index_tpu_torch/csrc/
aitpu_front.cc + server/native_front.py) on the CPU: the cases of
tests/test_native_front.py against the port -- wire parity with the port's
Python server, negotiation, sanitization, errors, deadlines, concurrency and
the `--search-port` process -- plus byte parity with the reference's Python
server over the same corpus, and several pumps launching at once with every
answer equal to tests/oracle.py.

The front library is built from the port's own sources with g++ at first
use; the searcher runs on the CPU (the kernels' plain versions).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import msgpack
import numpy as np
import pytest
import requests

from acoustid_index_tpu_torch.engine.model import Insert
from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
from acoustid_index_tpu_torch.multi.multi_index import MultiIndex, SearchRequestParams
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.server.app import App
from acoustid_index_tpu_torch.server.http import HttpServer
from acoustid_index_tpu_torch.server.native_front import NativeFront

from oracle import OracleSegment, oracle_search

MSGPACK_CT = "application/vnd.msgpack"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS = 300


@pytest.fixture(autouse=True)
def _sorted_tables_only(monkeypatch):
    # Every table the front's searches hand K1/K2 must suit their search.
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


def _corpus():
    return np.random.default_rng(5).integers(1, 2**32, (N_DOCS, 20), dtype=np.uint32)


def _serve(mi_cls, app_cls, http_server_cls, path, insert_cls, hashes, **kw):
    mi = mi_cls.open(path, checkpoint_age=None, **kw)
    mi.create_index("main")
    mi.update("main", [insert_cls(id=i + 1, hashes=hashes[i].tolist()) for i in range(N_DOCS)])
    app = app_cls(mi)
    srv = http_server_cls("127.0.0.1", 0, app.router, app.error_response, app.not_found)
    srv.serve_background()
    return mi, srv


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    hashes = _corpus()
    searcher = BatchingSearcher(device="cpu")
    mi, py_srv = _serve(MultiIndex, App, HttpServer, str(tmp_path_factory.mktemp("nf")), Insert, hashes,
                        searcher=searcher)
    front = NativeFront(mi, 0, pumps=2)
    front.start()
    mi.search("main", SearchRequestParams(query=hashes[0].tolist(), timeout=0))
    yield {
        "mi": mi,
        "hashes": hashes,
        "py": f"http://127.0.0.1:{py_srv.port}",
        "native": f"http://127.0.0.1:{front.port}",
        "front": front,
    }
    front.stop()
    py_srv.shutdown()
    py_srv.server_close()
    mi.close()
    searcher.close()


def _search_until_ready(url, retry_s=120.0, **kwargs):
    deadline = time.time() + retry_s
    while True:
        r = requests.post(url, **kwargs)
        if r.status_code == 503 and time.time() < deadline:
            time.sleep(0.05)
            continue
        return r


def test_json_byte_parity(stack):
    q = [int(x) for x in stack["hashes"][3]] + [7, 7]  # dups exercise dedup
    body = {"query": q, "limit": 5}
    a = _search_until_ready(stack["native"] + "/main/_search", json=body)
    b = _search_until_ready(stack["py"] + "/main/_search", json=body)
    assert a.status_code == b.status_code == 200
    assert a.headers["Content-Type"] == b.headers["Content-Type"] == "application/json"
    assert a.content == b.content  # byte-for-byte, incl. separators
    assert a.json()["results"][0] == {"id": 4, "score": 20}


def test_msgpack_byte_parity(stack):
    q = [int(x) for x in stack["hashes"][10]]
    raw = msgpack.packb({"q": q, "l": 3})
    kwargs = dict(data=raw, headers={"Content-Type": MSGPACK_CT})
    a = _search_until_ready(stack["native"] + "/main/_search", **kwargs)
    b = _search_until_ready(stack["py"] + "/main/_search", **kwargs)
    assert a.status_code == b.status_code == 200
    assert a.headers["Content-Type"] == b.headers["Content-Type"] == MSGPACK_CT
    assert a.content == b.content
    assert msgpack.unpackb(a.content)["r"][0] == {"i": 11, "s": 20}


def test_negotiation_matrix(stack):
    q = [int(x) for x in stack["hashes"][1]]
    r = _search_until_ready(stack["native"] + "/main/_search", json={"query": q}, headers={"Accept": MSGPACK_CT})
    assert r.headers["Content-Type"] == MSGPACK_CT
    assert msgpack.unpackb(r.content)["r"][0]["i"] == 2
    r = _search_until_ready(
        stack["native"] + "/main/_search",
        data=msgpack.packb({"q": q}),
        headers={"Content-Type": MSGPACK_CT, "Accept": "application/json"},
    )
    assert r.headers["Content-Type"] == "application/json"
    assert r.json()["results"][0]["id"] == 2
    r = _search_until_ready(stack["native"] + "/main/_search", data=msgpack.packb({"q": q}))
    assert r.headers["Content-Type"] == MSGPACK_CT


def test_error_parity(stack):
    jct = {"Content-Type": "application/json"}
    cases = [
        ("/nosuch/_search", dict(json={"query": [1, 2, 3]})),
        ("/main/_search", dict(json={"limit": 5})),
        ("/main/_search", dict(json={"query": "nope"})),
        ("/main/_search", dict(json={"query": [1, -2]})),
        ("/main/_search", dict(json={"query": [1, 2 ** 40]})),
        ("/main/_search", dict(json={"query": [1, True]})),
        ("/main/_search", dict(json={"query": [1], "limit": "x"})),
        ("/main/_search", dict(data=b"{", headers=jct)),
        ("/main/_search", dict(data=b'{"query": [-]}', headers=jct)),
        ("/main/_search", dict(data=b'{"query": [-, 1]}', headers=jct)),
        ("/main/_search", dict(data=b'{"query": [1]} junk', headers=jct)),
        ("/main/_search", dict(data=b'{"query": [1]}]', headers=jct)),
        ("/main/_search", dict(data=b'{"query": [01]}', headers=jct)),
        ("/main/_search", dict(data=b'{"query": [1], "limit": 1e}', headers=jct)),
        ("/main/_search", dict(data=b'{"query": [1.]}', headers=jct)),
        ("/main/_search", dict(data=msgpack.packb({"q": [1]}) + b"x", headers={"Content-Type": MSGPACK_CT})),
        ("/main/_search", dict(json={"query": [1, 2, 3], "timeout": -1})),
        ("/main/_search", dict(data=b"\xc1", headers={"Content-Type": MSGPACK_CT})),
        ("/main/_search", dict(data=b"x", headers={"Content-Type": "text/plain"})),
    ]
    for path, kwargs in cases:
        a = requests.post(stack["native"] + path, **kwargs)
        b = requests.post(stack["py"] + path, **kwargs)
        assert a.status_code == b.status_code, (path, kwargs, a.status_code, b.status_code, a.content)
        assert a.content == b.content, (path, kwargs, a.content, b.content)


def test_empty_query_and_defaults(stack):
    r = requests.post(stack["native"] + "/main/_search", json={"query": []})
    assert r.status_code == 200 and r.json() == {"results": []}
    noise = [int(x) for x in np.arange(10_000_001, 10_000_040, dtype=np.uint32)]
    q = noise + [int(stack["hashes"][0][0])]
    a = _search_until_ready(stack["native"] + "/main/_search", json={"query": q})
    b = _search_until_ready(stack["py"] + "/main/_search", json={"query": q})
    assert a.content == b.content


def test_health_and_keepalive(stack):
    s = requests.Session()
    assert s.get(stack["native"] + "/_health").text == "OK\n"
    q = [int(x) for x in stack["hashes"][7]]
    for _ in range(3):
        r = s.post(stack["native"] + "/main/_search", json={"query": q})
        assert r.status_code == 200 and r.json()["results"][0]["id"] == 8
    s.close()


def test_deadline_expired(stack):
    q = [int(x) for x in stack["hashes"][2]]
    saw_timeout = False
    for _ in range(20):
        r = requests.post(stack["native"] + "/main/_search", json={"query": q, "timeout": 1})
        assert r.status_code in (200, 503)
        if r.status_code == 503:
            assert r.json() == {"error": "SearchTimeout"}
            saw_timeout = True
    assert saw_timeout


def test_concurrent_load(stack):
    hashes = stack["hashes"]
    errors = []
    hits = [0]
    responded0 = stack["front"].stat(1)

    def worker(tid):
        try:
            s = requests.Session()
            for i in range(25):
                t = (tid * 25 + i) % N_DOCS
                r = s.post(
                    stack["native"] + "/main/_search",
                    json={"query": [int(x) for x in hashes[t]], "timeout": 10000},
                )
                assert r.status_code == 200, r.content
                res = r.json()["results"]
                assert res[0]["id"] == t + 1 and res[0]["score"] == 20
                hits[0] += 1
            s.close()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:2]
    assert hits[0] == 200
    assert stack["front"].stat(1) - responded0 >= 200  # responded counter moved


def test_raw_socket_pipeline_and_close(stack):
    port = int(stack["native"].rsplit(":", 1)[1])
    body = json.dumps({"query": [int(x) for x in stack["hashes"][9]]}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(
            b"POST /main/_search HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\nConnection: close\r\n"
            b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
        )
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, payload = data.partition(b"\r\n\r\n")
    assert b"200 OK" in head.split(b"\r\n", 1)[0]
    assert b"Connection: close" in head
    assert json.loads(payload)["results"][0]["id"] == 10


def _queries(hashes, n, seed):
    """Target-doc queries with noise, limits and score floors that vary."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        t = int(rng.integers(0, N_DOCS))
        q = np.unique(np.concatenate([hashes[t, : int(rng.integers(4, 20))], rng.integers(0, 2**32, 30, dtype=np.uint32)]))
        out.append({"query": q.tolist(), "limit": int(rng.integers(1, 12)), "min_score": int(rng.integers(1, 4)),
                    "timeout": 30_000})
    return out


def test_native_front_matches_reference_python_server(stack, tmp_path):
    """The same corpus written into the reference's MultiIndex, served by
    the reference's Python HTTP server: every body the port's native front
    returns is byte-equal to the reference's."""
    from acoustid_index_tpu.engine.model import Insert as RefInsert
    from acoustid_index_tpu.multi.multi_index import MultiIndex as RefMultiIndex
    from acoustid_index_tpu.server.app import App as RefApp
    from acoustid_index_tpu.server.http import HttpServer as RefHttpServer

    ref_mi, ref_srv = _serve(RefMultiIndex, RefApp, RefHttpServer, str(tmp_path / "ref"), RefInsert, stack["hashes"])
    try:
        ref = f"http://127.0.0.1:{ref_srv.port}"
        bodies = _queries(stack["hashes"], 12, seed=1) + [{"query": []}, {"query": [1, -2]}]
        for body in bodies:
            a = _search_until_ready(stack["native"] + "/main/_search", json=body)
            b = _search_until_ready(ref + "/main/_search", json=body)
            assert (a.status_code, a.content) == (b.status_code, b.content), body
        raw = msgpack.packb({"q": [int(x) for x in stack["hashes"][42]], "l": 4})
        kwargs = dict(data=raw, headers={"Content-Type": MSGPACK_CT})
        a = _search_until_ready(stack["native"] + "/main/_search", **kwargs)
        b = _search_until_ready(ref + "/main/_search", **kwargs)
        assert a.content == b.content and msgpack.unpackb(a.content)["r"][0] == {"i": 43, "s": 20}
    finally:
        ref_srv.shutdown()
        ref_srv.server_close()
        ref_mi.close()


def test_concurrent_pumps_match_oracle(tmp_path):
    """Four pumps (the reference's default) claim and launch batches at
    once against one searcher; every answer equals tests/oracle.py."""
    hashes = _corpus()
    searcher = BatchingSearcher(device="cpu")
    mi, srv = _serve(MultiIndex, App, HttpServer, str(tmp_path), Insert, hashes, searcher=searcher)
    front = NativeFront(mi, 0, pumps=4)
    front.start()
    try:
        items = [(int(h), i + 1) for i in range(N_DOCS) for h in hashes[i]]
        segments = [OracleSegment(items, {i + 1: True for i in range(N_DOCS)})]
        bodies = _queries(hashes, 320, seed=2)
        got = [None] * len(bodies)
        errors = []

        def worker(k):
            s = requests.Session()
            try:
                for i in range(k, len(bodies), 16):
                    r = s.post(f"http://127.0.0.1:{front.port}/main/_search", json=bodies[i], timeout=60)
                    got[i] = (r.status_code, r.json())
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
            finally:
                s.close()

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not errors, errors[:2]
        for body, (status, resp) in zip(bodies, got):
            assert status == 200, resp
            want = oracle_search(segments, body["query"], limit=body["limit"], min_score=body["min_score"], pct=10)
            assert [(r["id"], r["score"]) for r in resp["results"]] == want
        assert front.stat(1) >= len(bodies)
    finally:
        front.stop()
        srv.shutdown()
        srv.server_close()
        mi.close()
        searcher.close()


class _PortServer:
    """`python -m acoustid_index_tpu_torch.main --search-port -1` on the CPU
    in a subprocess, restartable against one data directory."""

    def __init__(self, data_dir):
        self.data_dir = str(data_dir)
        self.proc = None

    def start(self):
        env = dict(os.environ, PYTHONPATH=REPO, AITPU_TORCH_DEVICE="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "acoustid_index_tpu_torch.main", "--dir", self.data_dir, "--port", "0",
             "--search-port", "-1", "--checkpoint-age-ms", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO,
        )
        self.port = self.search_port = None
        deadline = time.time() + 120
        while self.search_port is None and time.time() < deadline:
            line = self.proc.stdout.readline()
            if line.startswith("LISTENING"):
                self.port = int(line.split()[1])
            elif line.startswith("SEARCHPLANE"):
                self.search_port = int(line.split()[1])
            elif not line and self.proc.poll() is not None:
                raise RuntimeError("server died on startup")
        assert self.port and self.search_port, "server did not announce both ports"

    def stop(self, sig=signal.SIGTERM):
        if self.proc is None:
            return None
        self.proc.send_signal(sig)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.proc = None
        return rc


def test_process_level_search_plane_and_kill9(tmp_path):
    """The deployment shape: the CLI serves the native plane beside the
    Python control plane; data written through the control plane is found
    through the native plane, survives SIGKILL and a restart, and the
    process exits 0 on SIGTERM."""
    s = _PortServer(tmp_path)
    s.start()
    try:
        base = f"http://127.0.0.1:{s.port}"
        assert requests.get(f"http://127.0.0.1:{s.search_port}/_health", timeout=10).text == "OK\n"
        assert requests.put(base + "/fp").status_code == 200
        hashes = [9 * k + 2 for k in range(1, 30)]
        assert requests.put(base + "/fp/7", json={"hashes": hashes}).status_code == 200

        def search_native():
            return _search_until_ready(f"http://127.0.0.1:{s.search_port}/fp/_search",
                                       json={"query": hashes, "timeout": 30000})

        r = search_native()
        assert r.status_code == 200 and r.json()["results"][0]["id"] == 7, r.content
        s.stop(signal.SIGKILL)  # the WAL recovery path
        s.start()
        r = search_native()
        assert r.status_code == 200 and r.json()["results"][0]["id"] == 7, r.content
        assert s.stop() == 0
    finally:
        s.stop(signal.SIGKILL)


def test_launch_and_branch_counters_are_exact_under_concurrent_pumps():
    """Pumps launch from several threads at once: the kernels' launch
    counts and the search program's branch counts lose no update."""
    from acoustid_index_tpu_torch.ops import block_lookup as bl
    from acoustid_index_tpu_torch.ops import search_kernel as sk

    threads_n, per_thread = 16, 2000
    launches0, stats0 = dict(bl.LAUNCHES), dict(sk.STATS)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def pump():
            for _ in range(per_thread):
                bl._launched(0, "block_count_emit")
                sk._count("direct")

        threads = [threading.Thread(target=pump) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert bl.LAUNCHES["block_count_emit"] - launches0["block_count_emit"] == threads_n * per_thread
    assert sk.STATS["direct"] - stats0["direct"] == threads_n * per_thread

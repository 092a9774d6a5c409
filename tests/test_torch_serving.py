"""The port's serving stack: HTTP answers equal the reference server's, and
acknowledged writes survive a close and reopen; the package never imports
jax; the CLI entry serves and refuses the flags it has not ported.

Both servers run in this process on the CPU (AITPU_TORCH_DEVICE=cpu for the
port), each behind its own package's HttpServer on port 0.
"""

import os
import signal
import subprocess
import sys
import time

import msgpack
import numpy as np
import pytest
import requests
import torch

from acoustid_index_tpu.server import http as ref_http
from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
from acoustid_index_tpu_torch.ops import block_lookup as port_bl
from acoustid_index_tpu_torch.server import http as port_http

from server_fixture import post_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    # The reference kernels run in interpret mode here; results do not
    # depend on their lookups per grid step, and small steps keep it fast.
    for k in ("AITPU_LOOKUP_G", "AITPU_EMIT_G", "AITPU_RESIDENT_G", "AITPU_WAVE_G"):
        monkeypatch.setenv(k, "8")
    # Every table the served searches hand K1/K2 must suit their search.
    monkeypatch.setattr(port_bl, "CHECK_SORTED", True)


class _Node:
    """One MultiIndex + App behind its package's HttpServer on port 0."""

    def __init__(self, mi_cls, app_cls, path, http=port_http, **kw):
        self.mi = mi_cls.open(path, checkpoint_age=None, sync=False, **kw)
        app = app_cls(self.mi)
        self.server = http.HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
        self.server.serve_background()
        self.base = f"http://127.0.0.1:{self.server.port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.mi.close()


def _docs(n=40, seed=5):
    rng = np.random.default_rng(seed)
    return {i: [int(h) for h in rng.integers(0, 300, 12)] for i in range(1, n + 1)}


def _searches(docs):
    qs = [docs[i][:8] + [1000 + i] for i in (1, 3, 7, 20, 39)]
    return qs + [[5, 6, 7], docs[2] + docs[4]]


def _ask(base, queries, ct="json"):
    out = []
    for q in queries:
        body = {"query": q, "limit": 10, "min_score": 2, "timeout": 10_000}
        if ct == "json":
            r = post_search(f"{base}/main/_search", json=body)
            out.append((r.status_code, r.json()))
        else:
            r = post_search(
                f"{base}/main/_search",
                data=msgpack.packb({"q": q, "l": 10, "t": 10_000}),
                headers={"Content-Type": "application/vnd.msgpack"},
            )
            out.append((r.status_code, msgpack.unpackb(r.content)))
    return out


def _write(base, docs):
    """Index lifecycle + writes through every write route; returns the
    responses (the reference's must match them)."""
    out = [requests.put(f"{base}/main").json()]
    for i in range(1, 31):
        out.append(requests.put(f"{base}/main/{i}", json={"hashes": docs[i]}).json())
    changes = [{"insert": {"id": i, "hashes": docs[i]}} for i in range(31, 41)]
    changes += [{"delete": {"id": 5}}, {"insert": {"id": 7, "hashes": docs[8][:6]}}]
    out.append(requests.post(f"{base}/main/_update", json={"changes": changes}).json())
    out.append(requests.delete(f"{base}/main/3").json())
    out.append(requests.get(f"{base}/main/3").status_code)
    out.append(requests.head(f"{base}/main/4").status_code)
    return out


def test_http_answers_match_reference_and_survive_reopen(tmp_path):
    from acoustid_index_tpu.multi.multi_index import MultiIndex as RefMultiIndex
    from acoustid_index_tpu.server.app import App as RefApp
    from acoustid_index_tpu_torch.multi.multi_index import MultiIndex
    from acoustid_index_tpu_torch.server.app import App

    docs = _docs()
    queries = _searches(docs)
    searcher = BatchingSearcher(device="cpu")
    ref_node = _Node(RefMultiIndex, RefApp, str(tmp_path / "ref"), http=ref_http)
    node = _Node(MultiIndex, App, str(tmp_path / "port"), searcher=searcher)
    try:
        assert _write(node.base, docs) == _write(ref_node.base, docs)
        want = _ask(ref_node.base, queries)
        want_mp = _ask(ref_node.base, queries[:2], ct="msgpack")
        got = _ask(node.base, queries)
        assert got == want
        assert _ask(node.base, queries[:2], ct="msgpack") == want_mp
        assert all(status == 200 for status, _ in got)
        ids = [[r["id"] for r in body["results"]] for _, body in got]
        assert 1 in ids[0] and 3 not in ids[1] and 20 in ids[3] and 39 in ids[4]

        # Half the writes to a file segment, then more writes in the WAL.
        ref = node.mi._get_ref("main")
        try:
            ref.index.checkpoint(force=True)
        finally:
            node.mi._release_ref(ref)
        requests.delete(f"{node.base}/main/20")
        requests.delete(f"{ref_node.base}/main/20")
        want = _ask(ref_node.base, queries)
        assert _ask(node.base, queries) == want
    finally:
        node.close()
        ref_node.close()

    # Reopen from disk: every acknowledged write reads back.
    node = _Node(MultiIndex, App, str(tmp_path / "port"), searcher=searcher)
    try:
        assert _ask(node.base, queries) == want
        assert requests.get(f"{node.base}/main/20").status_code == 404
        assert requests.head(f"{node.base}/main/21").status_code == 200
    finally:
        node.close()
        searcher.close()


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import acoustid_index_tpu_torch, acoustid_index_tpu_torch.main\n"
        "import acoustid_index_tpu_torch.engine.index, acoustid_index_tpu_torch.multi.multi_index\n"
        "import acoustid_index_tpu_torch.server.app, acoustid_index_tpu_torch.ops.search_kernel\n"
        "import acoustid_index_tpu_torch.measure\n"
        "import acoustid_index_tpu_torch.parallel.serving, acoustid_index_tpu_torch.entry\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
        "print('OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr


@pytest.mark.parametrize("flag", ["--mesh-shards=-2", "--profile-port=-9"])
def test_main_refuses_unported_flags(flag, capsys):
    # Every flag of the reference is ported now: main() refuses only bad
    # values of the two flags it refused before, and none as unported.
    from acoustid_index_tpu_torch.main import main

    with pytest.raises(SystemExit) as exc:
        main([flag, "--dir", "unused"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "must be" in err and "not yet ported" not in err


def test_device_default_is_cuda(monkeypatch):
    from acoustid_index_tpu_torch.utils.device import device

    monkeypatch.delenv("AITPU_TORCH_DEVICE")
    if torch.cuda.is_available():
        assert device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            device()
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    assert device().type == "cpu"


def test_cli_serves_put_and_search(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, AITPU_TORCH_DEVICE="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "acoustid_index_tpu_torch.main", "--dir", str(tmp_path), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        line = ""
        deadline = time.time() + 120
        while not line.startswith("LISTENING") and time.time() < deadline:
            line = proc.stdout.readline()
        assert line.startswith("LISTENING"), line
        base = f"http://127.0.0.1:{int(line.split()[1])}"
        assert requests.put(f"{base}/cli").status_code == 200
        assert requests.put(f"{base}/cli/9", json={"hashes": [1, 2, 3, 4]}).status_code == 200
        r = post_search(f"{base}/cli/_search", json={"query": [2, 3, 4, 5], "timeout": 10_000})
        assert r.status_code == 200 and r.json()["results"] == [{"id": 9, "score": 3}]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0

"""The port's profiling hooks (utils/profiling.py) on the CPU: a capture
around searches served by the BatchingSearcher writes a Chrome trace that
holds the dispatch span, as the reference's xprof trace holds it.  Runs
with AITPU_TORCH_DEVICE=cpu."""

import glob
import json

import numpy as np

from acoustid_index_tpu_torch.engine.index import Index
from acoustid_index_tpu_torch.engine.model import Insert, SearchOptions
from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
from acoustid_index_tpu_torch.utils import profiling


def test_capture_holds_the_dispatch_span(tmp_path, monkeypatch):
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(9)
    docs = {i: rng.integers(0, 2**32, 16, dtype=np.uint32).tolist() for i in range(1, 40)}
    searcher = BatchingSearcher(device="cpu")
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    try:
        idx.update([Insert(id=i, hashes=h) for i, h in docs.items()])
        with profiling.capture(str(tmp_path / "trace")):
            with profiling.trace("caller_span"):
                results, _ = idx.search(docs[7], SearchOptions(max_results=5, min_score=1))
        assert results and results[0].id == 7
    finally:
        idx.close()
        searcher.close()
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    assert "caller_span" in names
    assert "search_dispatch[1/1]" in names, sorted(n for n in names if "search" in n)


def test_profiler_server_captures_a_live_search(tmp_path, monkeypatch):
    """--profile-port's listener: GET /capture?ms=N records the live process
    (the searcher's dispatch thread included) and answers with the Chrome
    trace; a second capture meanwhile gets 409, bad requests 400 / 404."""
    import threading
    import time

    import requests

    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(10)
    docs = {i: rng.integers(0, 2**32, 16, dtype=np.uint32).tolist() for i in range(1, 40)}
    searcher = BatchingSearcher(device="cpu")
    idx = Index.open(str(tmp_path / "idx"), checkpoint_age=None, searcher=searcher)
    server = profiling.start_profiler_server(0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        idx.update([Insert(id=i, hashes=h) for i, h in docs.items()])
        assert requests.get(f"{base}/capture?ms=0", timeout=30).status_code == 400
        assert requests.get(f"{base}/trace", timeout=30).status_code == 404
        got = {}
        t = threading.Thread(target=lambda: got.update(r=requests.get(f"{base}/capture?ms=2000", timeout=120)))
        t.start()
        deadline = time.monotonic() + 60
        while not server.capturing.locked() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert requests.get(f"{base}/capture?ms=10", timeout=30).status_code == 409
        # Search until the capture returns: the profiler's start takes part
        # of the window.
        while t.is_alive():
            results, _ = idx.search(docs[3], SearchOptions(max_results=5, min_score=1))
            assert results and results[0].id == 3
            time.sleep(0.05)
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        server.shutdown()
        idx.close()
        searcher.close()
    assert got["r"].status_code == 200 and got["r"].headers["Content-Type"] == "application/json"
    names = {e.get("name", "") for e in json.loads(got["r"].content)["traceEvents"]}
    assert "search_dispatch[1/1]" in names, sorted(n for n in names if "search" in n)

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

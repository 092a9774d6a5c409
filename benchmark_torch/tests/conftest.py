"""CPU tests of the benchmark at small sizes: `python -m pytest benchmark_torch/tests`
from the repository's root.  The program runs on the CPU here
(AITPU_TORCH_DEVICE=cpu, its kernels' plain versions)."""

import copy
import os
import sys

import pytest

HERE_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE_PKG)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("AITPU_TORCH_DEVICE", "cpu")


def small(cell, docs: int = 20_000, doc_bits: int = 14):
    """The cell at a size a test run holds: the corpus, the pool, the load
    and, with writes, the written window cut down; shapes unchanged."""
    c = copy.deepcopy(cell)
    if c.config["corpus"]["kind"] == "uniform":
        c.config["corpus"]["docs"] = docs
    else:
        c.config["corpus"]["doc_bits"] = doc_bits
    c.traffic.update(pool=2048, connections=16, warmup_s=1, check_sample=256)
    if "rate" in c.traffic:
        c.traffic["rate"] = 200
    if "writes" in c.traffic:
        c.traffic["writes"].update(docs=20, window=640, period_s=0.05)
    return c


@pytest.fixture
def manifest():
    from benchmark_torch import registry

    return registry.load_manifest(ROOT)

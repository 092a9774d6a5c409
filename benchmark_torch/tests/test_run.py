"""The command refuses to run without the cards its cell asks for, and
prints no result: it never falls back to the CPU."""

import os
import shutil
import subprocess
import sys

from .conftest import HERE_PKG, ROOT


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", AITPU_TORCH_DEVICE="cpu")
    return subprocess.run([sys.executable, "benchmark_torch/run.py", "--workload", "fp10m.search", "--seed",
                           str(2**31 + 1), "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result(tmp_path):
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout == "" and "needs 1 CUDA card" in p.stderr
    # A directory with only the manifest and the benchmark's files: no result either.
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE_PKG, tmp_path / "benchmark_torch", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""

"""The command refuses to run without the cards its cell asks for, and
prints no result: it never falls back to the CPU.  Nor does a run whose
process holds JAX or the JAX package once its window has closed."""

import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from benchmark_torch import harness, registry

from .conftest import HERE_PKG, ROOT, small


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


def test_foreign_modules_compare_whole_top_level_names():
    names = ["jax", "jaxlib.xla_client", "flax.linen", "acoustid_index_tpu.native", "acoustid_index_tpu_torch.main",
             "jaxtyping", "numpy"]
    assert harness.foreign_modules(names) == ["acoustid_index_tpu", "flax", "jax", "jaxlib"]
    assert harness.foreign_modules(["acoustid_index_tpu_torch", "acoustid_index_tpu_torch.ops", "flaxen"]) == []


@pytest.mark.parametrize("name", ["jax", "acoustid_index_tpu.native"])
def test_a_run_that_loads_jax_gives_no_result(manifest, monkeypatch, name):
    """A module of JAX or of the JAX package, loaded by the served path
    inside a small run, leaves the run with no result."""
    assert harness.foreign_modules() == []

    def plant(mi, front):
        launch = front._launch_group

        def launch_and_load(*a, **k):
            if name not in sys.modules:
                monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
            return launch(*a, **k)

        front._launch_group = launch_and_load

    cell = small(registry.cell(manifest, "fp10m.search"))
    with pytest.raises(RuntimeError, match=f"holds {name.partition('.')[0]} after the window"):
        harness.run_cell(cell, 2**31 + 77, 2.0, False, time.time(), device="cpu", faults=plant)

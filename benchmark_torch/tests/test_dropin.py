"""A configuration, a traffic mix and a per-layer metric are added by
adding files and manifest entries, and the harness takes them."""

import copy
import json
import shutil
import time

from benchmark_torch import harness, registry

from .conftest import HERE_PKG, small

METRIC = '''"""Made up for the test: batches per second of the window."""

UNIT = "batches/s"
LAYER = "search program: ops/search_kernel.py"
MOVES = "search_qps"
SOURCE = "program_counter"
WORKLOADS = ["tiny.burst"]


def read(ctx):
    return ctx["batches"] / ctx["window_s"] if ctx.get("batches") else None
'''


def test_new_files_are_found_and_run(tmp_path, manifest):
    base = tmp_path / "benchmark_torch"
    for d in ("configs", "traffic", "metrics", "kernels"):
        shutil.copytree(f"{HERE_PKG}/{d}", base / d)
    cfg = json.loads((base / "configs" / "fp10m.json").read_text())
    cfg.update(name="tiny", corpus={"kind": "uniform", "docs": 5000, "hashes_per_doc": 24})
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (base / "traffic" / "burst.json").write_text(json.dumps(
        {"name": "burst", "loop": "closed", "connections": 8, "pool": 512, "timeout_ms": 10000,
         "warmup_s": 1, "check_sample": 128}))
    (base / "metrics" / "program.batches_per_s.tiny.py").write_text(METRIC)
    (base / "kernels" / "range" / "new_range_kernel.txt").write_text("new_range_kernel\n")

    m = copy.deepcopy(manifest)
    m["configs"].append({"name": "tiny", "source": "made up", "file": "benchmark_torch/configs/tiny.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny.burst", "config": "tiny", "traffic": "burst", "chips": 1, "why": "a test"})
    m["end_to_end"][0]["workloads"].append("tiny.burst")  # search_qps
    m["per_layer"].append({"name": "program.batches_per_s.tiny", "unit": "batches/s", "better": "higher",
                           "source": "program_counter", "layer": "search program: ops/search_kernel.py",
                           "moves": "search_qps", "workloads": ["tiny.burst"]})
    assert registry.check_manifest(m, str(base)) == []
    assert "new_range_kernel" in registry.kernel_names("range", str(base))
    cell = registry.cell(m, "tiny.burst", str(base))
    assert [x["name"] for x in cell.per_layer] == ["program.batches_per_s.tiny"]
    assert cell.config["corpus"]["docs"] == 5000 and cell.traffic["connections"] == 8

    out, _ = harness.run_cell(small(cell, docs=5000), 77, 2.0, True, time.time(), device="cpu")
    assert out["correct"] and out["metrics"]["program.batches_per_s.tiny"]["value"] > 0
    out, _ = harness.run_cell(small(cell, docs=5000), 78, 2.0, False, time.time(), device="cpu")
    assert out["correct"] and set(out["metrics"]) == {"search_qps", "setup_s"}

"""BENCHMARK.json against the limits a manifest must keep."""

import json
import os
import re

from benchmark_torch import registry

from .conftest import ROOT

LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_names_units_and_references(manifest):
    assert registry.check_manifest(manifest) == []
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(registry.manifest_path(ROOT)) <= 64 * 1024
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert registry.UNIT.match(m["unit"]), m
        assert m["name"].isascii() and m["unit"].isascii()
    for w in manifest["workloads"]:
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in manifest["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark_torch/configs/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for m in manifest["per_layer"]:
        assert LINE.match(m["layer"])


def test_the_contract_shape(manifest):
    assert manifest["command"][:2] == ["python3", "benchmark_torch/run.py"] and manifest["paths"] == ["benchmark_torch"]
    assert 1 <= manifest["run_seconds"] <= 51
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(manifest["workloads"]) // 4)
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cell = registry.cell(manifest, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer, w["name"]
    for m in manifest["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%"

"""Finds everything a cell needs by the names in BENCHMARK.json.

A configuration is `configs/<name>.json`, a traffic mix `traffic/<name>.json`,
a per-layer metric `metrics/<name>.py` (its reader and the unit, layer,
end-to-end metric and cells it declares), and a kernel of the range phase
`kernels/range/<name>.txt`.  Adding a cell, a mix or a metric is adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    base: str = HERE  # where its files were found


def manifest_path(root: str) -> str:
    return os.path.join(root, "BENCHMARK.json")


def load_manifest(root: str) -> dict:
    with open(manifest_path(root)) as f:
        return json.load(f)


def _load_json(kind: str, name: str, base: str = HERE) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(os.path.join(base, kind, f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str, base: str = HERE) -> dict:
    return _load_json("configs", name, base)


def load_traffic(name: str, base: str = HERE) -> dict:
    return _load_json("traffic", name, base)


def load_metric(name: str, base: str = HERE):
    """The module of per-layer metric `name`: UNIT, LAYER, MOVES,
    WORKLOADS, SOURCE and read(ctx) -> float or None."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_torch_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_pending(manifest: dict, base: str = HERE) -> dict:
    """A copy of the manifest with the entries of every file in pending/
    added: cells that are left out of BENCHMARK.json until they read
    steadily, for the tests and sweep.py.  A metric both name reports in
    the cells of both."""
    m = copy.deepcopy(manifest)
    d = os.path.join(base, "pending")
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn)) as f:
            extra = json.load(f)
        for key in ("workloads", "end_to_end", "per_layer"):
            have = {e["name"]: e for e in m[key]}
            for e in extra[key]:
                if e["name"] in have:
                    have[e["name"]]["workloads"] = have[e["name"]]["workloads"] + e["workloads"]
                else:
                    m[key].append(e)
    return m


def kernel_names(group: str, base: str = HERE) -> List[str]:
    """The printed kernel names of `group` (kernels/<group>/*.txt, one
    name per file, sorted)."""
    d = os.path.join(base, "kernels", group)
    names = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".txt"):
            with open(os.path.join(d, fn)) as f:
                names += [line.strip() for line in f if line.strip() and not line.startswith("#")]
    return names


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, base: str = HERE) -> Cell:
    """The cell `name` of the manifest, with its configuration, traffic
    and the metrics it reports."""
    w = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name) and m["moves"] in names]
    return Cell(
        name=name,
        config=load_config(w["config"], base),
        traffic=load_traffic(w["traffic"], base),
        chips=int(w["chips"]),
        end_to_end=e2e,
        per_layer=per_layer,
        base=base,
    )


def check_manifest(manifest: dict, base: str = HERE) -> List[str]:
    """Problems with the manifest's names, units and cross references (an
    empty list when there are none); the per-layer metrics' files must
    declare what the manifest says of them."""
    out: List[str] = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in manifest.get(key, []):
            n = e.get("name", "")
            if not NAME.match(n):
                out.append(f"{key}: bad name {n!r}")
            if n in seen:
                out.append(f"{key}: {n!r} twice")
            seen.add(n)
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    if len(set(metric_names)) != len(metric_names):
        out.append("a metric name repeats across end_to_end and per_layer")
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in manifest["configs"]:
        for k in c.get("reduced", []):
            if not NAME.match(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
    for w in manifest["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w.get(k, "")):
                out.append(f"workload {w['name']}: bad {k}")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if not os.path.exists(os.path.join(base, "traffic", f"{w['traffic']}.json")):
            out.append(f"workload {w['name']}: no traffic file for {w['traffic']!r}")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m.get("unit", "")):
            out.append(f"metric {m['name']}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better must be lower or higher")
        if m.get("source") not in SOURCES:
            out.append(f"metric {m['name']}: bad source {m.get('source')!r}")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']}: moves unknown {m['moves']!r}")
            continue
        try:
            mod = load_metric(m["name"], base)
        except (OSError, SyntaxError) as exc:
            out.append(f"metric {m['name']}: no reader ({exc})")
            continue
        for attr, key in (("UNIT", "unit"), ("LAYER", "layer"), ("MOVES", "moves"), ("SOURCE", "source")):
            if getattr(mod, attr, None) != m[key]:
                out.append(f"metric {m['name']}: {attr} {getattr(mod, attr, None)!r} != manifest {m[key]!r}")
        if list(getattr(mod, "WORKLOADS", [])) != list(m.get("workloads", [])):
            out.append(f"metric {m['name']}: WORKLOADS differ from the manifest")
        for w in m.get("workloads", []):
            we = e2e[m["moves"]]
            if "workloads" in we and w not in we["workloads"]:
                out.append(f"metric {m['name']}: cell {w} does not report {m['moves']}")
    return out


def metric_values(per_layer: List[dict], ctx: dict, base: str = HERE) -> Dict[str, dict]:
    """Each per-layer metric's reading in this run; a reader that finds
    nothing to read returns None and the metric is left out."""
    out: Dict[str, dict] = {}
    for m in per_layer:
        v: Optional[float] = load_metric(m["name"], base).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out

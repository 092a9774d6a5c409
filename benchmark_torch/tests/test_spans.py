"""The per-layer metrics that read the program's span and counter
registry: a traced run on the CPU reads each of them from the untraced
stretch, and a program without the registry's window reads none."""

import time

import pytest

from benchmark_torch import harness, registry
from benchmark_torch.metrics import spans

from .conftest import small

SPAN_METRICS = ["front.queue_ms.search", "pump.host_ms_per_batch.search", "pump.offcpu_ms_per_batch.search",
                "program.sync_ms_per_batch.search", "front.complete_ms_per_batch.search"]


def test_the_manifest_names_them(manifest):
    assert registry.check_manifest(manifest) == []
    have = {m["name"]: m for m in manifest["per_layer"]}
    for name in SPAN_METRICS:
        assert have[name]["workloads"] == ["fp10m.search", "fp134m.search"] and have[name]["moves"] == "search_qps"


@pytest.mark.parametrize("workload", ["fp10m.search", "fp134m.search"])
def test_a_traced_run_reads_them(manifest, workload, monkeypatch):
    from acoustid_index_tpu_torch.utils import profiling

    # The small run's untraced stretch lasts under a second, so the ring's
    # step and the pump's CPU readings are cut with it (a step per second
    # and a reading per 16 batches, ~0.1 s, over the full run's ~17 s).
    monkeypatch.setattr(profiling.REGISTRY, "_step", 50_000_000)
    monkeypatch.setattr(profiling, "CPU_EVERY", 1)
    cell = small(registry.cell(manifest, workload))
    out, detail = harness.run_cell(cell, 2**33 + 15, 2.0, True, time.time(), device="cpu")
    assert out["correct"]
    got = out["metrics"]
    for name in SPAN_METRICS:
        assert name in got and got[name]["value"] >= 0, (name, sorted(got))
    assert got["pump.host_ms_per_batch.search"]["value"] > 0
    assert got["pump.offcpu_ms_per_batch.search"]["value"] <= got["pump.host_ms_per_batch.search"]["value"]
    # The registry's batches over the stretch are the counters' batches.
    w = profiling.window(detail["counted"]["window_s"])
    n = w["spans"]["pump.batch"]["n"]
    assert n == pytest.approx(detail["counted"]["batches"], rel=0.25, abs=3)


def test_no_window_reads_nothing(monkeypatch):
    from acoustid_index_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "window")
    ctx = {"window_s": 5.0, "batches": 10}
    assert spans.window(ctx) is None
    assert spans.ms_per_batch(ctx, "pump.batch") is None and spans.queue_ms(ctx) is None
    assert spans.window({}) is None

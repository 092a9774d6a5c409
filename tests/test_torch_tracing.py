"""The port's span and counter registry (acoustid_index_tpu_torch/utils/
profiling.py) inside the served path, on the CPU: spans that make no
profiler call with no capture running, their totals and counts after a
batch served through the native front, their names on a capture's
timeline, the registry's window, the C++ front's claim counters, /_metrics,
the `_update` path's spans, and the benchmark's span timer over a
restart."""

import glob
import json
import threading
import time

import numpy as np
import pytest
import requests
import torch

from acoustid_index_tpu_torch.engine.index import Index
from acoustid_index_tpu_torch.engine.model import Insert
from acoustid_index_tpu_torch.engine.searcher import BatchingSearcher
from acoustid_index_tpu_torch.multi.multi_index import MultiIndex
from acoustid_index_tpu_torch.server import metrics
from acoustid_index_tpu_torch.server.app import App
from acoustid_index_tpu_torch.server.http import HttpServer
from acoustid_index_tpu_torch.server.native_front import NativeFront
from acoustid_index_tpu_torch.utils import profiling

N_DOCS = 64
PUMP = ["pump.batch", "pump.pack", "pump.inflight_wait", "pump.launch", "pump.enqueue"]
PROGRAM = ["program.range", "program.branch", "program.gather", "program.rank", "program.mention",
           "program.select"]
COLLECT = ["collect.fetch", "collect.complete"]
UPDATE = ["update.lock_wait", "update.lock_hold", "update.memseg", "update.oplog_append", "update.memory_insert"]


def _hashes():
    return np.random.default_rng(15).integers(1, 2**32, (N_DOCS, 20), dtype=np.uint32)


@pytest.fixture
def served(tmp_path, monkeypatch):
    """A MultiIndex of N_DOCS docs on the CPU behind the Python server and
    the native front (one pump)."""
    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    hashes = _hashes()
    searcher = BatchingSearcher(device="cpu")
    mi = MultiIndex.open(str(tmp_path / "mi"), checkpoint_age=None, searcher=searcher)
    mi.create_index("main")
    mi.update("main", [Insert(id=i + 1, hashes=hashes[i].tolist()) for i in range(N_DOCS)])
    app = App(mi)
    srv = HttpServer("127.0.0.1", 0, app.router, app.error_response, app.not_found)
    srv.serve_background()
    front = NativeFront(mi, 0, pumps=1)
    front.start()
    try:
        yield {"mi": mi, "hashes": hashes, "front": front,
               "py": f"http://127.0.0.1:{srv.port}", "native": f"http://127.0.0.1:{front.port}"}
    finally:
        front.stop()
        srv.shutdown()
        srv.server_close()
        mi.close()
        searcher.close()


def _search(served, i):
    r = requests.post(f"{served['native']}/main/_search",
                      json={"query": served["hashes"][i].tolist(), "timeout": 0}, timeout=60)
    assert r.status_code == 200, r.text
    assert r.json()["results"][0]["id"] == i + 1
    return r


def _spans_delta(a, b):
    return {k: tuple(y - x for x, y in zip(a["spans"].get(k, (0, 0, 0)), v)) for k, v in b["spans"].items()}


def _settle(front, batches):
    """Wait until the front answered `batches` claims' collectors (the
    client's answer can come before the collector's span closes)."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        t = profiling.totals()["spans"]
        if t.get("collect.complete", (0, 0))[1] >= batches:
            return
        time.sleep(0.01)


def test_no_capture_makes_no_profiler_call(served, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no capture running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = profiling.totals()
    for i in range(3):
        _search(served, i)
    _settle(served["front"], before["spans"].get("collect.complete", (0, 0))[1] + 3)
    d = _spans_delta(before, profiling.totals())
    assert d["pump.batch"][1] == 3 and d["program.range"][1] == 3


def test_span_totals_after_a_served_batch(served):
    before = profiling.totals()
    _search(served, 5)
    _settle(served["front"], before["spans"].get("collect.complete", (0, 0))[1] + 1)
    after = profiling.totals()
    d = _spans_delta(before, after)
    for name in PUMP + PROGRAM + COLLECT:
        assert d[name][1] == 1, (name, d[name])
        assert d[name][0] > 0, name
    assert d["pump.claim"][1] >= 1
    assert d["program.sync"][1] == 2  # the branch predicates and the mention gate
    assert all(d[n][2] == 0 for n in PROGRAM + COLLECT)  # only pump.batch takes CPU time
    # The batch's stages lie inside its launch, the launch inside the batch.
    assert sum(d[n][0] for n in PROGRAM) <= d["pump.launch"][0] <= d["pump.batch"][0]
    c0, c1 = before["counters"], after["counters"]
    assert c1["search.host_syncs"] - c0["search.host_syncs"] == 2
    assert sum(c1[f"search.{k}"] - c0[f"search.{k}"] for k in ("direct", "matrix", "sort")) == 1


def test_pump_batch_totals_the_pump_threads_cpu_time(served):
    """pump.batch reads the pump thread's CPU clock on one batch in
    CPU_EVERY and counts there all of the thread's CPU time since the
    previous reading: within the wall time of the pump's spans."""
    before = profiling.totals()
    n = profiling.CPU_EVERY + 1
    for i in range(n):
        _search(served, i)
    _settle(served["front"], before["spans"].get("collect.complete", (0, 0))[1] + n)
    d = _spans_delta(before, profiling.totals())
    wall, count, cpu = d["pump.batch"]
    assert count == n
    tick = 10_000_000  # some hosts' thread CPU clock ticks in 10 ms steps
    assert 0 < cpu <= wall + d["pump.claim"][0] + tick, (cpu, wall, d["pump.claim"])


def test_capture_timeline_holds_the_served_path(served, tmp_path):
    with profiling.capture(str(tmp_path / "trace")):
        assert profiling.REGISTRY.capturing
        for i in range(4):
            _search(served, i)
        _settle(served["front"], profiling.totals()["spans"]["collect.complete"][1])
    assert not profiling.REGISTRY.capturing
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    for name in PUMP + PROGRAM + COLLECT + ["pump.claim", "program.sync"]:
        assert name in names, (name, sorted(n for n in names if "." in n and "::" not in n))


def test_window_equals_the_totals_over_a_stretch():
    reg = profiling.Registry(step_ns=20_000_000)
    assert reg.window(1.0) is None  # no capture yet
    mark = None
    t_start = time.perf_counter_ns()
    while time.perf_counter_ns() - t_start < 600_000_000:
        t = time.perf_counter_ns()
        reg.add("s", 1000, 10, t)
        if mark is None and t - t_start >= 200_000_000:
            mark = (t, reg.totals())
        time.sleep(0.0005)
    reg.capture_started()
    end = reg.last_capture["start"]
    t_mark, at_mark = mark
    w = reg.window((reg.last_capture["start_ns"] - t_mark) / 1e9)
    want = end["spans"]["s"][1] - at_mark["spans"]["s"][1]
    per_step = want / ((reg.last_capture["start_ns"] - t_mark) / 20_000_000)
    assert abs(w["spans"]["s"]["n"] - want) <= per_step + 1, (w, want)
    assert w["spans"]["s"]["s"] == pytest.approx(w["spans"]["s"]["n"] * 1e-6)
    assert w["seconds"] == pytest.approx((reg.last_capture["start_ns"] - t_mark) / 1e9)
    reg.capture_stopped()
    assert reg.last_capture["stop"]["spans"]["s"][1] == end["spans"]["s"][1]


def test_concurrent_spans_and_bumps_lose_nothing():
    """More threads than cores span, bump and end while a reader sums the
    totals and snapshots; with a short switch interval, any lost update
    would show in the final counts."""
    import sys

    reg = profiling.Registry(step_ns=1_000_000)
    d = reg.counters("stress", {"k": 0})
    n_threads, n_each = 24, 400
    stop = threading.Event()
    errors = []

    def work():
        for i in range(n_each):
            reg.add("t", 5, 1, time.perf_counter_ns())
            reg.bump(d, "k")

    def read():
        while not stop.is_set():
            try:
                reg.totals()
            except Exception as exc:  # noqa: BLE001 -- reported below
                errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not reader.is_alive()
    assert not errors, errors
    n = n_threads * n_each
    assert reg.totals()["spans"]["t"] == (5 * n, n, n)
    assert reg.totals()["spans"]["t"] == (5 * n, n, n)  # dead threads folded once, not twice
    assert reg.totals()["counters"]["stress.k"] == n == d["k"]


def test_queue_wait_bins_match_the_front_source():
    import os
    import re

    src = open(os.path.join(os.path.dirname(profiling.__file__), "..", "csrc", "aitpu_front.cc")).read()
    ms = re.search(r"QUEUE_WAIT_BUCKETS_MS\[\] = \{([^}]*)\}", src).group(1)
    assert [int(x) / 1e3 for x in ms.split(",")] == list(metrics.FRONT_QUEUE_WAIT_BUCKETS)
    assert f"QUEUE_WAIT_BINS = {len(metrics.FRONT_QUEUE_WAIT_BUCKETS) + 1};" in src


def test_front_claim_counters_move(served):
    front = served["front"]
    names = ["front.batches", "front.queue_wait_ns", "front.queue_waits"]
    before = front.claim_counters()
    reg_before = profiling.totals()["counters"]
    n = 12
    threads = [threading.Thread(target=_search, args=(served, i)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    after = front.claim_counters()
    d = {k: after[k] - before[k] for k in after}
    assert 1 <= d["front.batches"] <= n
    assert d["front.queue_waits"] == n and d["front.queue_wait_ns"] > 0
    bins = [d[f"front.queue_wait_bin.{b}"] for b in range(len(metrics.FRONT_QUEUE_WAIT_BUCKETS) + 1)]
    assert sum(bins) == n and min(bins) >= 0
    assert after["front.batches"] == front.stat(6) and after["front.queue_waits"] == front.stat(8)
    reg_after = profiling.totals()["counters"]
    for k in names:
        assert reg_after[k] - reg_before[k] == d[k]
    assert front.stat(1) >= n  # indexes 0-5 keep their meaning
    assert front.stat(5) == front.port


def test_metrics_export_the_registry_after_the_old_series(served, monkeypatch):
    metrics.reset()
    metrics.inc_memory_merges()
    metrics.inc_searches("main", 3)
    metrics.observe_search_seconds("main", 0.002)
    _search(served, 1)
    _settle(served["front"], profiling.totals()["spans"]["collect.complete"][1])
    text = requests.get(f"{served['py']}/_metrics", timeout=30).text
    new = text[text.index("# TYPE aitpu_span_seconds_total"):]
    old = text[: len(text) - len(new)]
    monkeypatch.setattr(metrics, "_render_registry", lambda out: None)
    assert metrics.render() == old  # every earlier series byte for byte, before the new ones
    assert "aitpu_memory_merges_total 1\n" in old
    for line in old.splitlines():
        assert "span" not in line and "front_" not in line and "program_counter" not in line
    lines = new.splitlines()
    assert any(ln.startswith('aitpu_span_seconds_total{span="pump.batch"} ') for ln in lines)
    assert any(ln.startswith('aitpu_span_count_total{span="collect.complete"} ') for ln in lines)
    assert any(ln.startswith('aitpu_span_cpu_seconds_total{span="pump.batch"} ') for ln in lines)
    assert any(ln.startswith('aitpu_program_counter_total{counter="search.host_syncs"} ') for ln in lines)
    assert any(ln.startswith("aitpu_front_batches_total ") for ln in lines)
    buckets = [int(ln.split()[-1]) for ln in lines if ln.startswith("aitpu_front_queue_wait_seconds_bucket")]
    count = int(next(ln for ln in lines if ln.startswith("aitpu_front_queue_wait_seconds_count")).split()[-1])
    assert len(buckets) == len(metrics.FRONT_QUEUE_WAIT_BUCKETS) + 1
    assert buckets == sorted(buckets) and buckets[-1] == count >= 1


def test_update_spans(served):
    before = profiling.totals()
    r = requests.post(f"{served['py']}/main/_update",
                      json={"changes": [{"insert": {"id": 1000, "hashes": [1, 2, 3]}}]}, timeout=60)
    assert r.status_code == 200, r.text
    d = _spans_delta(before, profiling.totals())
    for name in UPDATE + ["update.decode"]:
        assert d[name][1] == 1 and d[name][0] > 0, name
    assert d["update.oplog_append"][0] + d["update.memseg"][0] <= d["update.lock_hold"][0]


def test_span_timer_times_a_restart(tmp_path, monkeypatch):
    from benchmark_torch import tracing

    monkeypatch.setenv("AITPU_TORCH_DEVICE", "cpu")
    hashes = _hashes()
    path = str(tmp_path / "idx")
    idx = Index.open(path, checkpoint_age=None)
    idx.update([Insert(id=i + 1, hashes=hashes[i].tolist()) for i in range(N_DOCS)])
    assert idx.checkpoint(force=True)
    idx.close()
    orig = profiling.trace
    timer = tracing.SpanTimer()
    timer.install()
    try:
        idx = Index.open(path, checkpoint_age=None)
    finally:
        timer.uninstall()
    try:
        assert profiling.trace is orig
        for name in ("open.read", "open.pack", "tier.upload"):
            assert timer.count[name] >= 1 and timer.seconds[name] >= 0, (name, dict(timer.count))
    finally:
        idx.close()

"""A traced run pauses its load around the profiler's start and stop.

The load generator alone, against a stub server: nothing is sent between a
pause and its resume, and latencies timed from due leave the pause out.
Whole traced runs on the CPU, with a stand-in for the program's capture
whose entry and exit hold the served path past the searches' timeout, as
the profiler's start and stop do on a card: sound runs are correct, an
answer altered in the captured slice is still caught, and a cell with
writes reads every acknowledged write back."""

import contextlib
import json
import os
import socketserver
import threading
import time

import numpy as np
import pytest

from benchmark_torch import harness, loadgen, registry, traffic

from .conftest import small
from .test_faults import _patch_complete

HOLD_S = 3.0  # each hold of the served path: the stand-in profiler's start, and its stop
TIMEOUT_MS = 2000  # the searches' timeout in these runs, under HOLD_S
SECONDS = 12.0


class _Stub(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.arrivals = []  # CLOCK_MONOTONIC time of each whole request
        self.lock = threading.Lock()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            head = b""
            while not head.endswith(b"\r\n\r\n"):
                c = self.rfile.read(1)
                if not c:
                    return
                head += c
            n = 0
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    n = int(line.split(b":")[1])
            self.rfile.read(n)
            with self.server.lock:
                self.server.arrivals.append(time.monotonic())
            self.wfile.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")


@pytest.fixture
def stub():
    s = _Stub()
    t = threading.Thread(target=s.serve_forever, daemon=True)
    t.start()
    try:
        yield s
    finally:
        s.shutdown()
        s.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("mode,kw", [
    ("closed", {"conns": 4}),
    ("open", {"conns": 8, "rate": 200.0}),
    ("writer", {"conns": 1, "period": 0.02}),
])
def test_nothing_is_sent_while_paused(stub, tmp_path, mode, kw):
    exe = loadgen.build()
    req = b"POST /x HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Length: 0\r\n\r\n"
    requests = traffic.frame(np.frombuffer(req * 200, np.uint8).reshape(200, len(req)))
    start_at = time.monotonic() + 0.3
    run = loadgen.Run(exe, mode, stub.server_address[1], requests, str(tmp_path / "rec"), 7, seconds=3.0,
                      start_at=start_at, control=True, **kw)
    try:
        time.sleep(max(start_at + 0.8 - time.monotonic(), 0.0))
        run.pause()
        drained = run.drained(10.0)
        time.sleep(1.0)
        run.resume()
        res = run.wait()
    finally:
        run.kill()
    s = res.summary
    (p,) = s["pauses"]
    assert drained is not None and p["drained"] == pytest.approx(drained, abs=1e-5)
    assert p["pause"] <= p["drained"] < p["resume"] and p["resume"] - p["drained"] >= 0.95
    assert p["sent"] == 0 and p["admitted"] == 0
    assert s["paused_s"] == pytest.approx(p["resume"] - p["pause"], abs=1e-5)
    # The server saw no request between the drain and the resume, and some after.
    with stub.lock:
        arrivals = list(stub.arrivals)
    assert not [t for t in arrivals if p["drained"] < t < p["resume"]]
    assert [t for t in arrivals if t > p["resume"]]
    assert s["non200"] == s["unanswered"] == s["inconsistent"] == 0 and s["sent"] > 0
    # Timed from due (open, writer) or from the send (closed): the second
    # the load stood still is in no latency.
    assert np.isfinite(res.latencies).all() and res.latencies.max() < 0.5
    if mode == "writer":  # the schedule moved on by the pause: the last second's writes fall past the window
        assert s["sent"] == pytest.approx((3.0 - s["paused_s"]) / 0.02, abs=3)


class _Hold:
    """Holds the served path while `hold()` runs: the pump waits before it
    launches a claimed batch, and an `_update` before it is applied."""

    def __init__(self):
        self.free = threading.Event()
        self.free.set()

    def install(self, mi, front):
        launch = front._launch_group

        def held_launch(*a, **k):
            self.free.wait()
            return launch(*a, **k)

        front._launch_group = held_launch
        ref = mi._get_ref("main")
        index = ref.index
        mi._release_ref(ref)
        update = index.update

        def held_update(*a, **k):
            self.free.wait()
            return update(*a, **k)

        index.update = held_update

    def hold(self):
        self.free.clear()
        try:
            time.sleep(HOLD_S)
        finally:
            self.free.set()


def _stalled_capture(hold, recording=None):
    """A stand-in for utils/profiling.capture whose start and stop hold the
    served path for HOLD_S each; `recording` is set while it records."""
    from acoustid_index_tpu_torch.utils import profiling

    @contextlib.contextmanager
    def capture(log_dir):
        profiling.REGISTRY.capture_started()
        try:
            hold.hold()
            if recording is not None:
                recording.set()
            yield None
            if recording is not None:
                recording.clear()
            hold.hold()
        finally:
            profiling.REGISTRY.capture_stopped()
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "trace-0.json"), "w") as f:
            json.dump({"traceEvents": []}, f)

    return capture


def _traced_run(manifest, monkeypatch, workload, seed, faults):
    from acoustid_index_tpu_torch.utils import profiling

    cell = small(registry.cell(registry.with_pending(manifest), workload))
    cell.traffic["timeout_ms"] = TIMEOUT_MS
    monkeypatch.setattr(harness, "SLICE_MAX_S", 1.0)
    monkeypatch.setattr(harness, "COUNTED_MAX_S", 3.0)
    hold, recording = _Hold(), threading.Event()
    monkeypatch.setattr(profiling, "capture", _stalled_capture(hold, recording))

    def install(mi, front):
        hold.install(mi, front)
        if faults:
            faults(mi, front, recording)

    return harness.run_cell(cell, seed, SECONDS, True, time.time(), device="cpu", faults=install)


def _assert_quiet(detail):
    q = detail["trace"]["quiet"]
    n = 2 if detail["writer"] else 1  # searches, then writes
    assert q["sent_while_paused"] == [0] * n and q["admitted_while_paused"] == [0] * n, q
    assert q["profiler_inside_pauses"], q
    assert detail["trace"]["profiler_start_s"] >= HOLD_S and detail["trace"]["profiler_stop_s"] >= HOLD_S


@pytest.mark.parametrize("workload", ["fp10m.search", "fp10m.open"])
def test_a_stalled_capture_leaves_a_sound_run_correct(manifest, monkeypatch, workload):
    out, detail = _traced_run(manifest, monkeypatch, workload, 2**31 + 19, None)
    assert out["correct"] is True, out["checks"]
    assert all(c["limit"] == 0 for c in out["checks"].values())
    _assert_quiet(detail)
    # The load ran after the second resume too.
    assert detail["search"]["per_s"][-1] > 0


def test_an_answer_altered_in_the_slice_is_not_correct(manifest, monkeypatch):
    def alter_while_recording(mi, front, recording):
        def edit(out, ob):
            if recording.is_set():
                out[0, ob] += 1

        _patch_complete(front, edit)

    out, detail = _traced_run(manifest, monkeypatch, "fp10m.search", 2**32 + 41, alter_while_recording)
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] + out["checks"]["inconsistent_answers"]["value"] > 0
    assert out["checks"]["unanswered_searches"]["value"] == 0
    _assert_quiet(detail)


def test_a_traced_write_cell_reads_every_write_back(manifest, monkeypatch):
    out, detail = _traced_run(manifest, monkeypatch, "fp10m.rw", 2**33 + 3, None)
    assert out["checks"]["failed_updates"]["value"] == 0 and out["checks"]["wrong_readbacks"]["value"] == 0
    assert out["correct"] is True, out["checks"]
    _assert_quiet(detail)
    assert detail["writer"]["sent"] < round(SECONDS / 0.05)  # its schedule was suspended, not crowded

"""One run of one cell: set-up as an operator's restart, the measured
window through the served path, the comparison with the plain reference,
and the result line.

Set-up: the seed's corpus is made on the card and written as the data
directory that one checkpointed file segment leaves (segfile.py); the
server is the CLI's own, main.build_server over main.build_parser, on that
directory, with the configuration's flags; the cell's own traffic is sent
for `warmup_s` seconds so that every batch shape and buffer it uses is
made.  setup_s runs from the process's start to the window's first
request.

The window: load generators in processes of their own send the cell's
traffic to the native search port (and, with `writes`, `_update` to the
HTTP port) for --seconds; this process only sleeps, or with --trace 1
reads the program's counters over the window's first part and then
captures a slice of it with the program's utils/profiling.capture.  The
profiler's start and stop each hold the served path for seconds, longer
than a search's timeout, so a traced run pauses the load around both:
the generators stop sending and their answers in flight come back before
the profiler starts or stops, and the load resumes once it has (see
_capture).  An untraced run never pauses.  The load generators run on
one physical core of their own (both of its hardware threads), the
server's process on the others, so that neither takes the other's cores.
Afterwards every answer due in the window is awaited; answers to one
query must agree byte for byte, and a sample of queries drawn from the
seed is compared with the plain reference (reference.py).  With writes,
the final and the previous version of every written doc are searched
through the native port and compared with the reference over the corpus
and the newest versions.  A run whose process holds JAX or the JAX package
once the window has closed gives no result (foreign_modules).
"""

from __future__ import annotations

import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from . import corpus as corpus_mod
from . import loadgen, reference, registry, roofline, segfile, traffic, tracing

RANGE_GROUP = "range"
SLICE_MAX_S = 3.0
COUNTED_MAX_S = 20.0  # a traced run's untraced stretch, read for the counters
DRAIN_SPARE_S = 5.0  # past the traffic's timeout, for the answers in flight at a pause
FOREIGN = ("jax", "jaxlib", "flax", "acoustid_index_tpu")  # top-level names the run may not hold


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _counters(front) -> Dict[str, int]:
    from acoustid_index_tpu_torch.ops import search_kernel
    from acoustid_index_tpu_torch.server import metrics

    merges = 0
    for line in metrics.render().splitlines():
        if line.startswith(f"{metrics.PREFIX}_memory_merges_total "):
            merges = int(float(line.split()[-1]))
    s = dict(search_kernel.STATS)
    return {
        "batches": s["direct"] + s["matrix"] + s["sort"],
        "host_syncs": s["host_syncs"],
        "answered": front.stat(1),
        "memory_merges": merges,
    }


def _siblings(cpu: int) -> set:
    """The hardware threads of `cpu`'s physical core (itself alone where
    the kernel does not say)."""
    path = f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list"
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return {cpu}
    out = set()
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.update(range(int(a), int(b or a) + 1))
    return out


def cpu_split(cpus) -> tuple:
    """(server CPUs, load-generator CPUs) of the CPUs `cpus`: the load
    generators take the last CPU's physical core, the server the rest;
    with fewer than four CPUs both share all of them."""
    cpus = set(cpus)
    if len(cpus) < 4:
        return cpus, cpus
    load = _siblings(max(cpus)) & cpus
    if len(cpus - load) < 2:
        load = {max(cpus)}
    return cpus - load, load


def _pin_process(cpus) -> None:
    """Every thread of this process onto `cpus` (threads started later
    inherit it from the thread that starts them)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (ProcessLookupError, PermissionError):
            pass


def _host() -> Dict[str, float]:
    """This process's CPU seconds (every thread of the server) and the
    interpreter's collections so far, by generation."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    out = {"server_cpu_s": r.ru_utime + r.ru_stime}
    for g, st in enumerate(gc.get_stats()):
        out[f"gc_gen{g}_collections"] = st["collections"]
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def foreign_modules(names=None) -> list:
    """The top-level names of FOREIGN among the modules `names` (those of
    sys.modules by default), each compared whole: the port,
    acoustid_index_tpu_torch, is not the JAX package."""
    names = list(sys.modules) if names is None else names
    return sorted({n.partition(".")[0] for n in names} & set(FOREIGN))


def _sample(seed: int, indices, k: int):
    """k of `indices` (ints), drawn from the seed."""
    idx = torch.tensor(sorted(indices), dtype=torch.int64)
    if not idx.numel():
        return idx
    keys = corpus_mod.draw(seed, corpus_mod.SAMPLE, idx & corpus_mod.M32)
    return idx[torch.argsort(keys)[:k]]


def compare(records: dict, indices, want) -> int:
    """How many of the answers recorded for `indices` differ from `want`."""
    wrong = 0
    for i, w in zip(indices, want):
        status, body = records.get(int(i), (0, b""))
        if reference.decode(status, body) != w:
            wrong += 1
    return wrong


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", faults=None):
    """(result, detail): the run's result (the last line's object) and
    what else it measured.  `device` is "cuda" for every run of the
    benchmark; the CPU tests pass "cpu", and `faults(mi, front)` breaks
    the served path for them."""
    from acoustid_index_tpu_torch import main as cli  # the program; absent, the run fails here
    from acoustid_index_tpu_torch.ops import _build as kernel_build

    cfg, tr = cell.config, cell.traffic
    os.environ["AITPU_TORCH_DEVICE"] = device
    dev = torch.device(device)
    index = cfg["index"]
    split: Dict[str, float] = {}

    t = time.time()
    exe = loadgen.build()
    split["loadgen_build_s"] = time.time() - t

    work = tempfile.mkdtemp(prefix="aitpu-bench-")
    running = []
    server = None
    all_cpus = os.sched_getaffinity(0)
    server_cpus, load_cpus = cpu_split(all_cpus)
    _pin_process(server_cpus)
    try:
        t = time.time()
        corpus = corpus_mod.make(cfg["corpus"], seed)
        data_dir = os.path.join(work, "data")
        seg_bytes = segfile.write_data_dir(data_dir, index, corpus, dev)
        split["corpus_and_file_s"] = time.time() - t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        spans = tracing.SpanTimer()
        spans.install()
        t = time.time()
        args = cli.build_parser().parse_args(
            list(cfg["server_flags"]) + ["--dir", data_dir, "--host", "127.0.0.1", "--port", "0"])
        server, mi, replicator, front, legacy = cli.build_server(args)
        server.serve_background()
        split["restart_s"] = time.time() - t
        spans.uninstall()
        split.update({f"restart.{k}_s": v for k, v in spans.snapshot().items()})
        if faults:
            faults(mi, front)

        t = time.time()
        pool = int(tr["pool"])
        queries = traffic.make_queries(corpus, cfg["query"], pool, seed, device=dev)
        requests = traffic.search_requests(queries, index, int(tr["timeout_ms"]))
        writes = tr.get("writes")
        if writes:
            lo, hi = corpus.docs_range()
            upd = traffic.Updates(hi + 1, int(writes["window"]), int(writes["docs"]),
                                  int(writes["hashes_per_doc"]), seed)
            per_cycle = upd.window // upd.docs
            n_window = int(round(seconds / float(writes["period_s"])))
            warm_writes = upd.requests(index, 0, per_cycle)
            window_writes = upd.requests(index, per_cycle, per_cycle + n_window)
        split["traffic_s"] = time.time() - t

        t = time.time()
        mode = tr["loop"]
        kw = {"conns": int(tr["connections"]), "cpus": load_cpus}
        if mode == "open":
            kw["rate"] = float(tr["rate"])
        rec = os.path.join(work, "load")
        warm = [loadgen.Run(exe, mode, front.port, requests, rec + "-warm", seed ^ 0x5EED, seconds=float(tr["warmup_s"]), **kw)]
        if writes:
            warm.append(loadgen.Run(exe, "once", server.port, warm_writes, rec + "-warmw", seed, conns=1, cpus=load_cpus))
        running = warm
        warm_res = [r.wait() for r in warm]
        running = []
        for r in warm_res:
            if r.summary["non200"] or r.summary["unanswered"]:
                raise RuntimeError(f"warm-up: requests failed: {r.summary}")
        split["warmup_s"] = time.time() - t
        split.update({f"build.{k}_s": v for k, v in kernel_build.build_seconds.items()})  # nvcc, first run only

        before = _counters(front)
        host_before = _host()
        start_at = time.monotonic() + 0.5
        runs = [loadgen.Run(exe, mode, front.port, requests, rec, seed, seconds=seconds, start_at=start_at,
                            control=trace, **kw)]
        if writes:
            runs.append(loadgen.Run(exe, "writer", server.port, window_writes, rec + "-w", seed,
                                    seconds=seconds, conns=1, period=float(writes["period_s"]), start_at=start_at,
                                    cpus=load_cpus, control=trace))
        running = runs
        traced = counted = None
        if trace:
            counted = _count(front, start_at, seconds)
            traced = _capture(front, runs, seconds, work, float(tr["timeout_ms"]) / 1e3 + DRAIN_SPARE_S)
        time.sleep(max(start_at + seconds - time.monotonic(), 0.0))
        host = _delta(host_before, _host())  # the window's, before the answers are read
        results = [r.wait() for r in runs]
        running = []
        after = _counters(front)
        if traced is not None:
            # Read after the window: reducing ~100 MB of trace holds the
            # interpreter lock for seconds, which the served path needs.
            traced = _reduce(traced, registry.kernel_names(RANGE_GROUP, cell.base))
        host["gc_tracked_objects"] = len(gc.get_objects())
        search = results[0]
        if writes:
            # A traced run's pauses suspend the writer's schedule, so the
            # writes past the window's end are never sent.
            n_written = per_cycle + int(results[1].summary["sent"])
        # From the process's start to the window's first request (the load
        # generator's t0 is on the monotonic clock).
        setup_s = search.summary["t0"] - (time.monotonic() - (time.time() - t_start))
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

        readback = None
        if writes:
            readback = _readback(exe, front.port, upd, n_written, index, work)
        cli.stop_server(server, mi, replicator, front, legacy)
        server = None
        del mi, front
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- the comparison, after the program's state is freed ----
        t = time.time()
        checks = {}
        sample = _sample(seed, search.records.keys(), int(tr["check_sample"]))
        sources = [corpus]
        ambiguous = 0
        keep = torch.ones(sample.numel(), dtype=torch.bool)
        if writes:
            ambiguous_rows = _written_could_match(upd, n_written, queries.hashes[sample], queries.min_score)
            keep &= ~ambiguous_rows
            ambiguous = int(ambiguous_rows.sum())
        sample = sample[keep]
        want = reference.search(sources, queries.hashes[sample], queries.limit, queries.min_score, queries.pct)
        checks["wrong_answers"] = compare(search.records, sample.tolist(), want)
        checks["inconsistent_answers"] = int(search.summary["inconsistent"])
        checks["unanswered_searches"] = int(search.summary["unanswered"] + search.summary["non200"])
        if writes:
            w = results[1].summary
            checks["failed_updates"] = int(w["unanswered"] + w["non200"])
            ids, newest = readback["ids"], readback["newest"]
            written = reference.Postings(newest.reshape(-1), ids[:, None].expand_as(newest).reshape(-1))
            rq = readback["queries"]
            want_rb = reference.search([corpus, written], rq.hashes, rq.limit, rq.min_score, rq.pct)
            checks["wrong_readbacks"] = compare(readback["records"], range(len(want_rb)), want_rb)
        split["check_s"] = time.time() - t

        if not trace:
            e2e = {
                "search_qps": lambda: search.summary["answered_in_window"] / seconds,
                "search_p99_ms": lambda: loadgen.percentile_ms(search.latencies, 99),
                "update_p95_ms": lambda: loadgen.percentile_ms(results[1].latencies, 95),
                "setup_s": lambda: setup_s,
            }
            metrics = {m["name"]: {"value": e2e[m["name"]](), "unit": m["unit"]} for m in cell.end_to_end}
        else:
            ctx = dict(counted, trace=traced, hbm_bytes_per_s=_hbm(dev))
            if traced is not None:
                ctx["range_bytes_per_query"] = roofline.range_bytes_per_query(corpus, queries.hashes[sample[:1024]])
            metrics = registry.metric_values(cell.per_layer, ctx, cell.base)

        attempted = search.summary["sent"] + (results[1].summary["sent"] if writes else 0)
        failed = checks["unanswered_searches"] + checks.get("failed_updates", 0)
        limits = {k: 0 for k in checks}
        detail = {
            "cell": cell.name, "seed": seed, "seconds": seconds, "trace": trace,
            "setup_split": split, "segment_file_bytes": seg_bytes,
            "search": search.summary, "search_p50_ms": loadgen.percentile_ms(search.latencies, 50),
            "search_p99_ms": loadgen.percentile_ms(search.latencies, 99),
            "writer": results[1].summary if writes else None,
            "readback": readback["summary"] if writes else None,
            "checked_answers": int(sample.numel()), "ambiguous_skipped": ambiguous,
            "counters": _delta(before, after), "counted": counted, "spans": spans.snapshot(),
            "cpus": {"server": sorted(server_cpus), "load": sorted(load_cpus)},
            "host": host,
        }
        if traced is not None:
            detail["trace"] = {k: v for k, v in traced.items() if k not in ("device_ops", "idle_gaps")}
            detail["trace"]["quiet"] = _quiet(traced, [r.summary for r in results])
        if writes:
            detail["update_p50_ms"] = loadgen.percentile_ms(results[1].latencies, 50)
            detail["update_p99_ms"] = loadgen.percentile_ms(results[1].latencies, 99)
        log("detail " + json.dumps(detail, default=str))
        found = foreign_modules()
        if found:
            raise RuntimeError(f"this process holds {', '.join(found)} after the window: the run gives no result")
        out = {
            "correct": all(checks[k] <= limits[k] for k in checks),
            "attempted": int(attempted),
            "failed": int(failed),
            "metrics": metrics,
            "device": _device(dev, cell.chips, peak),
        }
        if trace and traced is not None:
            out["device"]["busy_s"] = traced["busy_s"]
            out["device"]["window_s"] = traced["slice_s"]
            out["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
        out["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in checks}
        return out, detail
    finally:
        for r in running:
            r.kill()
        if server is not None:
            cli.stop_server(server, mi, replicator, front, legacy)
        shutil.rmtree(work, ignore_errors=True)
        _pin_process(all_cpus)


def _hbm(dev) -> Optional[float]:
    if dev.type != "cuda":
        return None
    p = roofline.peaks()
    return p.get(torch.cuda.get_device_name(dev), {}).get("hbm_bytes_per_s")


def _device(dev, chips: int, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _count(front, start_at: float, seconds: float) -> dict:
    """The program's counters over the traced run's first stretch of the
    window, before the profiler starts (its start and stop slow the served
    path), with `window_s` its length."""
    counted_s = min(COUNTED_MAX_S, seconds / 3)
    time.sleep(max(start_at - time.monotonic(), 0.0))
    before = _counters(front)
    t = time.monotonic()
    time.sleep(counted_s)
    after = _counters(front)
    return dict(_delta(before, after), window_s=time.monotonic() - t)


def _pause(load, limit_s: float) -> None:
    """Pause every load generator and wait up to `limit_s` for each one's
    answers in flight.  The generators keep the record (their `pauses`);
    one that did not drain in time shows there, and _quiet reads it."""
    for r in load:
        r.pause()
    for r in load:
        r.drained(limit_s)


def _resume(load) -> None:
    for r in load:
        r.resume()


def _capture(front, load, seconds: float, work: str, drain_limit_s: float) -> dict:
    """A capture of a slice of the window by the program's own
    utils/profiling.capture (every thread's host operations and the card's
    activity).  It follows _count's stretch.  The profiler takes
    7.5-16 s to start and 5-8.5 s to stop on an H100, and holds the served
    path meanwhile, longer than a search's timeout; so the load generators
    `load` are paused and drained before the capture is entered, resume
    once it records, pause and drain again at the slice's end before it
    stops, and resume once it has stopped.  No request is in flight or
    falls due while the profiler starts or stops, and every request sent
    is checked as in an untraced run.  The slice runs from the first resume
    to the second drain, so the batches counted over it are those whose
    kernels the capture holds.

    The registry's window (metrics/spans.py) ends where the capture is
    entered, after the first drain; so the span metrics' stretch ends
    later than the counters' (_count's) by `span_lag_s`, and takes in the
    drain's batches and answers (`drain`), while no request is sent.

    The trace file is left for _reduce.  It is the process's only profiler
    session: a session started and stopped in set-up cut the window's start
    to milliseconds, but the window's capture then held no kernel at all in
    2 of 5 runs on an H100."""
    from acoustid_index_tpu_torch.utils import profiling

    slice_s = min(SLICE_MAX_S, seconds / 4)
    d = os.path.join(work, "trace")
    edge, t_edge = _counters(front), time.monotonic()  # where _count's stretch ended
    _pause(load, drain_limit_s)
    drain = _delta(edge, _counters(front))
    t_enter = time.monotonic()
    with profiling.capture(d):
        t_record = time.monotonic()
        _resume(load)
        before = _counters(front)
        t = time.monotonic()
        time.sleep(slice_s)
        _pause(load, drain_limit_s)
        after = _counters(front)
        t_stop = time.monotonic()
    t_exit = time.monotonic()
    _resume(load)
    (path,) = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".json")]
    n = _delta(before, after)
    return {"path": path, "profiler_start_s": t_record - t_enter, "profiler_stop_s": t_exit - t_stop,
            "slice_s": t_stop - t, "batches": n["batches"], "rows": n["answered"],
            "span_lag_s": t_enter - t_edge, "drain": {"batches": drain["batches"], "answered": drain["answered"]},
            "stamps": {"profiler_entry": t_enter, "recording_start": t_record, "recording_end": t_stop,
                       "profiler_exit": t_exit}}


def _reduce(captured: dict, range_kernels) -> dict:
    """_capture's numbers with its trace reduced (tracing.reduce_trace);
    the trace file is removed."""
    path = captured.pop("path")
    t = time.monotonic()
    red = tracing.reduce_trace(path, {RANGE_GROUP: range_kernels})
    red.update(captured, trace_bytes=os.path.getsize(path), reduce_s=time.monotonic() - t)
    os.unlink(path)
    return red


def _quiet(traced: dict, summaries) -> dict:
    """Whether the profiler started and stopped with no request in flight
    or due: by each load generator's own record of its pauses (searches,
    then writes), the requests sent and admitted between a pause and its
    resume, and whether the profiler's entry and exit fell after every
    drain and before every resume (one clock, CLOCK_MONOTONIC)."""
    st = traced["stamps"]
    gen = [s.get("pauses", []) for s in summaries]
    spans = [(st["profiler_entry"], st["recording_start"]), (st["recording_end"], st["profiler_exit"])]
    inside = all(len(ps) == 2 for ps in gen)
    for ps in gen:
        for p, (a, b) in zip(ps, spans):
            inside &= p["drained"] is not None and p["resume"] is not None and p["drained"] <= a and b <= p["resume"]
    return {"sent_while_paused": [sum(p["sent"] for p in ps) for ps in gen],
            "admitted_while_paused": [sum(p["admitted"] for p in ps) for ps in gen],
            "profiler_inside_pauses": bool(inside), "paused_s": [s.get("paused_s") for s in summaries]}


def _readback(exe: str, port: int, upd, n_updates: int, index: str, work: str) -> dict:
    """Search the newest and the previous version of every written doc."""
    ids, newest, prev = upd.final(n_updates)
    q = traffic.Queries(torch.cat([newest, prev]), torch.cat([ids, ids]), 10, 1, 10)
    res = loadgen.run(exe, "once", port, traffic.search_requests(q, index, 10_000), os.path.join(work, "readback"), 0,
                      conns=64)
    return {"queries": q, "summary": res.summary, "records": res.records, "ids": ids, "newest": newest}


def _written_could_match(upd, n_updates: int, hashes, min_score: int):
    """Rows of `hashes` that some version of a written doc shares
    min_score hashes or more with: their answers could change in the
    window, and they are not compared."""
    ids_all, h_all = [], []
    for k in range(n_updates):
        ids, v = upd.ids_versions(k)
        ids_all.append(ids + v * (1 << 24))
        h_all.append(upd.hashes(ids, v))
    h = torch.cat(h_all)
    d = torch.cat(ids_all)[:, None].expand_as(h)
    src = reference.Postings(h.reshape(-1), d.reshape(-1))
    q, _, s = reference.scores([src], hashes)
    out = torch.zeros(hashes.shape[0], dtype=torch.bool)
    out[q[s >= min_score]] = True
    return out

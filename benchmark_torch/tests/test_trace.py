"""The reduction of a capture and the needed-bytes arithmetic, on made-up inputs."""

import json

import pytest
import torch

from benchmark_torch import roofline, tracing
from benchmark_torch.metrics import readers


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace(tmp_path):
    ev = [
        # host: the pump (tid 7) launches K1 inside aten::foo, then waits in a sync
        _x("cpu_op", "pump_batch", 0, 1000, tid=7),
        _x("cpu_op", "aten::foo", 10, 100, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, tid=7, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 5, tid=7, corr=2),
        _x("cpu_op", "aten::sync_thing", 300, 150, tid=7),
        _x("cuda_runtime", "cudaMemcpyAsync", 600, 5, tid=7, corr=3),
        # device: K1 [100, 150), K2 [140, 200) overlapping, a copy [500, 520)
        _x("kernel", "block_count_kernel(unsigned int const*, int)", 100, 50, tid=9, corr=1),
        _x("kernel", "void block_count_emit_kernel<4>(unsigned int const*)", 140, 60, tid=9, corr=2),
        _x("gpu_memcpy", "Memcpy DtoH", 500, 20, tid=9, corr=3),
        _x("kernel", "other_kernel", 520, 30, tid=9, corr=None),
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    red = tracing.reduce_trace(str(path), {"range": ["block_count_kernel", "block_count_emit_kernel"],
                                           "k1": ["block_count_kernel"]})
    assert red["busy_s"] == pytest.approx((100 + 50) / 1e6)  # [100, 200) and [500, 550)
    assert red["kernel_s"] == pytest.approx(140 / 1e6)
    assert red["kernel_s_by_group"] == pytest.approx({"range": 110 / 1e6, "k1": 50 / 1e6})
    assert red["device_ops"][0] == ["void block_count_emit_kernel<4>", pytest.approx(60 / 1e6)]
    # the gap [200, 500) ends at the copy launched from tid 7; its middle,
    # 350, lies in aten::sync_thing (the innermost host op there)
    assert red["idle_gaps"] == [["aten::sync_thing", pytest.approx(300 / 1e6)]]


def test_kernel_names_match_whole_words():
    assert tracing.matches("block_count_kernel(int)", ["block_count_kernel"])
    assert not tracing.matches("block_count_kernel_v2(int)", ["block_count_kernel"])
    assert not tracing.matches("my_block_count_kernel", ["block_count_kernel"])


class _Runs:
    """A sorted tier of 4,096 postings whose run of hash h starts at 4 h and
    holds h % 3 postings."""

    n_postings = 4096

    def runs(self, q):
        return q * 4, q % 3


def test_range_bytes_per_query():
    q = torch.tensor([[1, 2, 2, 300], [600, 601, 602, 603]])
    got = roofline.range_bytes_per_query(_Runs(), q)
    # row 0, distinct 1, 2, 300: bounds (lo-1, lo, hi-1, hi) clamped, as words
    # of the interleaved tier (block b of 1,024 at 2,048 b), sectors of 8
    def sectors(rows):
        s = set()
        for lo, cnt in rows:
            for p in (lo - 1, lo, lo + cnt - 1, lo + cnt):
                p = min(max(p, 0), 4095)
                s.add(((p // 1024) * 2048 + p % 1024) // 8)
        return len(s)

    r0 = sectors([(4, 1), (8, 2), (1200, 0)]) * 32 + (1 + 2 + 0) * 8 + 3 * 12
    r1 = sectors([(2400, 0), (2404, 1), (2408, 2), (2412, 0)]) * 32 + 3 * 8 + 4 * 12
    assert got == pytest.approx((r0 + r1) / 2)


def test_readers():
    ctx = {"answered": 1000, "batches": 8, "host_syncs": 16, "window_s": 4.0, "memory_merges": 6,
           "hbm_bytes_per_s": 3.35e12, "range_bytes_per_query": 3.35e3,
           "trace": {"kernel_s": 0.004, "batches": 4, "rows": 500, "kernel_s_by_group": {"range": 0.001}}}
    assert readers.rows_per_launch(ctx) == 125
    assert readers.host_syncs_per_batch(ctx) == 2
    assert readers.card_ms_per_batch(ctx) == pytest.approx(1.0)
    assert readers.per_second(ctx, "memory_merges") == 1.5
    # 500 queries x 3,350 bytes at 3.35e12 B/s = 0.5 us of a 1 ms kernel time
    assert readers.range_roofline_pct(ctx) == pytest.approx(0.05)
    for empty in ({}, {"batches": 0, "answered": 5, "host_syncs": 0}):
        assert readers.rows_per_launch(empty) is None and readers.card_ms_per_batch(empty) is None
    ctx["trace"]["kernel_s_by_group"]["range"] = 0.0
    assert readers.range_roofline_pct(ctx) is None  # nothing to read: never 0

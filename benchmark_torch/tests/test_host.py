"""The run's placement on the host's CPUs, and the span timer that times
the restart and then gives the program its own `trace` back."""

import os

import pytest

from benchmark_torch import harness, tracing


@pytest.mark.parametrize("cpus", [set(range(8)), set(range(32)), {2, 3, 5, 7, 11}])
def test_load_generators_get_a_core_of_their_own(cpus):
    server, load = harness.cpu_split(cpus)
    assert load and len(server) >= 2
    assert not server & load and server | load == cpus
    assert max(cpus) in load


@pytest.mark.parametrize("cpus", [{0}, {0, 1, 2}])
def test_few_cpus_are_shared(cpus):
    assert harness.cpu_split(cpus) == (cpus, cpus)


def test_pinning_is_undone():
    before = os.sched_getaffinity(0)
    server, _ = harness.cpu_split(before)
    harness._pin_process(server)
    try:
        assert os.sched_getaffinity(0) == server
    finally:
        harness._pin_process(before)
    assert os.sched_getaffinity(0) == before


def test_span_timer_times_the_restart_and_restores_trace():
    from acoustid_index_tpu_torch.engine import searcher
    from acoustid_index_tpu_torch.utils import profiling

    orig = profiling.trace
    had = getattr(searcher, "trace", None)
    timer = tracing.SpanTimer()
    timer.install()
    assert profiling.trace is not orig
    with profiling.trace("open.read"):
        pass
    timer.uninstall()
    assert profiling.trace is orig and getattr(searcher, "trace", None) is had
    assert timer.count["open.read"] == 1 and timer.snapshot()["open.read"] >= 0

"""Profiling hooks: torch.profiler spans around the device hot paths
(counterpart of acoustid_index_tpu/utils/profiling.py).

  * `trace(name)` annotates a host span (search dispatch) so that the
    card's timeline lines up with engine phases;
  * `capture(log_dir)` records CPU and CUDA activity into a Chrome trace
    under `log_dir`.

The reference's `--profile-port` starts jax.profiler's live capture
server; torch has no counterpart, so that flag stays unported (main.py).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("acoustid_index_tpu_torch.profiling")


@contextlib.contextmanager
def trace(name: str):
    """Annotate a host-side span in the device trace timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture(log_dir: str):
    """Capture a programmatic trace of the block into `log_dir` as a Chrome
    trace (trace-<ns>.json); yields the profiler.  Every thread is
    recorded: the searcher dispatches from its own thread."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)

"""Searches the native front answered per batch its pumps launched
(NativeFront.stat(1) over the batches counted in ops/search_kernel.STATS),
over the traced run's stretch of the window before the profiler starts.
Fuller batches spread the per-batch host cost over more searches."""

from benchmark_torch.metrics import readers

UNIT = "rows"
LAYER = "native front: server/native_front.py over csrc/aitpu_front.cc"
MOVES = "search_qps"
SOURCE = "program_counter"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return readers.rows_per_launch(ctx)

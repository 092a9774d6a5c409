"""Host syncs per batch (ops/search_kernel.STATS["host_syncs"] over its
branch counts), over the traced run's stretch of the window before the
profiler starts: each one stalls the launching thread on the card."""

from benchmark_torch.metrics import readers

UNIT = "syncs"
LAYER = "search program: ops/search_kernel.py"
MOVES = "search_qps"
SOURCE = "program_counter"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return readers.host_syncs_per_batch(ctx)

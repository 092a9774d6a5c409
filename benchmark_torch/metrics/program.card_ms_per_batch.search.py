"""The card's kernel time per batch: every kernel in the capture of the
window's middle slice over the batches launched in that slice."""

from benchmark_torch.metrics import readers

UNIT = "ms"
LAYER = "search program: ops/search_kernel.py"
MOVES = "search_qps"
SOURCE = "device_trace"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return readers.card_ms_per_batch(ctx)

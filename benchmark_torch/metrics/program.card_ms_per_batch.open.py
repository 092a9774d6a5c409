"""As program.card_ms_per_batch.search, in the open loop below capacity:
each batch's card time is part of every search's latency in it."""

from benchmark_torch.metrics import readers

UNIT = "ms"
LAYER = "search program: ops/search_kernel.py"
MOVES = "search_p99_ms"
SOURCE = "device_trace"
WORKLOADS = ["fp10m.open"]


def read(ctx):
    return readers.card_ms_per_batch(ctx)

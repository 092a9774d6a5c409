"""As front.rows_per_launch.search, in the open loop below capacity: a
batch holds the searches that arrived while the one before it ran, and
the tail follows the wait."""

from benchmark_torch.metrics import readers

UNIT = "rows"
LAYER = "native front: server/native_front.py over csrc/aitpu_front.cc"
MOVES = "search_p99_ms"
SOURCE = "program_counter"
WORKLOADS = ["fp10m.open"]


def read(ctx):
    return readers.rows_per_launch(ctx)

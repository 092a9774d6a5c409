"""As front.rows_per_launch.search, in the open loop beside writes: below
capacity a batch waits for fewer rows, and the tail follows the wait."""

from benchmark_torch.metrics import readers

UNIT = "rows"
LAYER = "native front: server/native_front.py over csrc/aitpu_front.cc"
MOVES = "search_p99_ms"
SOURCE = "program_counter"
WORKLOADS = ["fp10m.rw"]


def read(ctx):
    return readers.rows_per_launch(ctx)

"""Memory-tier merges per second (/_metrics aitpu_memory_merges_total),
over the traced run's stretch of the window before the profiler starts:
each folds written segments under the index manager, beside the writes it
may delay."""

from benchmark_torch.metrics import readers

UNIT = "merges/s"
LAYER = "index manager: engine/index.py, multi/multi_index.py"
MOVES = "update_p95_ms"
SOURCE = "program_counter"
WORKLOADS = ["fp10m.rw"]


def read(ctx):
    return readers.per_second(ctx, "memory_merges")

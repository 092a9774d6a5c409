"""The launching thread's time stalled on the card per batch: the span
`program.sync` around the search program's host syncs (ops/search_kernel.py
`_host`), over the batches claimed in the traced run's untraced stretch,
in ms."""

from benchmark_torch.metrics import spans

UNIT = "ms"
LAYER = "search program: ops/search_kernel.py"
MOVES = "search_qps"
SOURCE = "program_span"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return spans.ms_per_batch(ctx, "program.sync")

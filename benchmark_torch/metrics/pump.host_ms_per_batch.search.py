"""The pump's host time per batch: the span `pump.batch`, from the claim's
return to the last chunk enqueued (pack, in-flight wait, launch of the
search program, enqueue), over the batches claimed in the traced run's
untraced stretch, in ms."""

from benchmark_torch.metrics import spans

UNIT = "ms"
LAYER = "batching / searcher: server/native_front.py pump over engine/searcher.py"
MOVES = "search_qps"
SOURCE = "program_span"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return spans.ms_per_batch(ctx, "pump.batch")

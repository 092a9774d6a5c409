"""The collectors' time to complete a batch: the span `collect.complete`
(the serving histograms and aitpu_front_complete, which hands the rows to
the C++ front), over the batches claimed in the traced run's untraced
stretch, in ms."""

from benchmark_torch.metrics import spans

UNIT = "ms"
LAYER = "native front: server/native_front.py over csrc/aitpu_front.cc"
MOVES = "search_qps"
SOURCE = "program_span"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return spans.ms_per_batch(ctx, "collect.complete")

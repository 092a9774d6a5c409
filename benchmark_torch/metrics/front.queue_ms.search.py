"""The native front's queue wait: from a search queued for a pump to its
claim (csrc/aitpu_front.cc's `front.queue_wait_ns` over
`front.queue_waits`), in ms, over the traced run's untraced stretch."""

from benchmark_torch.metrics import spans

UNIT = "ms"
LAYER = "native front: server/native_front.py over csrc/aitpu_front.cc"
MOVES = "search_qps"
SOURCE = "program_counter"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return spans.queue_ms(ctx)

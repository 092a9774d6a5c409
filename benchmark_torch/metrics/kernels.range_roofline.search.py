"""The range phase's share of its roofline: the least time of its needed
bytes (roofline.py, counted from the queries sent and the corpus made) at
the card's HBM rate, over the device time of the kernels named in
kernels/range/ in the capture, for the searches answered in the slice."""

from benchmark_torch.metrics import readers

UNIT = "%"
LAYER = "kernels: ops/block_lookup.py over csrc/block_lookup.cu"
MOVES = "search_qps"
SOURCE = "device_trace"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return readers.range_roofline_pct(ctx)

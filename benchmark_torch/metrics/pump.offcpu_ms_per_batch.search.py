"""The pump's time off the CPU per batch: `pump.batch`'s wall time less
the pump thread's CPU time, over the batches claimed in the traced run's
untraced stretch, in ms: waits for the interpreter lock, the in-flight
semaphore and a core (CUDA's spin-wait syncs count as CPU).  The thread's
CPU clock is read on one batch in 16 and counts all of the thread's CPU
time since the previous reading, the claim's few microseconds a batch
included."""

from benchmark_torch.metrics import spans

UNIT = "ms"
LAYER = "batching / searcher: server/native_front.py pump over engine/searcher.py"
MOVES = "search_qps"
SOURCE = "program_span"
WORKLOADS = ["fp10m.search", "fp134m.search"]


def read(ctx):
    return spans.ms_per_batch(ctx, "pump.batch", off_cpu=True)

"""What the per-layer metrics' files read, from the run's context: the
program's counters (ops/search_kernel.STATS, the native front's answered
count, /_metrics' memory merges) over the traced run's first stretch of
the window, before the profiler starts, `window_s` long; and the reduced
capture of a slice after it (`trace`)."""


def rows_per_launch(ctx):
    return ctx["answered"] / ctx["batches"] if ctx.get("batches") else None


def host_syncs_per_batch(ctx):
    return ctx["host_syncs"] / ctx["batches"] if ctx.get("batches") else None


def card_ms_per_batch(ctx):
    t = ctx.get("trace")
    if not t or not t["batches"] or not t["kernel_s"]:
        return None
    return t["kernel_s"] / t["batches"] * 1e3


def range_roofline_pct(ctx, group: str = "range"):
    """The range phase's least time (its needed bytes at the card's HBM
    rate) as a share of its kernels' time, in %."""
    t = ctx.get("trace")
    bw = ctx.get("hbm_bytes_per_s")
    per_query = ctx.get("range_bytes_per_query")
    if not t or not bw or not per_query or not t["rows"]:
        return None
    kernel_s = t["kernel_s_by_group"].get(group, 0.0)
    if not kernel_s:
        return None
    return t["rows"] * per_query / bw / kernel_s * 100


def per_second(ctx, key: str):
    return ctx[key] / ctx["window_s"] if ctx.get("window_s") else None

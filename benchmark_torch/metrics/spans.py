"""What the span-based per-layer metrics read: the program's span and
counter registry (acoustid_index_tpu_torch/utils/profiling) over the
traced run's untraced stretch, the `window_s` seconds that ended when the
capture began (the same stretch as the counters in readers.py).  A program
without the registry's window gives nothing to read (None)."""


def window(ctx):
    """The registry's totals over the stretch, or None."""
    if not ctx.get("window_s"):
        return None
    try:
        from acoustid_index_tpu_torch.utils import profiling
    except ImportError:
        return None
    fn = getattr(profiling, "window", None)
    return fn(ctx["window_s"]) if fn is not None else None


def ms_per_batch(ctx, name: str, off_cpu: bool = False):
    """Span `name`'s wall time (less its thread CPU time with `off_cpu`)
    per batch the pump claimed (`pump.batch`'s count), in ms."""
    w = window(ctx)
    if not w:
        return None
    batches = w["spans"].get("pump.batch", {}).get("n", 0)
    s = w["spans"].get(name)
    if batches < 1 or not s or not s["n"]:
        return None
    wall = s["s"] - s["cpu_s"] if off_cpu else s["s"]
    return wall / batches * 1e3


def queue_ms(ctx):
    """The native front's mean queue wait of a claimed request, in ms."""
    w = window(ctx)
    if not w:
        return None
    n = w["counters"].get("front.queue_waits", 0)
    return w["counters"]["front.queue_wait_ns"] / n / 1e6 if n >= 1 else None

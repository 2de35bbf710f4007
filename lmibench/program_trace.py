"""The program's own spans and counters in a traced run's window, for the
per-layer metrics that read them (`metrics/*.py`).

The second module of the benchmark that imports the program, after
`system.py`. While a torch profiler records (the ``--trace 1`` window),
`tpulmi_torch.utils.profiling` keeps each span of the program as
``(name, request_id, parent, thread_id, start_ns, end_ns)`` on the host's
wall clock, the clock to which `tracing.device_trace` converts the
device's intervals, and stamps each increment of its counters. A program
without them reads nothing: every function here then returns None, and
the metric is left out of the line.
"""

from lmibench.stats import union_length


def _profiling():
    """The program's span and counter registry, or None."""
    try:
        from tpulmi_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "records") and hasattr(profiling, "counters")):
        return None
    return profiling


def records(ctx, name: str = None):
    """The program's span records (of `name`, when given) that overlap the
    window; None where the program keeps none there."""
    prof = _profiling()
    if prof is None:
        return None
    lo, hi = ctx.window_ns
    out = [r for r in prof.records()
           if r[4] < hi and r[5] > lo and (name is None or r[0] == name)]
    return out or None


def seconds(ctx, name: str):
    """Seconds of the window inside `name`'s spans; a span inside another
    of the same name (a split batch's parts) counts once."""
    recs = records(ctx, name)
    if recs is None:
        return None
    lo, hi = ctx.window_ns
    return union_length([(r[4], r[5]) for r in recs], lo, hi) / 1e9


def window_pct(ctx, name: str):
    """`seconds` as a percent of the window."""
    secs = seconds(ctx, name)
    if secs is None:
        return None
    lo, hi = ctx.window_ns
    return 100.0 * secs * 1e9 / (hi - lo)


def idle_inside_pct(ctx, name: str):
    """Percent of the window in which the device ran nothing (no kernel,
    copy or set on any stream, as `readers.device_idle_pct`) while the
    host was inside `name`'s spans: |spans u busy| - |busy|."""
    recs = records(ctx, name)
    if recs is None or not ctx.events:
        return None
    lo, hi = ctx.window_ns
    busy = [(s, e) for _, _, s, e in ctx.events]
    spans = [(r[4], r[5]) for r in recs]
    idle = union_length(spans + busy, lo, hi) - union_length(busy, lo, hi)
    return 100.0 * idle / (hi - lo)


def counter_growth(ctx, name: str):
    """How much the program's counter `name` grew inside the window (its
    increments stamped there); None where it did not grow."""
    prof = _profiling()
    if prof is None:
        return None
    lo, hi = ctx.window_ns
    return prof.counters(lo, hi).get(name) or None

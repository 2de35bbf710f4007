"""Arithmetic that several metric readers share (`metrics/<name>.py`)."""

import re

import numpy as np

from lmibench.stats import percentile, union_length


def device_idle_pct(ctx):
    """Percent of the traced window in which nothing ran on the device:
    no kernel, copy or set on any stream (the union of their intervals)."""
    if not ctx.events:
        return None
    lo, hi = ctx.window_ns
    busy = union_length([(s, e) for _, _, s, e in ctx.events], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def family_seconds(ctx, family: str):
    """Device seconds of the kernels of `family` (the patterns of its
    `kernels/*.json` files) inside the window, overlaps counted once."""
    patterns = [re.compile(p) for p in ctx.kernel_patterns(family)]
    lo, hi = ctx.window_ns
    spans = [(s, e) for name, kind, s, e in ctx.events
             if kind == "kernel" and any(p.search(name) for p in patterns)]
    return union_length(spans, lo, hi) / 1e9 if spans else None


def roofline_pct(ctx, family: str):
    """Least time of the window's work over its kernels' device time."""
    secs = family_seconds(ctx, family)
    if not secs or ctx.work is None or ctx.work.ops == 0:
        return None
    peaks = ctx.peaks
    least = ctx.work.least_seconds(peaks[ctx.config["work"]["ops_peak"]],
                                   peaks["hbm_bytes_per_s"])
    return 100.0 * least / secs


def latencies_s(served):
    """Each request's latency from its due time; never answered: +inf."""
    due = np.array([r.due for r in served.requests])
    lat = served.end - due
    return np.where(np.isnan(lat), np.inf, lat)


def p95_ms(served):
    lat = latencies_s(served)
    if not len(lat):
        return None
    p95 = percentile(lat, 95)
    return p95 * 1e3 if np.isfinite(p95) else None

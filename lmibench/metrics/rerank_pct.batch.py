"""rerank_pct.batch: the host rerank's span (LearnedIndex._rerank_host,
host clock) summed over the window, as a percent of the window."""


def read(ctx):
    spans = ctx.spans
    if spans is None or "rerank_host" in spans.missing:
        return None
    lo, hi = ctx.window_ns
    secs = spans.total_s("rerank_host", lo, hi)
    return 100.0 * secs / ((hi - lo) / 1e9) if secs > 0 else None

"""rerank_card_pct.batch: the device seconds of the `rerank` family's
kernels (`kernels/rerank.json`: the exact float16 rerank on the card) in
the traced window, as a percent of it. Nothing to read where the rerank
runs on the host. Moves qps."""

from lmibench.readers import family_seconds


def read(ctx):
    secs = family_seconds(ctx, "rerank")
    if secs is None:
        return None
    lo, hi = ctx.window_ns
    return 100.0 * secs / ((hi - lo) / 1e9)

"""rerank_dot_pct.batch: the program's `rerank.dot` spans (the host
rerank's candidate dot products: the native `rerank_dot`, or the gather
and `bmm`) in the traced window, as a percent of it. Moves qps."""

from lmibench.program_trace import window_pct


def read(ctx):
    return window_pct(ctx, "rerank.dot")

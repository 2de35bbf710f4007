"""rerank_dot_gbps.batch: the rows the host rerank's dot products read in
the traced window (the growth of the program's `rerank_bytes` counter:
candidates x d x the source's element size) over the seconds of its
`rerank.dot` spans, in GB/s. Moves qps."""

from lmibench.program_trace import counter_growth, seconds


def read(ctx):
    read_bytes = counter_growth(ctx, "rerank_bytes")
    secs = seconds(ctx, "rerank.dot")
    if not read_bytes or not secs:
        return None
    return read_bytes / secs / 1e9

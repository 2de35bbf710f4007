"""probe_roofline_pct: the least time of the window's probe work (the
benchmark's work model over the built buckets and one routing of each
request) as a percent of the probe family's kernel time in the trace."""

from lmibench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "probe")

"""dispatch_pct.batch: the program's `search.program` spans (routing, slot
grouping, the probe's launches and the merge, queued on the card) in the
traced window, as a percent of it. Moves qps."""

from lmibench.program_trace import window_pct


def read(ctx):
    return window_pct(ctx, "search.program")

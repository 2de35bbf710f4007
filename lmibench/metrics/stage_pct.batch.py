"""stage_pct.batch: the program's `search.stage` spans (the pageable copies
of a request's host float32 queries to the card) in the traced window, as
a percent of it. Moves qps."""

from lmibench.program_trace import window_pct


def read(ctx):
    return window_pct(ctx, "search.stage")

"""fetch_wait_pct.batch: the program's `search.fetch` spans (the host
waiting for the card's results and copying them back) in the traced
window, as a percent of it. Moves qps."""

from lmibench.program_trace import window_pct


def read(ctx):
    return window_pct(ctx, "search.fetch")

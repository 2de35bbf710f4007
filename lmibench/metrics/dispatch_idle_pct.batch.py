"""dispatch_idle_pct.batch: percent of the traced window in which the card
ran nothing (union over streams) while the host was inside the program's
`search.program` spans: the device waiting on dispatch. Moves qps."""

from lmibench.program_trace import idle_inside_pct


def read(ctx):
    return idle_inside_pct(ctx, "search.program")

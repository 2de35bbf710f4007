"""qps: queries answered in the window over the window's seconds (host
clock; a search ends with its results on the host). Closed loops only."""

import numpy as np


def read(ctx):
    served = ctx.served
    if served.lateness is not None or served.window_s <= 0:
        return None
    answered = sum(len(r.queries) for r, e in zip(served.requests,
                                                   served.end)
                   if not np.isnan(e))
    return answered / served.window_s

"""latency_p95_ms: the 95th percentile, nearest rank, over every request
due in the window, each from its due time to its results on the host; a
request never answered lies past every answer. Open loops only."""

from lmibench.readers import p95_ms


def read(ctx):
    if ctx.served.lateness is None:
        return None
    return p95_ms(ctx.served)

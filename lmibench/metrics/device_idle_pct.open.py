"""device_idle_pct.open: percent of the traced window of an open loop in
which the card ran nothing (union over streams). Moves latency_p95_ms."""

from lmibench.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)

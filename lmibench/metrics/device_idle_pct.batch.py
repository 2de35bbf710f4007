"""device_idle_pct.batch: percent of the traced window of a closed loop in
which the card ran nothing (union over streams). Moves qps."""

from lmibench.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)

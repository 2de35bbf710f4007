"""build_calibrate_s: the calibration of a hierarchical index's outer
weight at its probe budget, after the store is built, as the program
times it (`HierarchicalIndex.last_build_stages["calibrate"]`, the span
`hier.calibrate`). Moves setup_s."""


def read(ctx):
    return ctx.build_stages.get("calibrate")

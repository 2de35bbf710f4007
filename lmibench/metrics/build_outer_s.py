"""build_outer_s: the outer router's build (k-means over the groups,
training, the groups of every row) of a hierarchical index, as the
program times it (`HierarchicalIndex.last_build_stages["outer"]`, the
span `hier.outer`). Part of `build_nav_s`; moves setup_s."""


def read(ctx):
    return ctx.build_stages.get("outer")

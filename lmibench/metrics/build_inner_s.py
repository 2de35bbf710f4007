"""build_inner_s: the inner routers' builds of a hierarchical index, one
per group, one after another, as the program times them
(`HierarchicalIndex.last_build_stages["inner"]`, the span `hier.inner`).
Part of `build_nav_s`; moves setup_s."""


def read(ctx):
    return ctx.build_stages.get("inner")

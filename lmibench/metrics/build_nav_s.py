"""build_nav_s: the navigation stages of a host-store build (k-means,
router training, predict), as the program times them
(`LearnedIndex.last_build_stages["nav"]`)."""


def read(ctx):
    return ctx.build_stages.get("nav")

"""index_build_s: the host clock around the index build, from the
benchmark's generated host arrays to an index ready for search (the card
synchronized), once a run, in set-up. A per-layer reading beside
`setup_s`, which holds it: the build trains the router one small step at
a time, so its time follows the host's speed from run to run."""


def read(ctx):
    return ctx.build_s

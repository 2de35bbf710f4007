"""recall_at_10: over every answer kept for the check (in a closed loop
the first pass through the ring's orders and a share of the rest drawn
from the seed; in an open loop every request), the mean share of its exact
cosine top-10 (the plain reference's) that it returned."""


def read(ctx):
    return ctx.verdict["recall"]

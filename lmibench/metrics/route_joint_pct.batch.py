"""route_joint_pct.batch: the program's `route.joint` spans (the
hierarchical router's outer and inner MLPs and their (Q, G*C) joint
scores, queued on the card) in the traced window, as a percent of it.
Moves qps."""

from lmibench.program_trace import window_pct


def read(ctx):
    return window_pct(ctx, "route.joint")

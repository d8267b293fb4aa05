"""Planner self time: the median, over the window's plans, of
``plan_query``'s wall time less the time spent inside its calls into the
coalescer (the MLP, KV-batch's calibration and the planner's host work)."""

import numpy as np


def read(ctx):
    own = [(r.end - r.start - r.coal_s) * 1e3 for r in ctx.requests if r.ok]
    return float(np.median(own)) if own else None

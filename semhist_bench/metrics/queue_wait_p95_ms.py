"""The coalescer's queue wait: the 95th percentile of the registry's
``serve.queue_wait_ms`` observations made in the window (from a
predicate's submit to its window's flush)."""

import numpy as np


def read(ctx):
    vals = ctx.hists.get("serve.queue_wait_ms")
    if vals is None or not len(vals):
        return None
    return float(np.percentile(vals, 95))

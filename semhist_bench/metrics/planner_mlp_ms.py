"""The specificity MLP's time a plan, in ms: the window's increase of the
program's ``planner.mlp_ns`` over its ``planner.plans`` (the MLP's
launches and the copy of its thresholds, with the copy's wait behind
earlier work on the stream)."""


def read(ctx):
    c = ctx.counters
    if not c.get("planner.plans") or "planner.mlp_ns" not in c:
        return None
    return c["planner.mlp_ns"] / c["planner.plans"] / 1e6

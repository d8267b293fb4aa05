"""KV-batch's threshold calibration a plan, in ms: the window's increase of
the program's ``planner.calibration_ns`` over its ``planner.plans`` (the
sample's distances, ``Corpus.vlm_answer`` on the sample and the threshold
search, host work under the GIL)."""


def read(ctx):
    c = ctx.counters
    if not c.get("planner.plans") or "planner.calibration_ns" not in c:
        return None
    return c["planner.calibration_ns"] / c["planner.plans"] / 1e6

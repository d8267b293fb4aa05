"""``Corpus.vlm_answer``'s time a plan, in ms, nested inside the
calibration: the window's increase of the program's
``planner.vlm_answer_ns`` over its ``planner.plans``."""


def read(ctx):
    c = ctx.counters
    if not c.get("planner.plans") or "planner.vlm_answer_ns" not in c:
        return None
    return c["planner.vlm_answer_ns"] / c["planner.plans"] / 1e6

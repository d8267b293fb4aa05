"""How late a waiting planner resumes once its flush has set the result,
in ms: the window's increase of the program's ``coalescer.wake_ns`` over
its ``coalescer.blocked_wakes``, the waits that blocked until their flush
set the result (the hand-off of the result to the waiting threads, under
the GIL; a wait whose result was set before it began hands nothing off)."""


def read(ctx):
    c = ctx.counters
    if not c.get("coalescer.blocked_wakes") or "coalescer.wake_ns" not in c:
        return None
    return c["coalescer.wake_ns"] / c["coalescer.blocked_wakes"] / 1e6

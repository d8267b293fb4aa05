"""The share, in percent, of the plans' host-only phases (the text draw and
the calibration) that their thread spent on the CPU: the window's increase
of the program's ``planner.host_cpu_ns`` over that of ``planner.embed_ns``
and ``planner.calibration_ns``. The rest is waiting, mostly for the GIL."""


def read(ctx):
    c = ctx.counters
    if "planner.host_cpu_ns" not in c:
        return None
    host = c.get("planner.embed_ns", 0) + c.get("planner.calibration_ns", 0)
    if not host:
        return None
    return 100.0 * c["planner.host_cpu_ns"] / host

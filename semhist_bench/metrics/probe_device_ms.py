"""The probe's device time a launch, in ms: the window's increase of the
program's ``probe.device_ns`` (a CUDA event pair the kernel records around
each successful probe that is one launch) over its ``probe.device_timed``,
the probes so timed."""


def read(ctx):
    c = ctx.counters
    if not c.get("probe.device_timed") or "probe.device_ns" not in c:
        return None
    return c["probe.device_ns"] / c["probe.device_timed"] / 1e6

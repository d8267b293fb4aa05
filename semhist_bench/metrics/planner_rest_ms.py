"""The rest of a plan's wall time, in ms: the program's ``planner.wall_ns``
less its ``probe_ns``, ``mlp_ns`` and ``calibration_ns``, over its
``planner.plans`` in the window: the text draw, the ordering, the
machinery's lock and every wait between the phases."""

PARTS = ("planner.wall_ns", "planner.probe_ns", "planner.mlp_ns",
         "planner.calibration_ns")


def read(ctx):
    c = ctx.counters
    if not c.get("planner.plans") or any(k not in c for k in PARTS):
        return None
    wall, probe, mlp, cal = (c[k] for k in PARTS)
    return (wall - probe - mlp - cal) / c["planner.plans"] / 1e6

"""Coalescing: predicates a probe launch scored, from the registry's
``coalescer.predicates_probed`` and ``coalescer.probes_fired`` over the
window."""


def read(ctx):
    fired = ctx.counters.get("coalescer.probes_fired", 0)
    if not fired:
        return None
    return ctx.counters.get("coalescer.predicates_probed", 0) / fired

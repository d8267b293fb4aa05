"""Coalescing: the share of the window's probe launches whose batch an idle
flusher took as its first predicates came, so that they waited behind no
flush: the program's ``coalescer.idle_flushes`` over its
``coalescer.probes_fired``. Nothing where the program keeps no such count."""


def read(ctx):
    c = ctx.counters
    if not c.get("coalescer.probes_fired") or "coalescer.idle_flushes" not in c:
        return None
    return c["coalescer.idle_flushes"] / c["coalescer.probes_fired"]

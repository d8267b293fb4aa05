"""Telemetry subsystem: metrics registry, trace spans, q-error accounting.

The serving stack's sensor layer, host-side Python and numpy: a copy of the
reference's ``repro.obs`` with its schema, so one reader of
``--metrics-json`` and ``--trace-out`` serves both (docs/observability.md):

  * ``MetricsRegistry`` — thread-safe counters / gauges / exact-
    percentile histograms; every subsystem's counters live here (one
    source of truth for ``stats()``, the exit summary, and
    ``--metrics-json``).
  * ``Tracer`` — sampled JSONL per-request trace spans
    (``serve --trace-out PATH --trace-sample N``).
  * ``ObsHub`` — the single handle (registry + tracer) threaded through
    coalescer / serve / chaos / index / plan execution.
  * ``report`` — the canonical snapshot schema and the unified exit
    renderer.

Telemetry observes host-side only — it never touches probe inputs,
shapes, or device buffers, so probe results are bitwise identical with
telemetry on or off (held by tests/test_torch_obs.py).
"""

from repro_torch.obs.hub import ObsHub
from repro_torch.obs.registry import (
    LATENCY_MS_EDGES,
    QERROR_EDGES,
    SECONDS_EDGES,
    UNIT_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import Tracer, get_flush_ctx, set_flush_ctx

__all__ = [
    "ObsHub", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "Tracer", "get_flush_ctx", "set_flush_ctx",
    "LATENCY_MS_EDGES", "QERROR_EDGES", "SECONDS_EDGES", "UNIT_EDGES",
]

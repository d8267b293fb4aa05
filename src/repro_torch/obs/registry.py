"""Thread-safe metrics registry: counters, gauges, exact-percentile
latency histograms.

Design constraints (docs/observability.md):

  * **low-overhead hot path** — a counter ``inc`` is one striped-lock
    acquire + an int add; a histogram ``observe`` appends into a
    preallocated numpy buffer (amortized allocation-free: the buffer
    doubles like a vector). No dict lookups on the hot path — callers
    hold the metric handle, not the name.
  * **lock striping** — metrics share a small pool of locks keyed by
    metric name, so unrelated subsystems (coalescer counters vs index
    gauges) never contend on one global lock, while one metric's
    updates stay atomic.
  * **exact percentiles** — histograms keep every raw observation (the
    serving runs this instruments are bounded: one value per request /
    flush / rebuild), so ``snapshot()`` reports *exact* p50/p95/p99 via
    ``np.percentile``, while the fixed log-spaced bucket edges give a
    stable export schema for dashboards and the check_bench gate.

Everything here is plain host-side Python/numpy — nothing touches probe
inputs, shapes, or device buffers, which is how bitwise probe parity
under full telemetry is preserved *by construction*.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_MS_EDGES", "QERROR_EDGES", "SECONDS_EDGES",
           "UNIT_EDGES"]


def _geom_edges(lo: float, hi: float, per_decade: int) -> tuple:
    """Log-spaced bucket upper edges covering [lo, hi]."""
    import math

    k0 = round(math.log10(lo) * per_decade)
    k1 = round(math.log10(hi) * per_decade)
    return tuple(10.0 ** (k / per_decade) for k in range(k0, k1 + 1))


# 0.01ms .. 100s, 4 buckets/decade: wall-time phases (queue/probe/combine)
LATENCY_MS_EDGES = _geom_edges(1e-2, 1e5, 4)
# 1.0 .. 1e4, 8 buckets/decade: q-error is >= 1 by definition
QERROR_EDGES = _geom_edges(1.0, 1e4, 8)
# 1ms .. 1000s: rebuild durations
SECONDS_EDGES = _geom_edges(1e-3, 1e3, 4)
# 1e-4 .. 1: selectivity-interval widths (unit range)
UNIT_EDGES = _geom_edges(1e-4, 1.0, 4)

_N_STRIPES = 16


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last-value (or running-max) float gauge."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def record_max(self, v: float) -> None:
        with self._lock:
            if v > self._v:
                self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Exact-percentile histogram with fixed export buckets.

    ``observe`` appends the raw value into a doubling preallocated
    buffer (amortized O(1), no per-call allocation); ``summary`` sorts
    once and reports exact percentiles plus per-bucket counts against
    the fixed ``edges``.
    """

    __slots__ = ("name", "edges", "_lock", "_buf", "_n")

    def __init__(self, name: str, lock: threading.Lock,
                 edges: tuple = LATENCY_MS_EDGES):
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        self._lock = lock
        self._buf = np.empty(256, np.float64)
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if self._n == len(self._buf):
                grown = np.empty(2 * len(self._buf), np.float64)
                grown[:self._n] = self._buf
                self._buf = grown
            self._buf[self._n] = v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def values(self) -> np.ndarray:
        with self._lock:
            return self._buf[:self._n].copy()

    def percentile(self, q: float) -> float:
        vals = self.values()
        return float(np.percentile(vals, q)) if len(vals) else 0.0

    def summary(self) -> dict:
        vals = self.values()
        if not len(vals):
            return {"count": 0}
        edges = np.asarray(self.edges)
        per_bucket, _ = np.histogram(vals, bins=np.concatenate(
            [[-np.inf], edges, [np.inf]]))
        # fold values below the lowest edge into the first bucket
        # (le = e0 means "<= e0"), so the counts always total ``count``
        per = per_bucket[1:].copy()
        per[0] += per_bucket[0]
        buckets = [[float(le), int(c)] for le, c in
                   zip(list(edges) + ["+inf"], per) if c]
        return {
            "count": int(len(vals)),
            "sum": float(vals.sum()),
            "min": float(vals.min()),
            "max": float(vals.max()),
            "p50": float(np.percentile(vals, 50)),
            "p95": float(np.percentile(vals, 95)),
            "p99": float(np.percentile(vals, 99)),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics over a striped lock pool.

    ``counter``/``gauge``/``histogram`` return the live metric handle —
    hot paths resolve the name ONCE at wiring time and then update the
    handle directly. ``snapshot()`` is the one read path: a plain
    schema-stable dict of every metric's current value.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        self._metrics: dict[str, object] = {}

    def _stripe(self, name: str) -> threading.Lock:
        return self._stripes[hash(name) % _N_STRIPES]

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._stripe(name), **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  edges: tuple = LATENCY_MS_EDGES) -> Histogram:
        return self._get_or_create(name, Histogram, edges=edges)

    def snapshot(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
        counters, gauges, hists = {}, {}, {}
        for name in sorted(metrics):
            m = metrics[name]
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                gauges[name] = m.value
            else:
                hists[name] = m.summary()
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

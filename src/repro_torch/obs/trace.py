"""Sampled JSONL trace spans for the serving pipeline.

One ``Tracer`` serializes pipeline spans to a JSONL file — one JSON
object per line, each with a ``kind``:

  * ``submit``  — one predicate request's resolution through the
    coalescer (resolution bucket, its submit time ``t_ns`` +
    queue-wait / probe / combine wall-time breakdown). Sampled: every
    ``sample``-th
    ``probe_outcomes`` call emits spans for ALL of its predicates
    (including error/abandoned ones), so at ``sample=1`` the per-
    resolution span counts equal the coalescer's reconciliation
    counters exactly.
  * ``flush``   — one micro-batch window flush (its start ``t_ns``,
    batch size — the B the probe took: nothing is padded —, probe
    wall time and, where the probe was one launch on a CUDA store, its
    device time ``device_ms``, combine time, retries, outcome).
    Unsampled — flushes are already
    ``requests / amortization`` rare.
  * ``scan``    — one index scan under a flush (rows scanned /
    full-scan-equivalent rows, per-shard breakdown when sharded),
    correlated to its flush span via the flush id carried in a
    thread-local (the flusher thread sets it around probe dispatch,
    so the index layer needs no signature changes).
  * ``event``   — control-plane events: retries, breaker transitions,
    chaos injections, flusher deaths/restarts, generation swaps.
  * ``plan``    — one executed query plan (sampled like ``submit``).
  * ``summary`` — final record: the coalescer's resolution totals plus
    the per-kind span counts, written from the same stats dict as
    ``--metrics-json``, so the three exports cannot drift.

``t_ns`` is ``time.perf_counter_ns``, the clock of the planner's phase
counters. Span schema details and tuning (``--trace-sample``):
docs/observability.md.
"""

from __future__ import annotations

import json
import threading

__all__ = ["Tracer", "set_flush_ctx", "get_flush_ctx"]

_ctx = threading.local()


def set_flush_ctx(flush_id) -> None:
    """Bind the current thread's in-progress flush id (None clears)."""
    _ctx.flush_id = flush_id


def get_flush_ctx():
    """The flush id bound on this thread, or None outside a flush."""
    return getattr(_ctx, "flush_id", None)


class Tracer:
    """Thread-safe JSONL span writer with per-kind 1-in-N sampling."""

    def __init__(self, path: str, *, sample: int = 1):
        if sample < 1:
            raise ValueError(f"sample must be >= 1, got {sample}")
        self.path = path
        self.sample = int(sample)
        self._lock = threading.Lock()
        self._f = open(path, "w", encoding="utf-8")
        self._closed = False
        self._next_id = 0
        self._sample_seen: dict[str, int] = {}
        self.emitted = 0
        self._by_kind: dict[str, int] = {}
        self._submit_by_resolution: dict[str, int] = {}

    def next_id(self) -> int:
        """Monotonic correlation id (trace / flush ids)."""
        with self._lock:
            self._next_id += 1
            return self._next_id

    def sample_hit(self, kind: str) -> bool:
        """True on every ``sample``-th call for this kind (1st included)."""
        with self._lock:
            seen = self._sample_seen.get(kind, 0)
            self._sample_seen[kind] = seen + 1
            return seen % self.sample == 0

    def emit(self, kind: str, **fields) -> None:
        rec = {"kind": kind, **fields}
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            if self._closed:
                return
            self._f.write(line + "\n")
            self.emitted += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            if kind == "submit":
                res = fields.get("resolution", "?")
                self._submit_by_resolution[res] = (
                    self._submit_by_resolution.get(res, 0) + 1)

    def span_counts(self) -> dict:
        with self._lock:
            return dict(self._by_kind)

    def submit_counts(self) -> dict:
        """Emitted ``submit`` spans per resolution bucket."""
        with self._lock:
            return dict(self._submit_by_resolution)

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

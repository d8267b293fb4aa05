"""A plan-scoped phase clock: where one ``plan_query`` spends its time.

``plan_query`` binds a ``PhaseClock`` on its thread when its coalescer
carries a telemetry hub, the way the coalescer binds its flush id
(``repro_torch.obs.trace.set_flush_ctx``); the estimators open phases
around their own work, and ``plan_query`` hands the clock to the hub at the
plan's end. Nothing here imports ``repro_torch.obs``: the hub is reached
duck-typed (``obs.planner_phases(clock)``), so ``core`` keeps knowing
nothing of telemetry.

Phases, in ``time.perf_counter_ns`` nanoseconds, summed over the plan:

  * ``embed``       — ``_predicate_embeddings`` (the text draw);
  * ``mlp``         — the specificity MLP's thresholds, including the wait
                      for its copy behind earlier work on the stream;
  * ``calibration`` — KV-batch's threshold calibration, and nested inside
                      it ``vlm_answer``, the calls to ``Corpus.vlm_answer``;
  * ``probe``       — the plan's time inside the coalescer;
  * ``wall``        — the whole ``plan_query``.

``embed`` and ``calibration`` are host work alone, so they also take the
thread's CPU time (``time.thread_time_ns``) into ``host_cpu``: their wall
less that is time spent waiting, mostly for the GIL. Besides the times,
two counts: ``Corpus.vlm_answer``'s calls, and those of them that built a
dense mask of every row rather than searching the match list.

Unbound, ``phase`` returns a shared no-op context after one thread-local
read. Where ``torch.profiler`` records the calling thread, every phase also
opens a ``record_function`` range named ``planner.<phase>``, so the device
trace carries the program's spans on its own clock (``profiled_range``; the
coalescer opens ``coalescer.flush`` the same way). A profiler records only
the thread that started it, unless it is an ``EveryThreadProfile``: the
planners and the flusher are threads of their own, so their ranges show
only under one.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["PHASES", "EveryThreadProfile", "PhaseClock", "bind", "current",
           "phase", "profiled_range"]

PHASES = ("embed", "mlp", "calibration", "vlm_answer", "probe", "wall")

_tls = threading.local()
_NULL = contextlib.nullcontext()
_every_thread = False      # an EveryThreadProfile is recording


class PhaseClock:
    """Nanoseconds per phase of one plan, the host CPU time of its
    host-only phases, and its ``vlm_answer`` calls (all, and dense)."""

    __slots__ = ("ns", "host_cpu_ns", "vlm_answer_calls", "vlm_answer_dense")

    def __init__(self):
        self.ns = dict.fromkeys(PHASES, 0)
        self.host_cpu_ns = 0
        self.vlm_answer_calls = 0
        self.vlm_answer_dense = 0


def bind(clock: PhaseClock | None) -> None:
    """Bind ``clock`` on the calling thread (None unbinds)."""
    _tls.clock = clock


def current() -> PhaseClock | None:
    """The clock bound on the calling thread, or None."""
    return getattr(_tls, "clock", None)


class EveryThreadProfile(torch.profiler.profile):
    """A ``torch.profiler.profile`` that records every thread of the
    process, during which every thread's phases and flushes open their
    ranges."""

    def __init__(self, **kwargs):
        super().__init__(
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True), **kwargs)

    def start(self):
        global _every_thread
        super().start()
        _every_thread = True

    def stop(self):
        global _every_thread
        _every_thread = False
        super().stop()


def profiled_range(name: str):
    """A ``record_function`` range named ``name`` where the profiler
    records the calling thread, else the shared no-op context. A range
    costs microseconds even where nothing records it, so it is opened only
    under an ``EveryThreadProfile`` or on the thread that started a
    profiler (``torch.autograd.profiler._is_profiler_enabled`` is set for
    every thread, and the thread-local ``_profiler_enabled()`` is false
    on every thread of a profiler of all threads)."""
    if _every_thread or (torch.autograd.profiler._is_profiler_enabled
                         and torch._C._autograd._profiler_enabled()):
        return torch.profiler.record_function(name)
    return _NULL


_RANGES = {p: f"planner.{p}" for p in PHASES}


class _Phase:
    __slots__ = ("clock", "name", "cpu", "rf", "t0", "c0")

    def __init__(self, clock: PhaseClock, name: str, cpu: bool):
        self.clock, self.name, self.cpu = clock, name, cpu

    def __enter__(self):
        self.rf = profiled_range(_RANGES[self.name])
        self.rf.__enter__()
        if self.cpu:
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        clock = self.clock
        clock.ns[self.name] += t1 - self.t0
        if self.cpu:
            clock.host_cpu_ns += time.thread_time_ns() - self.c0
        self.rf.__exit__(*exc)
        return False


def phase(name: str, *, cpu: bool = False):
    """Time the ``with`` body into phase ``name`` of the bound clock (and
    its thread CPU time into ``host_cpu`` with ``cpu``); a no-op unbound."""
    clock = getattr(_tls, "clock", None)
    if clock is None:
        return _NULL
    return _Phase(clock, name, cpu)

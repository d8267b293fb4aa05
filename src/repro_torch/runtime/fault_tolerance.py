"""Fault tolerance for the serving control plane (host-side, device-free).

A copy of the reference's ``repro/runtime/fault_tolerance.py`` vocabulary
that the predicate coalescer uses:

  * StepWatchdog      — per-step deadline from a running latency EWMA;
                        classifies steps as ok / straggler / stuck
  * FaultPolicy       — classifies exceptions transient vs fatal (retry vs
                        fail); ``TransientError`` is the marker base for
                        injected/recoverable faults
  * RetryPolicy       — bounded retries with exponential backoff around any
                        callable; drives the coalescer's probe dispatch
  * CircuitBreaker    — closed / open / half-open latch over a failing
                        dependency; serving degrades to bound-only answers
                        while the breaker is open instead of queueing retries

  * HeartbeatRegistry — last-beat times per host; the replicated fleet's
                        liveness monitor reads ``fresh``
  * FaultTolerantRunner — drives train steps: retries, then restores the
                        last checkpoint; the watchdog; periodic async
                        checkpoints
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


class TransientError(RuntimeError):
    """Marker base for failures that are expected to succeed on retry.

    Injected chaos faults and recoverable dependency errors derive from
    this; ``FaultPolicy`` treats anything else as fatal by default.
    """


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Classifies exceptions into transient (retry) vs fatal (fail).

    The default vocabulary covers the marker class plus the stdlib types a
    remote probe dependency realistically throws; a CUDA launch error is a
    ``RuntimeError`` and so fatal: the coalescer does not retry it.
    """

    transient_types: tuple = (TransientError, TimeoutError, ConnectionError)

    def transient(self, exc: BaseException) -> bool:
        return isinstance(exc, self.transient_types)

    def classify(self, exc: BaseException) -> str:
        return "transient" if self.transient(exc) else "fatal"


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff.

    ``call`` retries transient failures (per ``policy``) up to
    ``max_retries`` times, sleeping ``base_delay_s * multiplier**attempt``
    (capped at ``max_delay_s``) between attempts. Fatal errors and
    exhaustion re-raise the last exception. ``sleep`` is injectable so
    tests run at full speed.
    """

    max_retries: int = 2
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    policy: FaultPolicy = dataclasses.field(default_factory=FaultPolicy)
    on_retry: Callable | None = None    # default (attempt, exc) observer;
    #                                     a per-call on_retry overrides it

    def delay_s(self, attempt: int) -> float:
        return min(self.base_delay_s * self.multiplier ** attempt,
                   self.max_delay_s)

    def call(self, fn: Callable, *args, on_retry: Callable | None = None,
             sleep: Callable[[float], None] = time.sleep, **kwargs):
        if on_retry is None:
            on_retry = self.on_retry
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if on_retry is not None:
                    on_retry(attempt, e)
                if not self.policy.transient(e) or attempt >= self.max_retries:
                    raise
                d = self.delay_s(attempt)
                if d > 0:
                    sleep(d)
        raise AssertionError("unreachable")  # pragma: no cover


class CircuitBreaker:
    """Closed / open / half-open latch over a flaky dependency.

    ``failure_threshold`` consecutive failures trip the breaker open;
    while open, ``allow()`` returns False until ``cooldown_s`` elapses,
    then lets exactly one half-open trial through. A trial success closes
    the breaker; a trial failure re-opens it (restarting the cooldown).
    ``is_open`` is a non-consuming read for fast-path checks (it never
    starts a trial). ``clock`` is injectable for deterministic tests.
    ``on_transition(old, new)`` observes every state change (fired
    OUTSIDE the breaker lock, so observers may take their own locks);
    the serving coalescer wires it to the telemetry event stream.
    Thread-safe.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 30.0,
                 *, clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str, str], None] | None = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self.state = "closed"           # closed | open | half-open
        self.failures = 0               # consecutive
        self.opens = 0
        self._opened_at = 0.0

    def _fire(self, transition: tuple | None) -> None:
        cb = self.on_transition
        if cb is not None and transition is not None:
            cb(*transition)

    @property
    def is_open(self) -> bool:
        """Non-consuming: True only while open and still cooling down."""
        with self._lock:
            return (self.state == "open"
                    and self.clock() - self._opened_at < self.cooldown_s)

    def allow(self) -> bool:
        """Consuming check: open + cooldown elapsed admits one trial."""
        fire = None
        with self._lock:
            if self.state == "closed":
                out = True
            elif self.state == "open":
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self.state = "half-open"
                    fire = ("open", "half-open")
                    out = True
                else:
                    out = False
            else:
                out = True              # half-open: trial in progress
        self._fire(fire)
        return out

    def record_success(self) -> None:
        with self._lock:
            old = self.state
            self.failures = 0
            self.state = "closed"
        self._fire((old, "closed") if old != "closed" else None)

    def record_failure(self) -> None:
        fire = None
        with self._lock:
            self.failures += 1
            if (self.state == "half-open"
                    or self.failures >= self.failure_threshold):
                if self.state != "open":
                    self.opens += 1
                    fire = (self.state, "open")
                self.state = "open"
                self._opened_at = self.clock()
        self._fire(fire)

    def stats(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "opens": self.opens}


@dataclasses.dataclass
class StepWatchdog:
    """EWMA-based step-latency watchdog (straggler mitigation)."""

    alpha: float = 0.1
    straggler_factor: float = 2.0
    stuck_factor: float = 10.0
    ewma_s: float | None = None
    stragglers: int = 0

    def observe(self, step_s: float) -> str:
        if self.ewma_s is None:
            self.ewma_s = step_s
            return "ok"
        verdict = "ok"
        if step_s > self.stuck_factor * self.ewma_s:
            verdict = "stuck"
        elif step_s > self.straggler_factor * self.ewma_s:
            verdict = "straggler"
            self.stragglers += 1
        # stragglers should not poison the baseline
        w = self.alpha if verdict == "ok" else self.alpha * 0.1
        self.ewma_s = (1 - w) * self.ewma_s + w * step_s
        return verdict

    def deadline(self) -> float | None:
        return None if self.ewma_s is None else self.stuck_factor * self.ewma_s


@dataclasses.dataclass
class HeartbeatRegistry:
    timeout_s: float = 60.0
    last_seen: dict = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: float | None = None):
        self.last_seen[host] = time.time() if now is None else now

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.time() if now is None else now
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]

    def age_s(self, host: int, now: float | None = None) -> float | None:
        """Seconds since the host's last beat (None if it never beat)."""
        t = self.last_seen.get(host)
        if t is None:
            return None
        return (time.time() if now is None else now) - t

    def fresh(self, host: int, now: float | None = None) -> bool:
        """True while the host has beaten within ``timeout_s``. A host that
        never beat is not fresh: the fleet router beats every replica once
        at construction, so an all-False start means no monitor was wired
        up."""
        age = self.age_s(host, now)
        return age is not None and age <= self.timeout_s


class FaultTolerantRunner:
    """Drives train steps with retry / restore-from-checkpoint semantics,
    as the reference's.

    Built on the ``RetryPolicy`` the serving coalescer uses; training
    treats every ``Exception`` as transient (a device fault surfaces as a
    generic error, and the live state supports a retry: the port's train
    step writes nothing until every gradient is in, so a step that raised
    left the state as it was) and restores the last checkpoint only when
    the retries are exhausted. ``ckpt`` is a ``CheckpointManager``; its
    ``save_async`` copies the state to the host before the next step
    writes it in place.
    """

    def __init__(self, step_fn: Callable, ckpt, *, max_retries: int = 2,
                 checkpoint_every: int = 50):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.max_retries = max_retries
        self.checkpoint_every = checkpoint_every
        self.retry_policy = RetryPolicy(
            max_retries=max_retries, base_delay_s=0.0,
            policy=FaultPolicy(transient_types=(Exception,)))
        self.watchdog = StepWatchdog()
        self.restores = 0
        self.retries = 0

    def _count_retry(self, attempt: int, exc: BaseException) -> None:
        self.retries += 1

    def run(self, state, batches, *, start_step: int = 0, on_metrics=None):
        step = start_step
        metrics = None
        for batch in batches:
            t0 = time.perf_counter()
            try:
                state, metrics = self.retry_policy.call(
                    self.step_fn, state, batch, on_retry=self._count_retry)
            except Exception:  # noqa: BLE001 - retries exhausted
                # fatal: roll back to the last durable state
                self.restores += 1
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                state = self.ckpt.restore(latest, like=state)
            verdict = self.watchdog.observe(time.perf_counter() - t0)
            if on_metrics:
                on_metrics(step, metrics, verdict)
            step += 1
            if step % self.checkpoint_every == 0:
                self.ckpt.save_async(step, state)
        self.ckpt.wait()
        return state, step

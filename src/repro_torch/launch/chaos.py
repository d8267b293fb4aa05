"""Deterministic fault injection for the serving control plane.

The chaos harness wraps the coalescer's probe dispatch with seed-driven
failures, delays, and flusher kills so robustness behavior (retries,
breaker trips, bound-only degradation, flusher-death propagation) is
exercised by *deterministic* tests and by ``serve --chaos``:

  * every probe launch consumes one draw from a seeded ``default_rng``
    under a lock, keyed by launch ordinal — the single flusher thread is
    the only consumer, so the fault sequence is a pure function of the
    seed regardless of submitter interleaving;
  * ``fail_rate`` raises ``ChaosProbeError`` (a ``TransientError``, so
    retry policies engage) *before* the real probe runs;
  * ``delay_rate``/``delay_ms`` sleeps before the probe (deadline and
    shedding paths);
  * ``kill_flusher_at=n`` raises ``FlusherKill`` on the n-th launch —
    it derives from ``BaseException`` precisely so the flush loop's
    ``except Exception`` fault handling does NOT catch it, faithfully
    simulating the flusher thread dying mid-window.

Spec strings (the ``--chaos`` flag) look like
``seed=1,fail=0.3,delay=0.2,delay-ms=5,kill-at=3``; omitted keys default
to off. The injector wraps the coalescer's ``_raw_probe``, so a fault
fires before the probe's locked scan + merge on the card, never inside
it: a kill never leaves the probe's scratch half-written. The fleet's
replica-scoped faults (``FleetChaos``) come with the fleet (ROADMAP M5).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.runtime.fault_tolerance import TransientError

__all__ = ["ChaosProbeError", "FlusherKill", "ChaosConfig", "ChaosInjector"]


class ChaosProbeError(TransientError):
    """Injected transient probe failure (retryable)."""


class FlusherKill(BaseException):
    """Injected flusher-thread death.

    Derives from ``BaseException`` so it escapes the flush loop's
    ``except Exception`` fault handling, exactly like a real thread-fatal
    condition would.
    """


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seed-driven fault plan; all rates in [0, 1], kill ordinal 1-based."""

    seed: int = 0
    fail_rate: float = 0.0
    delay_rate: float = 0.0
    delay_ms: float = 0.0
    kill_flusher_at: int = 0          # 0 = never; n kills the n-th launch

    def __post_init__(self):
        for name in ("fail_rate", "delay_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.delay_ms < 0:
            raise ValueError(f"delay_ms must be >= 0, got {self.delay_ms}")
        if self.kill_flusher_at < 0:
            raise ValueError(
                f"kill_flusher_at must be >= 0, got {self.kill_flusher_at}")

    @classmethod
    def parse(cls, spec: str) -> "ChaosConfig":
        """Parse a ``--chaos`` spec: ``seed=1,fail=0.3,delay-ms=5,...``."""
        keys = {"seed": ("seed", int), "fail": ("fail_rate", float),
                "delay": ("delay_rate", float),
                "delay-ms": ("delay_ms", float),
                "kill-at": ("kill_flusher_at", int)}
        kwargs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"chaos spec entry needs key=value: {part!r}")
            k, v = part.split("=", 1)
            if k not in keys:
                raise ValueError(
                    f"unknown chaos key {k!r} (known: {sorted(keys)})")
            field, conv = keys[k]
            kwargs[field] = conv(v)
        return cls(**kwargs)


class ChaosInjector:
    """Wraps a probe callable with the seeded fault plan.

    ``wrap(probe_fn)`` returns a callable with the same signature; each
    invocation draws the fault decisions for its launch ordinal under a
    lock, then (in order) kills, delays, fails, or runs the real probe.
    """

    def __init__(self, config: ChaosConfig, *, obs=None):
        self.cfg = config
        self.obs = obs       # telemetry hub (the coalescer fills it in)
        self._rng = np.random.default_rng(config.seed)
        self._lock = threading.Lock()
        self.launches = 0
        self.injected_failures = 0
        self.injected_delays = 0
        self.injected_kills = 0

    def wrap(self, probe_fn):
        def chaotic_probe(*args, **kwargs):
            with self._lock:
                self.launches += 1
                ordinal = self.launches
                u_fail, u_delay = self._rng.random(2)
                kill = (self.cfg.kill_flusher_at
                        and ordinal == self.cfg.kill_flusher_at)
                delay = u_delay < self.cfg.delay_rate and self.cfg.delay_ms > 0
                fail = u_fail < self.cfg.fail_rate
                if kill:
                    self.injected_kills += 1
                elif delay:
                    self.injected_delays += 1
                if not kill and fail:
                    self.injected_failures += 1
            # fault decisions become telemetry events (emitted OUTSIDE
            # the lock — the obs hub takes its own locks)
            obs = self.obs
            if obs is not None:
                if kill:
                    obs.event("chaos_kill", launch=ordinal)
                elif delay:
                    obs.event("chaos_delay", launch=ordinal,
                              delay_ms=self.cfg.delay_ms)
                if not kill and fail:
                    obs.event("chaos_fail", launch=ordinal)
            if kill:
                raise FlusherKill(
                    f"chaos: flusher killed at launch {ordinal}")
            if delay:
                time.sleep(self.cfg.delay_ms / 1e3)
            if fail:
                raise ChaosProbeError(
                    f"chaos: injected probe failure at launch {ordinal}")
            return probe_fn(*args, **kwargs)

        return chaotic_probe

    def stats(self) -> dict:
        with self._lock:
            return {
                "launches": self.launches,
                "injected_failures": self.injected_failures,
                "injected_delays": self.injected_delays,
                "injected_kills": self.injected_kills,
            }

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
replica-scoped faults (``FleetChaos``: kill, slow down or partition one
replica, keyed by fleet dispatch ordinal) fire in the router before a
dispatch reaches its replica.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.runtime.fault_tolerance import TransientError

__all__ = ["ChaosProbeError", "FlusherKill", "ChaosConfig", "ChaosInjector",
           "ReplicaPartitionedError", "FleetChaosConfig", "FleetChaos"]


class ChaosProbeError(TransientError):
    """Injected transient probe failure (retryable)."""


class ReplicaPartitionedError(TransientError):
    """Injected network partition: the dispatch never reached the replica.

    Transient so the fleet router's failover (and any retry policy) treats
    it like a real connectivity blip rather than a fatal fault.
    """


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


# ---------------------------------------------------------------- fleet

@dataclasses.dataclass(frozen=True)
class _FleetAction:
    """Fault decisions for one fleet dispatch (drawn under the lock)."""

    ordinal: int = 0
    kills: tuple = ()           # replica ids to kill before this dispatch
    delay_ms: float = 0.0       # injected slowness for this dispatch
    partitioned: bool = False   # raise instead of reaching the replica


@dataclasses.dataclass(frozen=True)
class FleetChaosConfig:
    """Replica-scoped fault plan for the fleet router.

    Faults key off the *fleet dispatch ordinal* — a counter the router
    bumps under one lock for every replica dispatch attempt — so the
    fault sequence is a pure function of the spec: the n-th dispatch
    always triggers the same fault, regardless of which request drew it
    or how submitter threads interleave. Spec entries (composable with
    the per-replica probe keys of ``ChaosConfig``, which then apply
    inside every replica with seed ``seed + rid``):

      * ``replica-kill=R@N``   — kill replica R just before dispatch N
      * ``replica-slow=R@N:MS``— dispatches to R from ordinal N on sleep
                                 MS milliseconds (injected straggler)
      * ``partition=R@A-B``    — dispatches to R with ordinal in [A, B]
                                 raise ``ReplicaPartitionedError``
                                 instead of reaching the replica
    """

    seed: int = 0
    kill_replica: int = -1          # replica id (-1 = never)
    kill_at: int = 0                # 1-based fleet dispatch ordinal
    slow_replica: int = -1
    slow_from: int = 0
    slow_ms: float = 0.0
    partition_replica: int = -1
    partition_lo: int = 0
    partition_hi: int = 0
    base: ChaosConfig | None = None  # per-replica probe-level faults

    FLEET_KEYS = ("replica-kill", "replica-slow", "partition")

    @classmethod
    def parse(cls, spec: str) -> "FleetChaosConfig":
        """Parse a ``--chaos`` spec into fleet + per-replica fault plans.

        Unknown-to-the-fleet keys are delegated to ``ChaosConfig.parse``
        so one spec string drives both layers:
        ``seed=1,replica-kill=1@6,fail=0.1``.
        """
        base_parts: list[str] = []
        kwargs: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"chaos spec entry needs key=value: {part!r}")
            k, v = part.split("=", 1)
            if k == "replica-kill":
                rid, at = v.split("@", 1)
                kwargs["kill_replica"] = int(rid)
                kwargs["kill_at"] = int(at)
            elif k == "replica-slow":
                rid, rest = v.split("@", 1)
                frm, ms = rest.split(":", 1)
                kwargs["slow_replica"] = int(rid)
                kwargs["slow_from"] = int(frm)
                kwargs["slow_ms"] = float(ms)
            elif k == "partition":
                rid, rng = v.split("@", 1)
                lo, hi = rng.split("-", 1)
                kwargs["partition_replica"] = int(rid)
                kwargs["partition_lo"] = int(lo)
                kwargs["partition_hi"] = int(hi)
            else:
                if k == "seed":
                    kwargs["seed"] = int(v)
                base_parts.append(part)
        base = (ChaosConfig.parse(",".join(base_parts))
                if any(not p.startswith("seed=") for p in base_parts)
                else None)
        return cls(base=base, **kwargs)


class FleetChaos:
    """Consumes the fleet fault plan one dispatch ordinal at a time.

    The router calls ``on_dispatch(rid)`` before every replica dispatch;
    the ordinal counter and all fault decisions live under one lock so
    concurrent submitters observe one global deterministic sequence.
    """

    def __init__(self, config: FleetChaosConfig, *, obs=None):
        self.cfg = config
        self.obs = obs
        self._lock = threading.Lock()
        self.dispatches = 0
        self.injected_kills = 0
        self.injected_slow = 0
        self.injected_partitions = 0

    def on_dispatch(self, rid: int) -> _FleetAction:
        cfg = self.cfg
        with self._lock:
            self.dispatches += 1
            ordinal = self.dispatches
            kills = ()
            if cfg.kill_at and ordinal == cfg.kill_at:
                kills = (cfg.kill_replica,)
                self.injected_kills += 1
            delay_ms = 0.0
            if (rid == cfg.slow_replica and cfg.slow_from
                    and ordinal >= cfg.slow_from and cfg.slow_ms > 0):
                delay_ms = cfg.slow_ms
                self.injected_slow += 1
            partitioned = (rid == cfg.partition_replica
                           and cfg.partition_lo
                           and cfg.partition_lo <= ordinal
                           <= cfg.partition_hi)
            if partitioned:
                self.injected_partitions += 1
        obs = self.obs
        if obs is not None:
            if kills:
                obs.event("chaos_replica_kill", dispatch=ordinal,
                          replica=kills[0])
            if delay_ms:
                obs.event("chaos_replica_slow", dispatch=ordinal,
                          replica=rid, delay_ms=delay_ms)
            if partitioned:
                obs.event("chaos_partition", dispatch=ordinal, replica=rid)
        return _FleetAction(ordinal=ordinal, kills=kills,
                            delay_ms=delay_ms, partitioned=bool(partitioned))

    def stats(self) -> dict:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "injected_kills": self.injected_kills,
                "injected_slow": self.injected_slow,
                "injected_partitions": self.injected_partitions,
            }

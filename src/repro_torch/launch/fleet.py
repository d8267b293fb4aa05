"""Replicated serving fleet: cache-affinity routing + health-checked
failover.

A port of the reference's ``repro/launch/fleet.py``. One serving replica
survives faults through its coalescer's control plane; this module runs R
independent replicas — each
with its own store handle, ``PredicateCoalescer``, ``PredicateCache`` and
circuit breaker — behind a router that preserves every single-replica
guarantee while adding fleet-level ones:

  * **cache-affinity routing** — a consistent-hash ring (``VnodeRing``,
    stable ``blake2b`` vnodes) over the *quantized predicate embedding*
    (the same quantization the predicate cache keys on), so all traffic
    for one hot predicate lands on one replica and the per-replica LRU
    caches **partition** the key space instead of duplicating it: fleet
    aggregate capacity is R small caches that together behave like one
    big one. ``routing="random"`` is kept as the duplicated-cache
    baseline the smoke measures against.
  * **health-checked failover** — a heartbeat monitor thread beats the
    shared ``HeartbeatRegistry`` for every live replica; routing skips
    replicas that are dead (flusher gone / killed), stale (missed
    heartbeats), breaker-open (breaker state propagates across the
    replica boundary via a non-consuming ``is_open`` read), or saturated
    (bounded per-replica queue feeding fleet-level admission). A skipped
    or failed primary falls over to the key's ring successor, so only
    the dead replica's keys remap (minimal disruption).
  * **hedged requests** — when ``hedge_ms > 0`` and a dispatch hasn't
    landed within the hedge budget (a deadline-threatened probe), a
    duplicate fires at the key's next healthy replica; the first
    completion wins and the loser is accounted ``hedge_cancelled`` on
    its replica — cancellation is accounting, not interruption: the
    loser's result is discarded, never double-counted.
  * **exactness** — every replica is a ``SemanticHistogram`` handle over
    the same store tensor and index (no extra device memory) probed by the
    same kernel, so routing can never change a count: any exact answer is
    bitwise equal to single-replica serving. Only when every healthy route
    is exhausted does the fleet degrade to the store's certified
    bound-only interval.

Reconciliation (the coalescer's invariant, fleet edition): every predicate
entering ``probe_outcomes`` is attributed to exactly ONE replica bucket
at final resolution, and every hedge loser to exactly one
``hedge_cancelled``, so per replica r and fleet-wide (summing over r)

    requests == probe_scored + cache_hits + coalesced_dups
                + shed + degraded + errors + hedge_cancelled

Failed attempts that *fail over* (replica error, partition, degraded
answer with healthy routes remaining) are deliberately outside the
invariant — they resolve nothing — and are counted separately as
``failovers``. Chaos (`replica-kill`, `replica-slow`, `partition`) hooks
the dispatch path deterministically by fleet dispatch ordinal
(``repro_torch.launch.chaos.FleetChaos``).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time

import numpy as np

from repro_torch.launch.chaos import ChaosInjector, ReplicaPartitionedError
from repro_torch.launch.coalescer import (
    CoalescerConfig,
    PredicateCache,
    PredicateCoalescer,
    ProbeOutcome,
    ShedError,
)
from repro_torch.obs import ObsHub
from repro_torch.runtime.fault_tolerance import (
    HeartbeatRegistry,
    StepWatchdog,
    TransientError,
)

__all__ = ["VnodeRing", "FleetConfig", "Replica", "ReplicaSet",
           "NoHealthyReplicaError", "FLEET_BUCKETS"]

# the per-replica reconciliation buckets; "requests" is the left-hand side
FLEET_BUCKETS = ("probe_scored", "cache_hits", "coalesced_dups", "shed",
                 "degraded", "errors", "hedge_cancelled")


class NoHealthyReplicaError(TransientError):
    """Every healthy route was exhausted and degraded answers are off."""


def _stable_hash(data: bytes) -> int:
    """64-bit stable hash (``hash()`` is randomized per process — useless
    for a ring that must agree across runs, tests, and subprocesses)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class VnodeRing:
    """Consistent-hash ring with virtual nodes.

    Each replica contributes ``vnodes`` points at
    ``blake2b(b"replica:<rid>:vnode:<i>")``; a key is owned by the first
    point clockwise from ``blake2b(key)``. Two properties the router
    relies on (property-tested in ``tests/test_torch_fleet.py``):

      * **balance** — with enough vnodes the key space splits within
        ~1.5x of uniform across replicas;
      * **minimal disruption** — removing a replica removes only *its*
        points, so only keys it owned remap (to their ring successors);
        every other key keeps its owner.
    """

    def __init__(self, replica_ids, vnodes: int = 128):
        self.replica_ids = tuple(replica_ids)
        self.vnodes = int(vnodes)
        if not self.replica_ids:
            raise ValueError("ring needs at least one replica")
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        pts = []
        for rid in self.replica_ids:
            for i in range(self.vnodes):
                pts.append((_stable_hash(
                    f"replica:{rid}:vnode:{i}".encode()), rid))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [r for _, r in pts]

    def owner(self, key: bytes) -> int:
        """The replica owning ``key`` (first vnode clockwise)."""
        i = bisect.bisect_right(self._points, _stable_hash(key))
        return self._owners[i % len(self._owners)]

    def route(self, key: bytes) -> list[int]:
        """All replicas in ring order from ``key``: owner first, then
        each key-specific successor — the failover/hedge order."""
        i = bisect.bisect_right(self._points, _stable_hash(key))
        n = len(self._owners)
        order, seen = [], set()
        for step in range(n):
            rid = self._owners[(i + step) % n]
            if rid not in seen:
                seen.add(rid)
                order.append(rid)
                if len(order) == len(self.replica_ids):
                    break
        return order

    def without(self, rid: int) -> "VnodeRing":
        """A ring with ``rid`` removed (what failover converges to)."""
        rest = [r for r in self.replica_ids if r != rid]
        return VnodeRing(rest, vnodes=self.vnodes)


@dataclasses.dataclass
class FleetConfig:
    """Fleet shape + routing/hedging/health knobs."""

    replicas: int = 2
    vnodes: int = 128              # ring points per replica
    routing: str = "affinity"      # "affinity" | "random" (baseline)
    hedge_ms: float = 0.0          # 0 = hedging off
    heartbeat_ms: float = 50.0     # monitor period (0 = no monitor)
    heartbeat_timeout_ms: float = 0.0   # 0 -> 5 x heartbeat_ms
    max_replica_queue: int = 0     # skip replicas this deep (0 = off)
    route_bits: int = 12           # embedding quantization for the ring key
    seed: int = 0                  # random-routing seed (baseline mode)

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.routing not in ("affinity", "random"):
            raise ValueError(f"routing must be affinity|random, "
                             f"got {self.routing!r}")
        for name in ("hedge_ms", "heartbeat_ms", "heartbeat_timeout_ms"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.heartbeat_timeout_ms == 0.0:
            self.heartbeat_timeout_ms = 5.0 * self.heartbeat_ms


class Replica:
    """One serving replica: store handle + coalescer + cache + breaker.

    ``hist`` must be built over the SAME store as every other replica in
    the set (shared embedding/index arrays are fine — probe dispatch is
    thread-safe and stateless) so exact answers are bitwise identical
    regardless of routing. The coalescer's counters are namespaced
    ``fleet.r<rid>.coalescer.*`` in the shared registry.
    """

    def __init__(self, rid: int, hist, config: CoalescerConfig, *,
                 cache: PredicateCache | None = None, chaos=None,
                 obs: ObsHub | None = None):
        self.rid = int(rid)
        self.hist = hist
        self.obs = obs if obs is not None else ObsHub()
        self.coalescer = PredicateCoalescer(
            hist, config, cache=cache, chaos=chaos, obs=self.obs,
            metrics_prefix=f"fleet.r{self.rid}.coalescer")
        self.watchdog = StepWatchdog()       # dispatch-latency EWMA
        self.killed = False

    @property
    def alive(self) -> bool:
        return not self.killed and self.coalescer.alive

    def kill(self, exc: BaseException | None = None) -> None:
        """Abrupt chaos kill: fail in-flight waiters, accept no more."""
        self.killed = True
        self.coalescer.kill(exc)

    def stats(self) -> dict:
        return {
            "rid": self.rid,
            "alive": self.alive,
            "breaker": self.coalescer.breaker.stats()["state"],
            "queue_depth": self.coalescer.queue_depth(),
            "ewma_ms": (None if self.watchdog.ewma_s is None
                        else self.watchdog.ewma_s * 1e3),
            "coalescer": self.coalescer.stats(),
        }


class ReplicaSet:
    """R replicas behind the cache-affinity router.

    Drop-in for a ``PredicateCoalescer`` wherever one is accepted
    (``plan_query(..., coalescer=...)`` duck-types on
    ``probe_outcomes`` / ``selectivity_batch``), so the whole serving
    stack gains replication without touching the planner.
    """

    def __init__(self, hists, config: CoalescerConfig | None = None, *,
                 fleet: FleetConfig | None = None, chaos=None,
                 obs: ObsHub | None = None):
        self.cfg = fleet or FleetConfig(replicas=len(hists))
        if len(hists) != self.cfg.replicas:
            raise ValueError(f"{len(hists)} store handles for "
                             f"{self.cfg.replicas} replicas")
        ccfg = config or CoalescerConfig()
        self.obs = obs if obs is not None else ObsHub()
        self.chaos = chaos
        if chaos is not None and getattr(chaos, "obs", None) is None:
            chaos.obs = self.obs
        base_chaos = getattr(getattr(chaos, "cfg", None), "base", None)
        self.replicas = []
        for rid, hist in enumerate(hists):
            rep_chaos = None
            if base_chaos is not None:
                rep_chaos = ChaosInjector(dataclasses.replace(
                    base_chaos, seed=base_chaos.seed + rid), obs=self.obs)
            # per-replica cache: 1/R of the configured capacity, so the
            # fleet's AGGREGATE capacity equals one single-replica cache
            # — the affinity-vs-duplication comparison is capacity-fair
            cap = max(1, ccfg.cache_capacity // self.cfg.replicas)
            cache = PredicateCache(cap, bits=ccfg.cache_bits)
            self.replicas.append(Replica(
                rid, hist, dataclasses.replace(ccfg, cache_capacity=cap),
                cache=cache, chaos=rep_chaos, obs=self.obs))
        self.hist = self.replicas[0].hist     # fleet-level bound source
        self.ring = VnodeRing(range(self.cfg.replicas),
                              vnodes=self.cfg.vnodes)
        self._route_scale = float(1 << self.cfg.route_bits)
        self._rng = np.random.default_rng(self.cfg.seed)
        self._rng_lock = threading.Lock()

        reg = self.obs.registry
        self._c = {(r, name): reg.counter(f"fleet.r{r}.{name}")
                   for r in range(self.cfg.replicas)
                   for name in ("requests",) + FLEET_BUCKETS}
        self._failovers = reg.counter("fleet.failovers")
        self._hedges = reg.counter("fleet.hedges")
        self._healthy_gauge = reg.gauge("fleet.healthy_replicas")
        self._healthy_gauge.set(self.cfg.replicas)

        self.heartbeats = HeartbeatRegistry(
            timeout_s=self.cfg.heartbeat_timeout_ms / 1e3)
        for r in range(self.cfg.replicas):
            self.heartbeats.beat(r)
        self._stop_monitor = threading.Event()
        self._monitor = None
        if self.cfg.heartbeat_ms > 0:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-heartbeat",
                daemon=True)
            self._monitor.start()

    # ---------------------------------------------------------- health

    def _monitor_loop(self) -> None:
        period_s = self.cfg.heartbeat_ms / 1e3
        while not self._stop_monitor.wait(period_s):
            for rep in self.replicas:
                if rep.alive:
                    self.heartbeats.beat(rep.rid)
            self._healthy_gauge.set(
                sum(self._healthy(r) for r in range(self.cfg.replicas)))

    def _healthy(self, rid: int) -> bool:
        rep = self.replicas[rid]
        if not rep.alive:
            return False
        if self._monitor is not None and not self.heartbeats.fresh(rid):
            return False
        if rep.coalescer.breaker.is_open:    # breaker-state propagation
            return False
        if self._saturated(rid):
            return False
        return True

    def _saturated(self, rid: int) -> bool:
        return bool(self.cfg.max_replica_queue
                    and self.replicas[rid].coalescer.queue_depth()
                    >= self.cfg.max_replica_queue)

    def healthy_replicas(self) -> list[int]:
        return [r for r in range(self.cfg.replicas) if self._healthy(r)]

    # --------------------------------------------------------- routing

    def _route_key(self, emb: np.ndarray) -> bytes:
        """Ring key: the quantized embedding (same quantization as the
        predicate cache, minus threshold/version) — all thresholds and
        store versions of one predicate share a home replica, so its
        cache entries cluster on one LRU."""
        q = np.round(np.asarray(emb, np.float64)
                     * self._route_scale).astype(np.int32)
        return q.tobytes()

    def _route_order(self, emb: np.ndarray) -> list[int]:
        if self.cfg.routing == "affinity":
            return self.ring.route(self._route_key(emb))
        with self._rng_lock:
            return list(self._rng.permutation(self.cfg.replicas))

    def _pick(self, order: list[int], tried: set) -> int | None:
        for rid in order:
            if rid not in tried and self._healthy(rid):
                return rid
        return None

    # -------------------------------------------------------- dispatch

    def _try_dispatch(self, rid: int, idxs, preds, thrs,
                      deadline) -> list[ProbeOutcome]:
        """One replica dispatch (chaos hook + EWMA), may raise."""
        if self.chaos is not None:
            act = self.chaos.on_dispatch(rid)
            for k in act.kills:
                if 0 <= k < len(self.replicas):
                    self.replicas[k].kill()
            if act.delay_ms > 0:
                time.sleep(act.delay_ms / 1e3)
            if act.partitioned:
                raise ReplicaPartitionedError(
                    f"chaos: replica {rid} partitioned")
        rep = self.replicas[rid]
        t0 = time.perf_counter()
        try:
            # degraded_ok=True at the replica boundary: the REPLICA never
            # raises for shed/deadline/breaker — it returns a bucketed
            # outcome and the FLEET decides whether to fail over, accept,
            # or (fleet-level degraded_ok=False) raise
            return rep.coalescer.probe_outcomes(
                preds[idxs], thrs[idxs], deadline=deadline,
                degraded_ok=True)
        finally:
            rep.watchdog.observe(time.perf_counter() - t0)

    def _dispatch_group(self, rid: int, idxs, preds, thrs, deadline,
                        order: list[int], tried: set):
        """Dispatch one affinity group, optionally hedged.

        Returns ``(winner_rid, outcomes_or_exception)``. The hedge fires
        when the primary hasn't landed within ``hedge_ms`` (the request
        is deadline-threatened); first completion wins, the loser is
        accounted ``hedge_cancelled`` on its replica.
        """
        hedge_s = self.cfg.hedge_ms / 1e3
        backup = None
        if hedge_s > 0:
            backup = self._pick([r for r in order if r != rid], tried)
        if hedge_s <= 0 or backup is None:
            try:
                return rid, self._try_dispatch(rid, idxs, preds, thrs,
                                               deadline)
            except Exception as e:  # noqa: BLE001 — failover classifies
                return rid, e

        box: list = []
        done = threading.Event()

        def call(r: int) -> None:
            try:
                res = self._try_dispatch(r, idxs, preds, thrs, deadline)
            except Exception as e:  # noqa: BLE001
                res = e
            with self._rng_lock:
                box.append((r, res))
            done.set()

        t1 = threading.Thread(target=call, args=(rid,), daemon=True)
        t1.start()
        if done.wait(timeout=hedge_s):
            with self._rng_lock:
                return box[0]
        self._hedges.inc()
        t2 = threading.Thread(target=call, args=(backup,), daemon=True)
        t2.start()
        done.wait()
        with self._rng_lock:
            win_rid, res = box[0]
        loser = backup if win_rid == rid else rid
        # first-wins cancellation accounting: the loser dispatch resolves
        # into hedge_cancelled NOW; its eventual result is discarded
        self._c[(loser, "requests")].inc(len(idxs))
        self._c[(loser, "hedge_cancelled")].inc(len(idxs))
        return win_rid, res

    # ----------------------------------------------------- control plane

    def selectivity(self, emb: np.ndarray, threshold: float) -> float:
        return float(self.selectivity_batch(
            np.asarray(emb)[None, :], np.asarray([threshold]))[0])

    def selectivity_batch(self, preds, thresholds) -> np.ndarray:
        return np.asarray([o.sel for o in
                           self.probe_outcomes(preds, thresholds)])

    def _bound_outcome(self, emb, thr, bucket: str) -> ProbeOutcome:
        lo, hi = self.hist.selectivity_bounds(
            np.asarray(emb)[None, :], np.asarray([thr], np.float32))
        lo, hi = float(lo[0]), float(hi[0])
        return ProbeOutcome(sel=0.5 * (lo + hi), lo=lo, hi=hi,
                            degraded=True, bucket=bucket)

    def probe_outcomes(self, preds, thresholds, *,
                       deadline: float | None = None,
                       degraded_ok: bool | None = None,
                       ) -> list[ProbeOutcome]:
        """Resolve B (predicate, threshold) pairs across the fleet.

        Same contract as ``PredicateCoalescer.probe_outcomes``; routing,
        failover, and hedging are invisible in the result except through
        the fleet counters — any exact outcome is bitwise equal to what
        a lone replica would have returned.
        """
        ccfg = self.replicas[0].coalescer.cfg
        preds = np.asarray(preds, np.float32)
        thrs = np.asarray(thresholds, np.float32).reshape(-1)
        if preds.ndim != 2 or preds.shape[0] != thrs.shape[0]:
            raise ValueError(
                f"preds {preds.shape} vs thresholds {thrs.shape}")
        if degraded_ok is None:
            degraded_ok = ccfg.degraded_ok
        if deadline is None and ccfg.deadline_ms > 0:
            deadline = time.monotonic() + ccfg.deadline_ms / 1e3

        B = len(preds)
        out: list[ProbeOutcome | None] = [None] * B
        orders = [self._route_order(preds[j]) for j in range(B)]
        tried: list[set] = [set() for _ in range(B)]
        first_err: Exception | None = None

        def accept(j: int, rid: int, o: ProbeOutcome) -> None:
            nonlocal first_err
            bucket = o.bucket or ("degraded" if o.degraded
                                  else "probe_scored")
            if o.degraded and not degraded_ok:
                bucket = "errors"
                if first_err is None:
                    first_err = (
                        ShedError("fleet admission shed the request")
                        if o.bucket == "shed" else NoHealthyReplicaError(
                            "every healthy route exhausted"))
            self._c[(rid, "requests")].inc()
            self._c[(rid, bucket)].inc()
            out[j] = o

        pending = list(range(B))
        while pending:
            groups: dict[int, list[int]] = {}
            for j in pending:
                rid = self._pick(orders[j], tried[j])
                if rid is None:
                    # every healthy route exhausted: certified bound-only
                    # answer, attributed to the key's ring owner. "shed"
                    # when admission (saturation) was the only obstacle,
                    # "degraded" otherwise.
                    shed_only = any(
                        self.replicas[r].alive
                        and not self.replicas[r].coalescer.breaker.is_open
                        and self._saturated(r)
                        for r in orders[j] if r not in tried[j])
                    accept(j, orders[j][0], self._bound_outcome(
                        preds[j], thrs[j],
                        "shed" if shed_only else "degraded"))
                else:
                    groups.setdefault(rid, []).append(j)
            if not groups:
                break

            results: list[tuple[int, list[int], object]] = []
            items = sorted(groups.items())
            if len(items) == 1:
                rid, idxs = items[0]
                win, res = self._dispatch_group(
                    rid, np.asarray(idxs), preds, thrs, deadline,
                    orders[idxs[0]], tried[idxs[0]])
                results.append((win, idxs, res))
            else:
                lock = threading.Lock()

                def run(rid: int, idxs: list[int]) -> None:
                    win, res = self._dispatch_group(
                        rid, np.asarray(idxs), preds, thrs, deadline,
                        orders[idxs[0]], tried[idxs[0]])
                    with lock:
                        results.append((win, idxs, res))

                threads = [threading.Thread(target=run, args=(rid, idxs),
                                            daemon=True)
                           for rid, idxs in items]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()

            pending = []
            for win_rid, idxs, res in results:
                if isinstance(res, BaseException):
                    # the dispatch never resolved anything: fail over
                    for j in idxs:
                        tried[j].add(win_rid)
                    self._failovers.inc(len(idxs))
                    pending.extend(idxs)
                    continue
                for j, o in zip(idxs, res):
                    if not o.degraded:
                        accept(j, win_rid, o)
                        continue
                    tried[j].add(win_rid)
                    if self._pick(orders[j], tried[j]) is not None:
                        self._failovers.inc()
                        pending.append(j)      # healthy routes remain
                    else:
                        accept(j, win_rid, o)  # exhausted: keep the bound

        if first_err is not None:
            raise first_err
        return out

    # ------------------------------------------------------- lifecycle

    def close(self) -> None:
        self._stop_monitor.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        for rep in self.replicas:
            if rep.alive:
                rep.coalescer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        """Per-replica + aggregate fleet view (consumed by obs/report)."""
        reps = []
        totals = {name: 0 for name in ("requests",) + FLEET_BUCKETS}
        for r in range(self.cfg.replicas):
            row = self.replicas[r].stats()
            for name in ("requests",) + FLEET_BUCKETS:
                row[name] = self._c[(r, name)].value
                totals[name] += row[name]
            row["reconciles"] = (row["requests"] == sum(
                row[b] for b in FLEET_BUCKETS))
            reps.append(row)
        cache_hits = sum(rep["coalescer"]["cache"]["hits"]
                         for rep in reps)
        cache_misses = sum(rep["coalescer"]["cache"]["misses"]
                           for rep in reps)
        lookups = cache_hits + cache_misses
        d = dict(totals)
        d.update({
            "replica_count": self.cfg.replicas,
            "routing": self.cfg.routing,
            "hedge_ms": self.cfg.hedge_ms,
            "reconciles": (totals["requests"] == sum(
                totals[b] for b in FLEET_BUCKETS)),
            "failovers": self._failovers.value,
            "hedges": self._hedges.value,
            "healthy_replicas": len(self.healthy_replicas()),
            "cache": {
                "hits": cache_hits,
                "misses": cache_misses,
                "hit_rate": cache_hits / lookups if lookups else 0.0,
            },
            "replicas": reps,
        })
        if self.chaos is not None:
            d["chaos"] = self.chaos.stats()
        return d

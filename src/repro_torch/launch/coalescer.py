"""Cross-query predicate coalescing + LRU cache + serving control plane.

The histogram's batched probe scores all filters of *one* query in one store
pass; this module batches across *queries* and keeps the serving loop alive
when the probe path misbehaves. A port of the reference's
``repro/launch/coalescer.py`` over the port's ``SemanticHistogram``, whose
probe is the CUDA kernel on the card. Pieces:

  * ``PredicateCache`` — an LRU over quantized (embedding, thresholds, k)
    keys storing full probe results (counts + top-k). Real semantic-query
    workloads are dominated by repeated / near-duplicate predicates (hot
    filters), which hit the cache and skip the store scan entirely.
    Hit / miss / eviction counters are exposed for the serve loop.

  * ``PredicateCoalescer`` — micro-batches behind the running flush.
    Concurrent ``plan_query`` calls submit their predicates and block; a
    flusher thread fires ONE batched histogram probe for up to
    ``max_batch`` pending predicates and scatters per-predicate
    selectivities back to the waiting queries. It holds no window: an idle
    flusher takes a call's misses as they arrive (they pend together), and
    predicates that arrive while a flush runs go together in the next
    flush, as soon as the running one ends — they have waited behind its
    scan already. So a predicate waits on the card for nothing but the
    flush in flight and its own scan. Identical in-flight predicates are
    deduplicated (piggyback on the pending entry), so a probe never scores
    the same predicate twice.

  * the control plane — per-request deadlines, admission control,
    retry + circuit breaker around probe dispatch (the shared
    ``repro_torch.runtime.fault_tolerance`` vocabulary), and graceful degradation
    to bound-only answers. A cluster index's exact Cauchy-Schwarz bounds
    give a certified selectivity interval with zero rows read
    (``SemanticHistogram.selectivity_bounds``), so under overload, an open
    breaker, a blown deadline, or a dead flusher the coalescer can answer
    *degraded but never wrong* instead of hanging or failing the query —
    when the caller opts in with ``degraded_ok``.

The coalescer consults the cache at submit time (a hit returns immediately,
without waiting for a flush) and fills it at flush time with the exact
values the kernel produced — a later hit is bitwise-identical to the fresh
probe; degraded answers never enter the cache. A flush probes exactly its
b pending predicates: the CUDA kernel compiles nothing per shape, and a
row's bits do not depend on B, so there is nothing to pad for (the
reference pads to a power-of-two bucket for its jitted probe). With
``max_batch`` 64 a flush of at most 8 distinct predicates takes the probe's
8-wide scan, and a flush of 9–64 its wide scan, one store pass for any B.

Thread model: any number of submitter threads; one daemon flusher, which
launches every probe on its current stream (the default stream: the probe
keeps one scratch buffer a stream, so the flusher's probes never overlap
one another; the planner's specificity MLP runs on a stream of its own,
``core/specificity.py``). The flusher reads a result back only after a
blocking wait for its stream (``_host``), so while a scan runs it holds
no other thread's CUDA calls. All shared state is guarded by one
condition variable; the probe itself runs outside submitter critical
sections. If the
flusher thread dies (anything escaping its loop, incl. injected
``FlusherKill``), every pending/in-flight waiter is failed immediately
with ``FlusherDiedError`` — no waiter ever blocks on a thread that no
longer exists — and a fresh flusher is started unless the coalescer is
closing.

Reconciliation invariant (asserted by the chaos tests): every request
resolves exactly once, so at all times after the last resolution

    requests == probe_scored + cache_hits + coalesced_dups
                + shed + degraded + errors

where the buckets classify the request at *resolution* time:
``probe_scored`` exact value to the pending entry's creator, ``cache_hits``
served from the LRU, ``coalesced_dups`` exact value to a piggybacked
duplicate, ``shed`` rejected by admission control (bound answer or
``ShedError``), ``degraded`` bound-only answer for any non-admission
reason (deadline, breaker, probe failure, flusher death), ``errors``
raised without a bound answer.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.phases import profiled_range
from repro_torch.device import wait_for
from repro_torch.kernels.cosine_topk import kernel as probe_kernel
from repro_torch.obs import ObsHub, set_flush_ctx
from repro_torch.runtime.fault_tolerance import (
    CircuitBreaker,
    RetryPolicy,
    StepWatchdog,
    TransientError,
)

__all__ = [
    "PredicateCache", "CoalescerConfig", "PredicateCoalescer",
    "ProbeOutcome", "ShedError", "DeadlineExceededError",
    "BreakerOpenError", "FlusherDiedError",
]


def _host(a) -> np.ndarray:
    """A probe output as a host array. A tensor on the card is copied once
    its stream has run, after a wait on a blocking event: a copy to pageable
    memory that waits for a scan holds every other thread's CUDA calls (the
    planner's MLP too) until the scan ends."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if a.is_cuda:
        wait_for(torch.cuda.current_stream(a.device))
    return a.cpu().numpy()


class ShedError(TransientError):
    """Admission control rejected the request (queue over watermark)."""


class DeadlineExceededError(TransientError):
    """The request's deadline expired before its probe landed."""


class BreakerOpenError(TransientError):
    """The probe circuit breaker is open; no probe was attempted."""


class FlusherDiedError(RuntimeError):
    """The flusher thread died while this request was in flight."""


class PredicateCache:
    """LRU cache: quantized (embedding, thresholds, k) -> (counts, top-k).

    Keys quantize the embedding and threshold vectors to ``bits`` fractional
    bits (round(x * 2^bits)), so near-duplicate predicate embeddings — the
    same filter re-encoded, or textual paraphrases landing within the
    quantization ball — collapse to one entry. Values are the full probe
    outputs (counts (T,) int32, top-k (k,) float32), so both selectivity
    and threshold-calibration probes can be served from cache.

    Thread-safe; ``hits`` / ``misses`` / ``evictions`` counters are
    monotonic and surfaced by the serve loop.
    """

    def __init__(self, capacity: int = 1024, *, bits: int = 12):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.bits = bits
        self._od: OrderedDict[tuple, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # observed-selectivity side table: ground truth written back
        # by the feedback loop after plan execution, keyed by quantized
        # predicate(s) + store version — separate from the probe cache so
        # observed entries never evict probe results (and vice versa)
        self._observed: OrderedDict[tuple, float] = OrderedDict()
        self.observed_hits = 0
        self.observed_misses = 0

    def key(self, emb: np.ndarray, thresholds, k: int,
            version: int = 0) -> tuple:
        """Quantized lookup key for one predicate's probe.

        ``version`` is the histogram's mutation counter (0 for immutable
        stores): a mutable store bumps it on every insert/delete batch and
        index swap, so entries cached against an older store state can
        never satisfy a lookup after a mutation — the stale entries just
        age out of the LRU."""
        scale = float(1 << self.bits)
        q = np.round(np.asarray(emb, np.float64) * scale).astype(np.int32)
        t = np.round(np.atleast_1d(np.asarray(thresholds, np.float64))
                     * scale).astype(np.int32)
        return (q.tobytes(), t.tobytes(), int(k), int(version))

    def observed_key(self, emb: np.ndarray, version: int = 0) -> tuple:
        """Key for one predicate's *observed* (executed ground-truth)
        selectivity. Thresholds are deliberately absent: the observed
        value is the VLM-measured truth for the predicate itself, not a
        property of a calibrated threshold. ``version`` folds in the store
        mutation counter — an observed selectivity is only trusted at the
        exact store version it was measured against (staleness rule)."""
        scale = float(1 << self.bits)
        q = np.round(np.asarray(emb, np.float64) * scale).astype(np.int32)
        return ("obs", q.tobytes(), int(version))

    def compound_key(self, embs: np.ndarray, thresholds, mode: str,
                     version: int = 0) -> tuple:
        """Order-invariant key for a compound predicate's selectivity.

        Each conjunct quantizes (embedding, threshold) like ``key``; the
        per-conjunct parts are then sorted, so ``A AND B`` and ``B AND A``
        share one entry (conjunction/disjunction are commutative).
        Thresholds participate because the compound selectivity is a
        property of the calibrated filters, not the bare predicates.
        """
        scale = float(1 << self.bits)
        thr = np.atleast_1d(np.asarray(thresholds, np.float64))
        parts = []
        for emb, t in zip(np.asarray(embs, np.float64), thr):
            q = np.round(emb * scale).astype(np.int32)
            tq = int(np.round(float(t) * scale))
            parts.append((q.tobytes(), tq))
        return ("compound", str(mode), tuple(sorted(parts)), int(version))

    def get_observed(self, key: tuple) -> float | None:
        """Observed selectivity on hit (LRU-refreshed), None on miss."""
        with self._lock:
            val = self._observed.get(key)
            if val is None:
                self.observed_misses += 1
                return None
            self._observed.move_to_end(key)
            self.observed_hits += 1
            return val

    def put_observed(self, key: tuple, sel: float) -> None:
        with self._lock:
            if key in self._observed:
                self._observed.move_to_end(key)
            self._observed[key] = float(sel)
            while len(self._observed) > self.capacity:
                self._observed.popitem(last=False)

    def get(self, key: tuple):
        """(counts, topk) on hit (LRU-refreshed), None on miss."""
        with self._lock:
            val = self._od.get(key)
            if val is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key: tuple, value: tuple) -> None:
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
            self._od[key] = value
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._od),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0,
                "observed": {
                    "entries": len(self._observed),
                    "hits": self.observed_hits,
                    "misses": self.observed_misses,
                },
            }


@dataclasses.dataclass
class CoalescerConfig:
    """Micro-batch + control-plane knobs (docs/serving.md).

    ``window_ms`` is accepted and ignored: the flusher holds no window (it
    takes what pends as soon as it is idle, so a predicate waits only for
    the flush in flight). It stays, validated as before, because
    configurations that set it, the benchmark's among them, pass it on.

    The robustness knobs all default *off* (0 / False), so a default
    coalescer behaves exactly like the pre-control-plane one: no shedding,
    no deadlines, exact answers or propagated errors.
    """

    max_batch: int = 64        # the most predicates one flush probes
    window_ms: float = 2.0     # ignored: no flush waits for company
    cache_capacity: int = 1024
    cache_bits: int = 12       # embedding quantization (near-dup collapse)
    max_queue: int = 0         # shed when this many predicates pend (0=off)
    max_pending_age_ms: float = 0.0   # shed when the oldest pending entry
    #                                   is older than this (0=off): the
    #                                   flusher is stuck or drowning
    deadline_ms: float = 0.0   # default per-request deadline (0=off)
    degraded_ok: bool = False  # default: answer from bounds instead of
    #                            raising on shed/deadline/breaker/failure

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.window_ms <= 0:
            raise ValueError(f"window_ms must be > 0, got {self.window_ms}")
        if self.cache_capacity < 1:
            raise ValueError(
                f"cache_capacity must be >= 1, got {self.cache_capacity}")
        for name in ("max_queue", "max_pending_age_ms", "deadline_ms"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")


@dataclasses.dataclass(frozen=True)
class ProbeOutcome:
    """One request's resolution: exact (lo == sel == hi) or degraded
    (``sel`` is the midpoint of the certified interval [lo, hi]).

    ``bucket`` names the reconciliation bucket the resolution was counted
    under (``probe_scored`` / ``cache_hits`` / ``coalesced_dups`` /
    ``shed`` / ``degraded``)."""

    sel: float
    lo: float
    hi: float
    degraded: bool = False
    bucket: str = ""


class _Pending:
    """One in-flight predicate: all duplicate submitters wait on ``event``.

    ``qw_s`` / ``probe_s`` are the flush-side timing breakdown (queue
    wait until dequeue, probe dispatch wall) stamped by ``_flush`` so
    every waiter — creator and piggybacked duplicates alike — can split
    its own wall time into queue-wait / probe / combine; ``set_ns`` is the
    ``perf_counter_ns`` just before the flush sets ``event``, from which a
    waiter measures how late it woke."""

    __slots__ = ("key", "emb", "thr", "ts", "event", "value", "error",
                 "qw_s", "probe_s", "set_ns")

    def __init__(self, key, emb, thr):
        self.key = key
        self.emb = emb
        self.thr = thr
        self.ts = time.monotonic()
        self.event = threading.Event()
        self.value = None
        self.error = None
        self.qw_s = 0.0
        self.probe_s = 0.0
        self.set_ns = 0


class PredicateCoalescer:
    """Micro-batches over a SemanticHistogram's batched probe.

    ``selectivity_batch(embs, thrs)`` has the same signature as
    ``SemanticHistogram.selectivity_batch`` so estimators (and
    ``plan_query(..., coalescer=...)``) can route probes through it
    unchanged; ``probe_outcomes`` is the control-plane entry point that
    additionally takes a deadline and returns per-request
    ``ProbeOutcome``s with certified bounds on degraded answers.

    Counters (see the module docstring for the reconciliation invariant)::

        requests           predicates submitted
        probes_fired       successful batched kernel launches
        predicates_probed  predicates scored by a successful launch
        probe_scored       requests resolved exactly as an entry's creator
        cache_hits         requests resolved from the LRU
        coalesced_dups     requests resolved exactly as a piggybacked dup
        shed               requests rejected by admission control
        degraded           requests resolved with a bound-only answer
        errors             requests resolved by raising
        retries            probe attempts retried after transient failure
        probe_failures     probe attempts that raised
        breaker_fastfails  submits short-circuited by an open breaker
        flusher_deaths     flusher thread deaths observed
        flusher_restarts   replacement flusher threads started
        queue_depth_hwm    max pending-queue depth ever observed

    Besides, outside ``stats()``: ``<prefix>.idle_flushes`` counts the
    successful launches whose batch an idle flusher took as its first
    predicates came (they waited behind no flush); ``<prefix>.wakes`` the
    probe-resolved waits, ``<prefix>.blocked_wakes`` those among them that
    blocked (their flush set the result after the wait began), and
    ``<prefix>.wake_ns`` the nanoseconds each of those woke after its
    result was set (the hand-off to the waiting threads). On a CUDA store
    ``probe.device_ns`` sums the device time of the successful probes that
    were one kernel launch, and ``probe.device_timed`` counts them: the
    flusher arms its launches around ``probe_batch`` and the kernel records
    a CUDA event pair around the launch (``probe_kernel.arm_launch_timing``),
    so it holds the scan and merge and not the host work that stages them.

    Coalescing wins show up as ``probes_fired`` << ``requests`` and
    cache + dedup wins as ``predicates_probed`` < ``requests``.
    """

    _COUNTERS = ("requests", "probes_fired", "predicates_probed",
                 "probe_scored", "cache_hits", "coalesced_dups", "shed",
                 "degraded", "errors", "retries", "probe_failures",
                 "breaker_fastfails", "flusher_deaths", "flusher_restarts")

    def __init__(self, hist, config: CoalescerConfig | None = None, *,
                 cache: PredicateCache | None = None, chaos=None,
                 retry: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 obs: ObsHub | None = None,
                 metrics_prefix: str = "coalescer"):
        self.hist = hist
        self.cfg = config or CoalescerConfig()
        self.cache = cache if cache is not None else PredicateCache(
            self.cfg.cache_capacity, bits=self.cfg.cache_bits)
        self.retry = retry if retry is not None else RetryPolicy(
            max_retries=2, base_delay_s=0.005, max_delay_s=0.1)
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=5, cooldown_s=1.0)
        self.watchdog = StepWatchdog()      # flush-latency EWMA
        # telemetry: counters live in the (possibly shared) registry so
        # stats(), the exit summary, and --metrics-json read ONE source;
        # handles are resolved once here, never by name on the hot path.
        # ``metrics_prefix`` namespaces the counters so fleet replicas
        # sharing one registry don't merge their per-replica counts.
        self.obs = obs if obs is not None else ObsHub()
        reg = self.obs.registry
        self.metrics_prefix = metrics_prefix
        self._c = {name: reg.counter(f"{metrics_prefix}.{name}")
                   for name in self._COUNTERS}
        self._hwm = reg.gauge(f"{metrics_prefix}.queue_depth_hwm")
        self._lat = {ph: reg.histogram(f"serve.{ph}_ms")
                     for ph in ("queue_wait", "probe", "combine",
                                "request")}
        self._idle_flushes = reg.counter(f"{metrics_prefix}.idle_flushes")
        self._wakes = reg.counter(f"{metrics_prefix}.wakes")
        self._blocked = reg.counter(f"{metrics_prefix}.blocked_wakes")
        self._wake_ns = reg.counter(f"{metrics_prefix}.wake_ns")
        # device time of the probes that are one launch (the kernel says
        # which: a sharded or an index probe is several)
        dev = getattr(hist, "device", None)
        self._timed = isinstance(dev, torch.device) and dev.type == "cuda"
        if self._timed:
            self._device_ns = reg.counter("probe.device_ns")
            self._device_timed = reg.counter("probe.device_timed")
        self._tls = threading.local()    # the flusher's timed attempt
        if self.breaker.on_transition is None:
            self.breaker.on_transition = self._on_breaker_transition
        self.chaos = chaos
        if chaos is not None and getattr(chaos, "obs", None) is None:
            chaos.obs = self.obs
        self._probe = (chaos.wrap(self._raw_probe) if chaos is not None
                       else self._raw_probe)
        self._cv = threading.Condition()
        self._pending: list[_Pending] = []
        self._inflight: dict[tuple, _Pending] = {}
        self._stop = False
        self._flusher = self._spawn_flusher()

    def _on_breaker_transition(self, old: str, new: str) -> None:
        self.obs.event("breaker_transition", prev=old, state=new)

    def _spawn_flusher(self) -> threading.Thread:
        t = threading.Thread(target=self._run, name="predicate-coalescer",
                             daemon=True)
        t.start()
        return t

    def _raw_probe(self, embs, thrs):
        # late-bound through self.hist so tests monkeypatching probe_batch
        # (and chaos wrapping this method) compose with the retry loop;
        # (counts (b, 1), top-k (b, 1)) on the host
        if not self._timed:
            counts, topk = self.hist.probe_batch(embs, thrs, k=1,
                                                 use_cache=False)
            return _host(counts), _host(topk)
        probe_kernel.arm_launch_timing()
        try:
            counts, topk = self.hist.probe_batch(embs, thrs, k=1,
                                                 use_cache=False)
            events = probe_kernel.timed_launch()   # None: not one launch
        finally:
            probe_kernel.arm_launch_timing(False)
        out = _host(counts), _host(topk)
        self._tls.timed = events            # read after the scatter
        return out

    # ------------------------------------------------------------- submit

    def selectivity(self, emb: np.ndarray, threshold: float) -> float:
        """Single-predicate convenience wrapper around the batch path."""
        return float(self.selectivity_batch(
            np.asarray(emb)[None, :], np.asarray([threshold]))[0])

    def selectivity_batch(self, preds: np.ndarray,
                          thresholds: np.ndarray) -> np.ndarray:
        """Selectivity for B (predicate, threshold) pairs.

        Cache hits return without blocking; misses enqueue into the next
        flush and block until the flusher's shared probe lands.
        Drop-in for ``SemanticHistogram.selectivity_batch``; deadline /
        degraded defaults come from the config (both off by default).
        """
        return np.asarray([o.sel for o in
                           self.probe_outcomes(preds, thresholds)])

    def _bound_outcome(self, emb: np.ndarray, thr: float,
                       bucket: str = "degraded") -> ProbeOutcome:
        """Certified bound-only answer for one predicate (never cached)."""
        lo, hi = self.hist.selectivity_bounds(
            np.asarray(emb)[None, :], np.asarray([thr], np.float32))
        lo, hi = float(lo[0]), float(hi[0])
        return ProbeOutcome(sel=0.5 * (lo + hi), lo=lo, hi=hi,
                            degraded=True, bucket=bucket)

    def probe_outcomes(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       deadline: float | None = None,
                       degraded_ok: bool | None = None,
                       ) -> list[ProbeOutcome]:
        """Resolve B (predicate, threshold) pairs under the control plane.

        ``deadline`` is an absolute ``time.monotonic()`` second (None
        derives one from ``cfg.deadline_ms``; 0 there means no deadline).
        ``degraded_ok`` (None -> ``cfg.degraded_ok``) turns shed /
        deadline / breaker / probe-failure resolutions into bound-only
        ``ProbeOutcome``s instead of raises. Every request resolves into
        exactly one reconciliation bucket (module docstring).
        """
        preds = np.asarray(preds, np.float32)
        thrs = np.asarray(thresholds, np.float32).reshape(-1)
        if preds.ndim != 2 or preds.shape[0] != thrs.shape[0]:
            raise ValueError(
                f"preds {preds.shape} vs thresholds {thrs.shape}")
        if degraded_ok is None:
            degraded_ok = self.cfg.degraded_ok
        if deadline is None and self.cfg.deadline_ms > 0:
            deadline = time.monotonic() + self.cfg.deadline_ms / 1e3

        out: list[ProbeOutcome | None] = [None] * len(preds)
        waits: list[tuple[int, _Pending, bool]] = []   # (j, entry, creator)
        t_sub = [0] * len(preds)          # perf_counter_ns at each submit

        def since_ms(j: int) -> float:
            return (time.perf_counter_ns() - t_sub[j]) / 1e6

        # one sampling decision per probe_outcomes call: a sampled call
        # emits a submit span for EVERY predicate it resolves (including
        # error/abandoned ones), so at --trace-sample 1 per-resolution
        # span counts equal the reconciliation counters exactly
        tr = self.obs.tracer
        sampled = tr is not None and tr.sample_hit("submit")
        trace_id = tr.next_id() if sampled else None

        def span(j: int, resolution: str, entry: _Pending | None = None,
                 **extra) -> None:
            if not sampled:
                return
            rec = {"trace": trace_id, "pred": int(j),
                   "resolution": resolution, "t_ns": t_sub[j],
                   "wall_ms": round(since_ms(j), 4)}
            if entry is not None:
                rec["queue_wait_ms"] = round(entry.qw_s * 1e3, 4)
                rec["probe_ms"] = round(entry.probe_s * 1e3, 4)
            rec.update(extra)
            tr.emit("submit", **rec)

        def fail(j: int, exc: Exception, abandoned: list):
            """No bound fallback: count this raise + every wait this call
            will abandon, so the reconciliation invariant survives the
            exception (abandoned probes still land and fill the cache)."""
            self._c["errors"].inc(1 + len(abandoned))
            span(j, "errors", error=type(exc).__name__)
            for jj, _, _ in abandoned:
                span(jj, "errors", abandoned=True)
            raise exc

        version = getattr(self.hist, "version", 0)
        keys = []
        for j in range(len(preds)):
            t_sub[j] = time.perf_counter_ns()
            keys.append(self.cache.key(preds[j], [thrs[j]], 1,
                                       version=version))
        # every miss of the call pends before the flusher hears of any, under
        # one hold of the lock and one notify: an idle flusher takes what
        # pends at once, and would otherwise scan the first miss alone
        fast: list[tuple[int, str]] = []   # (j, bucket) to resolve unlocked
        dead = breaker_open = False
        with self._cv:
            for j in range(len(preds)):
                # cache lookup under the lock: a flush fills the cache
                # *before* retiring its _inflight entries (which needs this
                # lock), so either the get hits or the entry is still
                # in-flight — a just-flushed duplicate can never slip
                # through and trigger a redundant store scan
                self._c["requests"].inc()
                cached = self.cache.get(keys[j])
                if cached is not None:
                    self._c["cache_hits"].inc()
                    sel = int(cached[0][0]) / self.hist.n
                    out[j] = ProbeOutcome(sel, sel, sel, False,
                                          bucket="cache_hits")
                    self._lat["request"].observe(since_ms(j))
                    span(j, "cache_hits")
                    continue
                entry = self._inflight.get(keys[j])
                if entry is not None:
                    waits.append((j, entry, False))
                    continue
                # a killed / closing coalescer has no flusher to land the
                # probe: fail fast (degraded or FlusherDiedError) instead
                # of enqueuing into a queue nobody will ever drain — the
                # fleet router relies on this to fail over immediately
                # when a replica dies between health check and dispatch
                dead = self._stop or not self._flusher.is_alive()
                breaker_open = (not dead) and self.breaker.is_open
                if breaker_open:
                    self._c["breaker_fastfails"].inc()
                shed = (not breaker_open and not dead) and (
                    (self.cfg.max_queue
                     and len(self._pending) >= self.cfg.max_queue)
                    or (self.cfg.max_pending_age_ms and self._pending
                        and (time.monotonic() - self._pending[0].ts) * 1e3
                        > self.cfg.max_pending_age_ms)
                    or (deadline is not None
                        and self.watchdog.ewma_s is not None
                        and time.monotonic() + self.watchdog.ewma_s
                        > deadline))
                if not (breaker_open or shed or dead):
                    entry = _Pending(keys[j], preds[j], thrs[j])
                    self._inflight[keys[j]] = entry
                    self._pending.append(entry)
                    self._hwm.record_max(len(self._pending))
                    waits.append((j, entry, True))
                    continue
                fast.append((j, "shed" if shed else "degraded"))
                if not degraded_ok:
                    break           # it raises: submit nothing after it
            if any(creator for _, _, creator in waits):
                self._cv.notify_all()
        # resolve the fast-fails outside the lock (bounds read the index)
        for j, bucket in fast:
            if degraded_ok:
                out[j] = self._bound_outcome(preds[j], thrs[j],
                                             bucket=bucket)
                self._c[bucket].inc()
                self._lat["request"].observe(since_ms(j))
                span(j, bucket)
            elif dead:
                fail(j, FlusherDiedError(
                    "coalescer is closed or its flusher died"), waits)
            elif breaker_open:
                fail(j, BreakerOpenError(
                    "probe circuit breaker is open"), waits)
            else:
                self._c["shed"].inc()   # shed bucket even when raising
                self._c["errors"].inc(len(waits))   # abandoned waits
                span(j, "shed", error="ShedError")
                for jj, _, _ in waits:
                    span(jj, "errors", abandoned=True)
                raise ShedError(
                    f"admission control shed the request (queue depth "
                    f"{len(self._pending)}, max_queue={self.cfg.max_queue})")

        for i, (j, entry, creator) in enumerate(waits):
            timeout = (None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
            t_wait = time.perf_counter_ns()
            landed = entry.event.wait(timeout=timeout)
            if landed and entry.error is None:
                self._wakes.inc()
                if entry.set_ns > t_wait:
                    # the result came while this waiter waited: how late
                    # it resumed after the flush set it
                    self._wake_ns.inc(time.perf_counter_ns() - entry.set_ns)
                    self._blocked.inc()
                sel = int(entry.value[0][0]) / self.hist.n
                bucket = "probe_scored" if creator else "coalesced_dups"
                out[j] = ProbeOutcome(sel, sel, sel, False, bucket=bucket)
                self._c[bucket].inc()
                wall = since_ms(j) / 1e3
                combine = max(0.0, wall - entry.qw_s - entry.probe_s)
                self._lat["queue_wait"].observe(entry.qw_s * 1e3)
                self._lat["probe"].observe(entry.probe_s * 1e3)
                self._lat["combine"].observe(combine * 1e3)
                self._lat["request"].observe(wall * 1e3)
                span(j, bucket, entry=entry,
                     combine_ms=round(combine * 1e3, 4))
                continue
            if degraded_ok:
                out[j] = self._bound_outcome(preds[j], thrs[j])
                self._c["degraded"].inc()
                self._lat["request"].observe(since_ms(j))
                span(j, "degraded",
                     reason="deadline" if not landed
                     else type(entry.error).__name__)
                continue
            remaining = waits[i + 1:]
            if not landed:
                fail(j, DeadlineExceededError(
                    "deadline expired before the probe landed"), remaining)
            fail(j, entry.error, remaining)
        return out

    # -------------------------------------------------------------- flush

    def _take_batch(self) -> tuple[list[_Pending], bool] | None:
        """Pop the next flush's batch (at most ``max_batch``), holding no
        window: predicates pending when the last flush ended have waited
        behind its scan, and an idle flusher takes the first to arrive (a
        call's misses pend together). Returns (batch, idle): idle when the
        flusher waited for the batch's first predicate."""
        with self._cv:
            idle = not self._pending
            while not self._pending:
                if self._stop:
                    return None
                self._cv.wait()
            batch = self._pending[:self.cfg.max_batch]
            del self._pending[:len(batch)]
            return batch, idle

    def _flush(self, batch: list[_Pending], idle: bool = False) -> None:
        """One batched probe for the batch; scatter + cache-fill.

        The probe takes exactly the batch's b predicates (nothing is
        padded). Entries stay in ``_inflight`` until their cache fill, so
        duplicate submitters racing this flush piggyback instead of
        re-probing. While ``torch.profiler`` records, the flush is a
        ``coalescer.flush`` range on its trace.

        Probe dispatch runs under the retry policy (transient failures
        back off and retry) behind the circuit breaker; ``FlusherKill``
        and other ``BaseException``s escape to ``_run``'s death handler.
        """
        with profiled_range("coalescer.flush"):
            self._flush_batch(batch, idle)

    def _flush_batch(self, batch: list[_Pending], idle: bool) -> None:
        t_ns = time.perf_counter_ns()
        b = len(batch)
        embs = np.stack([p.emb for p in batch])
        thrs = np.asarray([p.thr for p in batch], np.float32)
        tr = self.obs.tracer
        flush_id = tr.next_id() if tr is not None else None
        t_dq = time.monotonic()
        for p in batch:
            p.qw_s = t_dq - p.ts
        err, attempt, probe_s, timed = None, 0, 0.0, None
        # bind the flush id on this (flusher) thread so index-layer scan
        # spans correlate to this flush without touching probe signatures
        set_flush_ctx(flush_id)
        try:
            while True:
                if not self.breaker.allow():
                    err = BreakerOpenError("probe circuit breaker is open")
                    break
                t0 = time.perf_counter()
                self._tls.timed = None
                try:
                    counts, topk = self._probe(embs, thrs)
                    self.breaker.record_success()
                    probe_s = time.perf_counter() - t0
                    self.watchdog.observe(probe_s)
                    timed = self._tls.timed
                    break
                except Exception as e:  # noqa: BLE001 — classified below
                    self.breaker.record_failure()
                    self._c["probe_failures"].inc()
                    if (not self.retry.policy.transient(e)
                            or attempt >= self.retry.max_retries
                            or self._stop):
                        err = e
                        break
                    self._c["retries"].inc()
                    self.obs.event("retry", flush=flush_id,
                                   attempt=attempt,
                                   error=type(e).__name__)
                    if self.retry.on_retry is not None:
                        self.retry.on_retry(attempt, e)
                    time.sleep(self.retry.delay_s(attempt))
                    attempt += 1
        finally:
            set_flush_ctx(None)
        if err is None:
            self._c["probes_fired"].inc()
            self._c["predicates_probed"].inc(b)
            if idle:
                self._idle_flushes.inc()
        t_sc = time.monotonic()
        for i, p in enumerate(batch):
            if err is None:
                p.value = (counts[i].copy(), topk[i].copy())
                self.cache.put(p.key, p.value)
                p.probe_s = probe_s
            else:
                p.error = err
            with self._cv:
                self._inflight.pop(p.key, None)
            p.set_ns = time.perf_counter_ns()
            p.event.set()
        # the device time of a successful attempt that was one launch, read
        # once the waiters are released (the events completed before the
        # host copy); telemetry, so a pair that cannot be read is left out
        device_ms = None
        if err is None and timed is not None:
            try:
                device_ms = timed[0].elapsed_time(timed[1])
            except RuntimeError:
                pass
            else:
                self._device_ns.inc(round(device_ms * 1e6))
                self._device_timed.inc()
        if tr is not None:
            rec = {}
            if device_ms is not None:
                rec["device_ms"] = round(device_ms, 4)
            tr.emit("flush", flush=flush_id, t_ns=t_ns, batch=b,
                    queue_wait_ms=round(batch[0].qw_s * 1e3, 4),
                    probe_ms=round(probe_s * 1e3, 4), **rec,
                    combine_ms=round((time.monotonic() - t_sc) * 1e3, 4),
                    retries=attempt,
                    outcome="ok" if err is None else type(err).__name__)

    def _run(self) -> None:
        try:
            while True:
                taken = self._take_batch()
                if taken is None:
                    return
                self._flush(*taken)
        except BaseException as e:  # noqa: BLE001 — incl. FlusherKill
            self._on_flusher_death(e)

    def _on_flusher_death(self, exc: BaseException) -> None:
        """Fail every pending/in-flight waiter NOW; restart the flusher.

        ``_inflight`` is a superset of ``_pending`` (batches being flushed
        left ``_pending`` but not ``_inflight``), so draining it reaches
        every waiter, including the batch the death interrupted. Without
        this, those waiters would block forever.
        """
        with self._cv:
            self._c["flusher_deaths"].inc()
            victims = list(self._inflight.values())
            self._inflight.clear()
            self._pending.clear()
            restart = not self._stop
            if restart:
                self._c["flusher_restarts"].inc()
        self.obs.event("flusher_death", error=type(exc).__name__,
                       restarting=restart)
        err = FlusherDiedError(f"coalescer flusher died: {exc!r}")
        err.__cause__ = exc if isinstance(exc, Exception) else None
        for p in victims:
            if p.error is None and p.value is None:
                p.error = err
            p.event.set()
        if restart:
            self._flusher = self._spawn_flusher()

    # ---------------------------------------------------------- lifecycle

    def queue_depth(self) -> int:
        """Current pending-queue depth (fleet backpressure reads this)."""
        with self._cv:
            return len(self._pending)

    @property
    def alive(self) -> bool:
        """True while the flusher is running and the coalescer is open."""
        return not self._stop and self._flusher.is_alive()

    def kill(self, exc: BaseException | None = None) -> None:
        """Abrupt, permanent shutdown (chaos ``replica-kill``).

        Unlike ``close()`` this does NOT drain: the flusher is told to
        stop, every pending/in-flight waiter is failed immediately with
        ``FlusherDiedError``, and no replacement flusher is started
        (``_stop`` suppresses the restart). Submits after the kill fail
        fast via the dead-flusher guard in ``probe_outcomes``.
        """
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._on_flusher_death(
            exc if exc is not None else RuntimeError("replica killed"))

    def close(self) -> None:
        """Drain pending work and stop the flusher thread."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            flusher = self._flusher
        flusher.join(timeout=60.0)
        with self._cv:
            leftovers = self._pending[:]
            del self._pending[:]
        if leftovers:
            try:
                self._flush(leftovers)
            except BaseException as exc:  # noqa: BLE001 — fail, don't hang
                err = FlusherDiedError(
                    f"drain flush died during close: {exc!r}")
                for p in leftovers:
                    with self._cv:
                        self._inflight.pop(p.key, None)
                    if p.error is None and p.value is None:
                        p.error = err
                    p.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        # counters ARE the registry entries (coalescer.<name>) — one
        # source of truth for this dict, the exit summary, the trace
        # summary record, and --metrics-json
        d = {name: self._c[name].value for name in self._COUNTERS}
        d["queue_depth_hwm"] = int(self._hwm.value)
        d["flush_ewma_s"] = self.watchdog.ewma_s
        d["breaker"] = self.breaker.stats()
        d["cache"] = self.cache.stats()
        if self.chaos is not None:
            d["chaos"] = self.chaos.stats()
        return d

"""The port's serving control plane, mirroring ``tests/test_robustness.py``
(without its sharded case): deadlines, admission control, retry + circuit
breaker around the probe, bound-only degradation and flusher-death
propagation, exercised by the port's seeded chaos harness.

The load-bearing invariants, as in the reference:

  * reconciliation — ``requests == probe_scored + cache_hits +
    coalesced_dups + shed + degraded + errors`` after every scenario;
  * no hangs — a dead flusher or a blown deadline fails or degrades its
    waiters promptly;
  * degraded never wrong — a bound-only answer is a certified interval
    that contains the true selectivity.

The chaos configuration and its injection sequence are the reference's for
the same seed."""

import functools
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import chaos as jax_chaos  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro_torch.index import build_clustered_store  # noqa: E402
from repro_torch.launch import chaos as port_chaos  # noqa: E402
from repro_torch.launch.chaos import (  # noqa: E402
    ChaosConfig,
    ChaosInjector,
    ChaosProbeError,
    FlusherKill,
)
from repro_torch.launch.coalescer import (  # noqa: E402
    BreakerOpenError,
    CoalescerConfig,
    DeadlineExceededError,
    FlusherDiedError,
    PredicateCoalescer,
    ProbeOutcome,
    ShedError,
)
from repro_torch.obs import ObsHub, Tracer  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    CircuitBreaker,
    FaultPolicy,
    RetryPolicy,
    StepWatchdog,
    TransientError,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see test_torch_coalescer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@functools.lru_cache(maxsize=1)
def _rows():
    return _unit_rows(np.random.default_rng(0), 300, 32)


def _hist(x, **kw):
    return SemanticHistogram(torch.from_numpy(x), **kw)


@functools.lru_cache(maxsize=None)
def _indexed(n, k, seed):
    """(rows, ClusteredStore) over clustered rows, on the CPU."""
    x, _ = clustered_unit_vectors(n, 32, n_centers=8, spread=0.2, seed=seed)
    return x, build_clustered_store(torch.from_numpy(x), k, iters=4, seed=0)


def _assert_reconciles(st):
    resolved = (st["probe_scored"] + st["cache_hits"] + st["coalesced_dups"]
                + st["shed"] + st["degraded"] + st["errors"])
    assert st["requests"] == resolved, st


def _hold_first_probe(hist):
    """Hold ``hist.probe_batch``'s first call in flight (the flusher busy):
    ``in_flight`` is set once it is held, and it proceeds when ``release``
    is set; later calls pass straight through. Returns (in_flight,
    release)."""
    in_flight, release = threading.Event(), threading.Event()
    orig = hist.probe_batch

    def probe_batch(*a, **kw):
        if not in_flight.is_set():
            in_flight.set()
            release.wait(timeout=30)
        return orig(*a, **kw)

    hist.probe_batch = probe_batch
    return in_flight, release


def _wait_until(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition never became true")
        time.sleep(0.002)


# ----------------------------------------------------------- config / spec


def test_coalescer_config_validates_up_front():
    for bad in (dict(max_batch=0), dict(window_ms=0.0),
                dict(cache_capacity=0), dict(max_queue=-1),
                dict(max_pending_age_ms=-0.1), dict(deadline_ms=-5.0)):
        with pytest.raises(ValueError):
            CoalescerConfig(**bad)
    cfg = CoalescerConfig()         # robustness knobs default off
    assert cfg.max_queue == 0 and cfg.deadline_ms == 0.0
    assert not cfg.degraded_ok


@pytest.mark.parametrize("spec", [
    "seed=3,fail=0.25,delay=0.5,delay-ms=7,kill-at=2", "",
    "seed=1,fail=0.3,delay=0.2,delay-ms=5,kill-at=3"])
def test_chaos_spec_parses_as_the_reference(spec):
    cfg, ref = ChaosConfig.parse(spec), jax_chaos.ChaosConfig.parse(spec)
    assert [getattr(cfg, f) for f in ("seed", "fail_rate", "delay_rate",
                                      "delay_ms", "kill_flusher_at")] == \
        [getattr(ref, f) for f in ("seed", "fail_rate", "delay_rate",
                                   "delay_ms", "kill_flusher_at")]


def test_chaos_spec_validates():
    assert ChaosConfig.parse("seed=3,fail=0.25,delay=0.5,delay-ms=7,"
                             "kill-at=2") == ChaosConfig(
        seed=3, fail_rate=0.25, delay_rate=0.5, delay_ms=7.0,
        kill_flusher_at=2)
    with pytest.raises(ValueError, match="unknown chaos key"):
        ChaosConfig.parse("frobnicate=1")
    with pytest.raises(ValueError, match="key=value"):
        ChaosConfig.parse("fail")
    with pytest.raises(ValueError, match="fail_rate"):
        ChaosConfig.parse("fail=1.5")


@pytest.mark.parametrize("seed", [1, 11, 12])
def test_chaos_injection_sequence_is_the_references(seed):
    """Launch by launch the same faults as the reference's injector for the
    same seed: failures, delays (0 ms here) and the kill."""
    def run(mod):
        inj = mod.ChaosInjector(mod.ChaosConfig(
            seed=seed, fail_rate=0.4, delay_rate=0.3, kill_flusher_at=7))
        fn = inj.wrap(lambda: "ok")
        seq = []
        for _ in range(40):
            try:
                seq.append(fn())
            except mod.ChaosProbeError:
                seq.append("fail")
            except mod.FlusherKill:
                seq.append("kill")
        return seq, inj.stats()

    seq, st = run(port_chaos)
    ref, st_ref = run(jax_chaos)
    assert seq == ref and st == st_ref
    assert seq[6] == "kill" and "fail" in seq
    assert st["injected_failures"] == seq.count("fail")


def test_fault_tolerance_vocabulary():
    assert FaultPolicy().transient(ChaosProbeError("x"))
    assert not FaultPolicy().transient(RuntimeError("cuda launch"))
    assert not isinstance(FlusherKill(), Exception)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("again")
        return "done"

    slept = []
    assert RetryPolicy(max_retries=2, base_delay_s=0.01).call(
        flaky, sleep=slept.append) == "done"
    assert slept == [0.01, 0.02]
    wd = StepWatchdog()
    assert [wd.observe(s) for s in (1.0, 1.0, 3.0, 20.0)] == \
        ["ok", "ok", "straggler", "stuck"]
    assert wd.stragglers == 1 and wd.deadline() == pytest.approx(
        10 * wd.ewma_s)


# ----------------------------------------------------- certified bounds


def test_clustered_count_bounds_contain_true_counts():
    x, cs = _indexed(2000, 16, 0)
    hist = _hist(x)
    preds = x[[3, 700, 1500]]
    thrs = np.asarray([0.3, 0.6, 1.0], np.float32)
    lo, hi = cs.count_bounds(preds, thrs)
    assert lo.shape == hi.shape == (3, 1)
    assert (lo <= hi).all() and (lo >= 0).all() and (hi <= len(x)).all()
    for i in range(3):
        true = hist.count_within(preds[i], float(thrs[i]))
        assert lo[i, 0] <= true <= hi[i, 0], (i, lo[i, 0], true, hi[i, 0])
    assert (lo > 0).any() or (hi < len(x)).any()


def test_selectivity_bounds_with_and_without_index():
    x, cs = _indexed(1500, 12, 2)
    indexed = _hist(x, index=cs)
    plain = _hist(x)
    preds = x[[5, 900]]
    thrs = np.asarray([0.4, 0.8], np.float32)
    lo, hi = indexed.selectivity_bounds(preds, thrs)
    true = plain.selectivity_batch(preds, thrs)
    assert (0.0 <= lo).all() and (hi <= 1.0).all()
    assert (lo <= true + 1e-12).all() and (true <= hi + 1e-12).all()
    lo0, hi0 = plain.selectivity_bounds(preds, thrs)
    assert (lo0 == 0.0).all() and (hi0 == 1.0).all()


# ------------------------------------------------- flusher-death handling


def test_flusher_death_fails_waiters_and_restarts():
    x = _rows()
    hist = _hist(x)
    chaos = ChaosInjector(ChaosConfig(kill_flusher_at=1))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=1, window_ms=10),
            chaos=chaos) as coal:
        t0 = time.monotonic()
        with pytest.raises(FlusherDiedError):
            coal.selectivity(x[0], 0.8)
        assert time.monotonic() - t0 < 10, "a waiter must not hang"
        sel = coal.selectivity(x[1], 0.8)
        st = coal.stats()
    assert sel == hist.selectivity(x[1], 0.8)
    assert st["flusher_deaths"] == 1 and st["flusher_restarts"] == 1
    assert st["errors"] == 1 and st["probe_scored"] == 1
    assert st["chaos"]["injected_kills"] == 1
    _assert_reconciles(st)


def test_flusher_death_mid_window_fails_all_waiters():
    """Three waiters pend behind a flush held in flight and go in the
    next flush together; the flusher dies on that launch and every one of
    them fails at once."""
    x = _rows()
    hist = _hist(x)
    in_flight, release = _hold_first_probe(hist)
    chaos = ChaosInjector(ChaosConfig(kill_flusher_at=2))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=3, window_ms=10_000),
            chaos=chaos) as coal:
        outcomes = {}

        def worker(i):
            try:
                coal.selectivity(x[i], 0.8)
                outcomes[i] = "value"
            except FlusherDiedError:
                outcomes[i] = "died"

        t0 = time.monotonic()
        busy = threading.Thread(target=worker, args=(9,))
        busy.start()
        assert in_flight.wait(timeout=10)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        _wait_until(lambda: coal.queue_depth() == 3)
        release.set()
        for t in threads + [busy]:
            t.join(timeout=30)
        elapsed = time.monotonic() - t0
        st = coal.stats()
    assert elapsed < 25, "death must propagate, not wait out any timeout"
    assert [outcomes[i] for i in range(3)] == ["died"] * 3
    assert outcomes[9] == "value"
    assert st["errors"] == 3 and st["flusher_deaths"] == 1
    _assert_reconciles(st)


def test_flusher_death_at_first_launch_fails_concurrent_waiters():
    """Concurrent calls on an idle flusher that dies at its first launch:
    the first call's flush is taken at once and dies, the other calls
    pend behind it, and every waiter fails at once; the restarted flusher
    then answers."""
    x = _rows()
    hist = _hist(x)
    chaos = ChaosInjector(ChaosConfig(kill_flusher_at=1))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=8, window_ms=10_000),
            chaos=chaos) as coal:
        outcomes = {}

        def worker(i):
            try:
                coal.selectivity_batch(x[2 * i:2 * i + 2],
                                       np.full(2, 0.8, np.float32))
                outcomes[i] = "value"
            except FlusherDiedError:
                outcomes[i] = "died"

        t0 = time.monotonic()
        # the first launch waits at the injector's lock until the other
        # calls pend, so all three meet the death
        with chaos._lock:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(3)]
            threads[0].start()
            # the flusher took the first call's two predicates (stats()
            # would wait for the injector's lock: read the registry)
            _wait_until(lambda: coal.obs.registry.snapshot()["counters"]
                        ["coalescer.requests"] == 2
                        and coal.queue_depth() == 0)
            for t in threads[1:]:
                t.start()
            _wait_until(lambda: coal.queue_depth() == 4)
        for t in threads:
            t.join(timeout=30)
        elapsed = time.monotonic() - t0
        sel = coal.selectivity(x[9], 0.8)
        st = coal.stats()
    assert elapsed < 25, "death must propagate, not wait out any timeout"
    assert outcomes == {0: "died", 1: "died", 2: "died"}
    assert sel == hist.selectivity(x[9], 0.8)
    assert st["errors"] == 6 and st["probe_scored"] == 1
    assert st["flusher_deaths"] == 1 and st["flusher_restarts"] == 1
    assert st["chaos"]["injected_kills"] == 1
    _assert_reconciles(st)


def test_flusher_death_with_degraded_ok_answers_from_bounds():
    x = _rows()
    hist = _hist(x)
    chaos = ChaosInjector(ChaosConfig(kill_flusher_at=1))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=1, window_ms=10),
            chaos=chaos) as coal:
        (o,) = coal.probe_outcomes(x[:1], np.asarray([0.8]),
                                   degraded_ok=True)
        st = coal.stats()
    assert o.degraded and o.lo == 0.0 and o.hi == 1.0   # no index: trivial
    assert o.lo <= o.sel <= o.hi and o.bucket == "degraded"
    assert st["degraded"] == 1 and st["errors"] == 0
    _assert_reconciles(st)


# -------------------------------------------------- deadlines & admission


def test_deadline_degrades_to_bounds_instead_of_waiting():
    x, cs = _indexed(1000, 12, 3)
    hist = _hist(x, index=cs)
    plain = _hist(x)
    chaos = ChaosInjector(ChaosConfig(delay_rate=1.0, delay_ms=800.0))
    preds = x[:2]
    thrs = np.asarray([0.5, 0.9], np.float32)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=2, window_ms=10),
            chaos=chaos) as coal:
        t0 = time.monotonic()
        outs = coal.probe_outcomes(
            preds, thrs, deadline=time.monotonic() + 0.08, degraded_ok=True)
        elapsed = time.monotonic() - t0
        st = coal.stats()
    assert elapsed < 0.6, "the deadline must cut the wait"
    true = plain.selectivity_batch(preds, thrs)
    for o, t in zip(outs, true):
        assert o.degraded
        assert o.lo - 1e-12 <= t <= o.hi + 1e-12
        assert o.lo <= o.sel <= o.hi
    assert st["degraded"] == 2
    _assert_reconciles(st)


def test_deadline_without_degraded_ok_raises_and_reconciles():
    x = _rows()
    hist = _hist(x)
    chaos = ChaosInjector(ChaosConfig(delay_rate=1.0, delay_ms=800.0))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=2, window_ms=10),
            chaos=chaos) as coal:
        with pytest.raises(DeadlineExceededError):
            coal.probe_outcomes(x[:2], np.full(2, 0.8, np.float32),
                                deadline=time.monotonic() + 0.05)
        _wait_until(lambda: coal.stats()["errors"] == 2)
        st = coal.stats()
    assert st["errors"] == 2 and st["requests"] == 2
    _assert_reconciles(st)


def test_admission_control_sheds_over_watermark():
    """Behind a flush held in flight one predicate pends, which reaches
    the watermark: the next two are shed."""
    x = _rows()
    hist = _hist(x)
    in_flight, release = _hold_first_probe(hist)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=64, window_ms=10_000,
                                  max_queue=1)) as coal:
        held, done = [], []
        busy = threading.Thread(target=lambda: held.append(
            coal.selectivity(x[9], 0.8)))
        busy.start()
        assert in_flight.wait(timeout=10)
        t = threading.Thread(target=lambda: done.append(
            coal.selectivity(x[0], 0.8)))
        t.start()
        _wait_until(lambda: coal.queue_depth() == 1)
        (o,) = coal.probe_outcomes(x[1:2], np.asarray([0.8]),
                                   degraded_ok=True)
        assert o.degraded and o.bucket == "shed"
        with pytest.raises(ShedError):
            coal.probe_outcomes(x[2:3], np.asarray([0.8]))
        release.set()
        t.join(timeout=30)
        busy.join(timeout=30)
        st = coal.stats()
    assert held and held[0] == hist.selectivity(x[9], 0.8)
    assert done and done[0] == hist.selectivity(x[0], 0.8)
    assert st["shed"] == 2 and st["queue_depth_hwm"] == 1
    assert st["probe_scored"] == 2
    _assert_reconciles(st)


def test_unreachable_deadline_sheds_without_queueing():
    x = _rows()
    hist = _hist(x)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=4, window_ms=10)) as coal:
        coal.watchdog.ewma_s = 10.0     # pretend flushes take 10 s
        (o,) = coal.probe_outcomes(x[:1], np.asarray([0.8]),
                                   deadline=time.monotonic() + 0.05,
                                   degraded_ok=True)
        st = coal.stats()
    assert o.degraded
    assert st["shed"] == 1 and st["probes_fired"] == 0
    _assert_reconciles(st)


# ------------------------------------------------------- retry & breaker


def test_transient_probe_failures_are_retried():
    x = _rows()
    hist = _hist(x)
    orig = hist.probe_batch
    state = {"left": 2}

    def flaky(*a, **kw):
        if state["left"] > 0:
            state["left"] -= 1
            raise TransientError("flaky dependency")
        return orig(*a, **kw)

    hist.probe_batch = flaky
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=1, window_ms=10),
            retry=RetryPolicy(max_retries=2, base_delay_s=0.001)) as coal:
        sel = coal.selectivity(x[0], 0.8)
        st = coal.stats()
    hist.probe_batch = orig
    assert sel == hist.selectivity(x[0], 0.8)
    assert st["retries"] == 2 and st["probe_failures"] == 2
    assert st["probes_fired"] == 1 and st["errors"] == 0
    _assert_reconciles(st)


def test_breaker_trips_fast_fails_then_recovers():
    x = _rows()
    hist = _hist(x)
    orig = hist.probe_batch
    state = {"boom": True}

    def flaky(*a, **kw):
        if state["boom"]:
            raise TransientError("dependency down")
        return orig(*a, **kw)

    hist.probe_batch = flaky
    clk = {"t": 0.0}
    breaker = CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                             clock=lambda: clk["t"])
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=1, window_ms=10),
            retry=RetryPolicy(max_retries=0), breaker=breaker) as coal:
        for i in range(2):
            with pytest.raises(TransientError):
                coal.selectivity(x[i], 0.8)
        assert breaker.stats()["state"] == "open"
        (o,) = coal.probe_outcomes(x[2:3], np.asarray([0.8]),
                                   degraded_ok=True)
        assert o.degraded
        with pytest.raises(BreakerOpenError):
            coal.probe_outcomes(x[3:4], np.asarray([0.8]))
        clk["t"] = 10.0
        state["boom"] = False
        sel = coal.selectivity(x[4], 0.8)
        st = coal.stats()
    hist.probe_batch = orig
    assert sel == hist.selectivity(x[4], 0.8)
    assert st["breaker"]["state"] == "closed"
    assert st["breaker"]["opens"] == 1
    assert st["breaker_fastfails"] == 2
    assert st["degraded"] == 1 and st["errors"] == 3
    assert st["probe_scored"] == 1
    _assert_reconciles(st)


# ----------------------------------------------------- planner integration


def test_plan_query_marks_degraded_plans():
    from repro_torch.configs.paper_stack import SpecificityModelConfig
    from repro_torch.core.estimators import SpecificityEstimator
    from repro_torch.core.optimizer import _mark_degraded, plan_query
    from repro_torch.core.specificity import SpecificityModel, SpecificityMLP
    from repro_torch.core.synthetic import make_corpus

    c = make_corpus("wildlife", n_images=400, dim=64, seed=0)
    hist = _hist(c.images)
    torch.manual_seed(0)
    cfg = SpecificityModelConfig(embed_dim=64)
    est = SpecificityEstimator(c, hist,
                               SpecificityModel(SpecificityMLP(cfg), cfg))
    filters = c.predicate_nodes()[:3]
    chaos = ChaosInjector(ChaosConfig(delay_rate=1.0, delay_ms=500.0))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=3, window_ms=10),
            chaos=chaos) as coal:
        t0 = time.monotonic()
        plan = plan_query(filters, est, seed=0, coalescer=coal,
                          deadline_ms=40.0, degraded_ok=True)
        elapsed = time.monotonic() - t0
    assert elapsed < 2.0
    assert plan.degraded
    for e in plan.estimates:
        assert e.extra.get("degraded") is True
        lo, hi = e.extra["sel_interval"]
        assert 0.0 <= lo <= hi <= 1.0
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=3, window_ms=10)) as coal:
        plan2 = plan_query(filters, est, seed=0, coalescer=coal)
    assert not plan2.degraded
    assert all("sel_interval" not in e.extra for e in plan2.estimates)
    with pytest.raises(RuntimeError, match="cannot reconcile"):
        _mark_degraded(plan2.estimates, [ProbeOutcome(0.5, 0, 1, True)])


# -------------------------------------------------------- chaos scenarios


@pytest.mark.chaos
def test_chaos_reconciliation_under_injected_failures():
    """8 threads x 3 predicates through a 40%-failure probe path: every
    request resolves, counters reconcile, exact answers equal the plain
    histogram's, degraded intervals contain them."""
    x, cs = _indexed(500, 10, 4)
    hist = _hist(x, index=cs)
    plain = _hist(x)
    chaos = ChaosInjector(ChaosConfig(seed=7, fail_rate=0.4))
    n_threads, per = 8, 3
    thr = np.full(per, 0.8, np.float32)
    outs = {}
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=8, window_ms=20,
                                  degraded_ok=True),
            chaos=chaos,
            retry=RetryPolicy(max_retries=1, base_delay_s=0.001)) as coal:

        def worker(i):
            outs[i] = coal.probe_outcomes(x[per * i:per * (i + 1)], thr)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        st = coal.stats()

    assert len(outs) == n_threads, "a worker never resolved"
    true = plain.selectivity_batch(x[:n_threads * per],
                                   np.full(n_threads * per, 0.8, np.float32))
    n_degraded = 0
    for i in range(n_threads):
        for j, o in enumerate(outs[i]):
            t = true[per * i + j]
            if o.degraded:
                n_degraded += 1
                assert o.lo - 1e-12 <= t <= o.hi + 1e-12
            else:
                assert o.sel == t
    assert st["requests"] == n_threads * per
    assert st["errors"] == 0
    assert st["degraded"] == n_degraded
    assert st["chaos"]["injected_failures"] >= 1, "chaos must bite"
    _assert_reconciles(st)


@pytest.mark.chaos
def test_chaos_sweep_is_hang_free_and_lossless():
    """Failures + delays + a flusher kill under config deadlines and
    degraded_ok: every call returns within deadline + grace, nothing is
    dropped, counters reconcile, intervals contain the truth."""
    x, cs = _indexed(1000, 12, 5)
    hist = _hist(x, index=cs)
    plain = _hist(x)
    chaos = ChaosInjector(ChaosConfig(seed=1, fail_rate=0.3, delay_rate=0.3,
                                      delay_ms=30.0, kill_flusher_at=5))
    n_threads, calls, per = 8, 4, 2
    deadline_s, grace_s = 0.5, 2.0
    results: dict[tuple, list] = {}
    slow_calls = []
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=8, window_ms=20,
                                  deadline_ms=deadline_s * 1e3,
                                  degraded_ok=True),
            chaos=chaos,
            retry=RetryPolicy(max_retries=1, base_delay_s=0.001)) as coal:

        def worker(i):
            for c in range(calls):
                base = (i * calls + c) * per
                t0 = time.monotonic()
                outs = coal.probe_outcomes(
                    x[base:base + per], np.full(per, 0.8, np.float32))
                dt = time.monotonic() - t0
                if dt > deadline_s + grace_s:
                    slow_calls.append((i, c, dt))
                results[(i, c)] = outs

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        st = coal.stats()

    assert not slow_calls, f"calls blew deadline + grace: {slow_calls}"
    assert len(results) == n_threads * calls, "dropped calls"
    n = n_threads * calls * per
    true = plain.selectivity_batch(x[:n], np.full(n, 0.8, np.float32))
    for (i, c), outs in results.items():
        assert len(outs) == per and all(o is not None for o in outs)
        for j, o in enumerate(outs):
            t = true[(i * calls + c) * per + j]
            if o.degraded:
                assert o.lo - 1e-12 <= t <= o.hi + 1e-12
            else:
                assert o.sel == t
    assert st["requests"] == n and st["errors"] == 0
    assert st["flusher_deaths"] >= 1, "the kill-at=5 launch must fire"
    assert st["flusher_restarts"] >= 1
    _assert_reconciles(st)


@pytest.mark.chaos
def test_chaos_storm_with_full_telemetry_reconciles(tmp_path):
    """The storm (failures + a flusher kill + restart) with the registry
    and a sample=1 tracer: ``stats()``, the registry counters, the submit
    spans and the JSONL summary agree exactly, and a sequential storm
    resolves bitwise the same with telemetry on and off."""
    x, cs = _indexed(600, 10, 6)
    n_threads, per = 6, 3
    thr = np.full(per, 0.8, np.float32)

    def storm(obs):
        hist = _hist(x, index=cs)
        chaos = ChaosInjector(ChaosConfig(seed=9, fail_rate=0.3,
                                          kill_flusher_at=2))
        outs = {}
        with PredicateCoalescer(
                hist, CoalescerConfig(max_batch=6, window_ms=20,
                                      degraded_ok=True),
                chaos=chaos,
                retry=RetryPolicy(max_retries=1, base_delay_s=0.001),
                obs=obs) as coal:

            def worker(i):
                outs[i] = coal.probe_outcomes(
                    x[per * i:per * (i + 1)], thr)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            st = coal.stats()
        return outs, st

    path = str(tmp_path / "storm.jsonl")
    tr = Tracer(path, sample=1)
    hub = ObsHub(tracer=tr)
    outs, st = storm(hub)
    hub.write_trace_summary(st)
    tr.close()

    assert len(outs) == n_threads
    assert st["requests"] == n_threads * per and st["errors"] == 0
    _assert_reconciles(st)
    if st["flusher_deaths"]:
        assert st["flusher_restarts"] >= 1
    counters = hub.registry.snapshot()["counters"]
    for name in ("requests", "probe_scored", "cache_hits",
                 "coalesced_dups", "shed", "degraded", "errors",
                 "retries", "probe_failures", "flusher_deaths",
                 "flusher_restarts", "probes_fired"):
        assert counters[f"coalescer.{name}"] == st[name], name
    sub = tr.submit_counts()
    assert sum(sub.values()) == st["requests"]
    for bucket, count in sub.items():
        assert st[bucket] == count, (bucket, sub, st)
    recs = [json.loads(line) for line in open(path)]
    summary = recs[-1]
    assert summary["kind"] == "summary"
    for name in ("requests", "probe_scored", "cache_hits",
                 "coalesced_dups", "shed", "degraded", "errors"):
        assert summary[name] == st[name], name
    assert summary["spans"].get("submit", 0) == st["requests"]
    if st["chaos"]["injected_failures"]:
        assert counters.get("events.chaos_fail", 0) \
            == st["chaos"]["injected_failures"]
    if st["flusher_deaths"]:
        assert counters["events.flusher_death"] == st["flusher_deaths"]

    def seq_storm(obs):
        hist = _hist(x, index=cs)
        chaos = ChaosInjector(ChaosConfig(seed=9, fail_rate=0.5,
                                          kill_flusher_at=2))
        with PredicateCoalescer(
                hist, CoalescerConfig(max_batch=per, window_ms=20,
                                      degraded_ok=True),
                chaos=chaos, retry=RetryPolicy(max_retries=0),
                obs=obs) as coal:
            outs = [coal.probe_outcomes(x[per * i:per * (i + 1)], thr)
                    for i in range(4)]
            return ([(o.sel, o.lo, o.hi, o.degraded)
                     for batch in outs for o in batch], coal.stats())

    tr2 = Tracer(str(tmp_path / "seq.jsonl"), sample=1)
    traced, st_a = seq_storm(ObsHub(tracer=tr2))
    tr2.close()
    plain, st_b = seq_storm(None)
    assert traced == plain, "results diverged under telemetry"
    assert any(d for *_, d in traced), "chaos must degrade some"
    for name in ("requests", "probe_scored", "degraded", "errors"):
        assert st_a[name] == st_b[name], name

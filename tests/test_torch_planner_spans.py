"""The planner's phase clock and the coalescer's wake counters, on the CPU.

``plan_query`` through a ``PredicateCoalescer`` with a hub folds every
plan's phases into the ``planner.*`` counters: each positive, one plan a
``planner.plans``, the phases nested inside the plan's wall. Without a
coalescer nothing binds and nothing is recorded, and the plans are bitwise
those planned through the instrumented coalescer. Under ``torch.profiler``
the phases are ``planner.*`` ranges inside the plan's ``planner.wall``, and
with every thread profiled the flush is a ``coalescer.flush`` range; a
profiler of one thread opens no range on the others. Every probe-resolved
wait counts one ``coalescer.wakes``, and only a wait that blocked adds to
``coalescer.wake_ns``. A probe's device time is counted only from a pair of
events the kernel recorded in that attempt, and a pair that cannot be read
costs the flusher nothing. Each plan's ``Corpus.vlm_answer`` calls count
in ``planner.vlm_answer_calls``, one a filter, and at a store large
against the KV-batch sample none builds a dense mask."""

import functools
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import phases  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.kernels.cosine_topk import kernel as probe_kernel  # noqa: E402
from repro_torch.core import optimizer as port_opt  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCoalescer,
)
from repro_torch.obs import ObsHub  # noqa: E402

COUNTERS = ("plans", "wall_ns", "probe_ns", "embed_ns", "mlp_ns",
            "calibration_ns", "vlm_answer_ns", "host_cpu_ns")
COUNTS = ("vlm_answer_calls", "vlm_answer_dense")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _stack():
    corpus, ests = serve.build_stack(
        "wildlife", n_images=600, sample=16, spec_steps=60, seed=0,
        device="cpu", vlm_smoke=True)
    queries = port_opt.generate_queries(corpus, n_queries=6, n_filters=3,
                                        seed=1)
    return corpus, ests["ensemble"], queries


def _coalescer(est, hub=None):
    return PredicateCoalescer(est.hist,
                              CoalescerConfig(max_batch=64, window_ms=4.0),
                              obs=hub if hub is not None else ObsHub())


def _planner(hub) -> dict:
    snap = hub.registry.snapshot()["counters"]
    return {k[len("planner."):]: v for k, v in snap.items()
            if k.startswith("planner.")}


def _run(est, queries, coal, threads=1):
    plans = [None] * len(queries)

    def plan(i):
        plans[i] = port_opt.plan_query(queries[i], est, seed=10 + i,
                                       coalescer=coal)

    for lo in range(0, len(queries), threads):
        ts = [threading.Thread(target=plan, args=(i,))
              for i in range(lo, min(lo + threads, len(queries)))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    return plans


@pytest.mark.parametrize("threads", [1, 3])
def test_every_planner_counter_records_each_plan(threads):
    _, est, queries = _stack()
    hub = ObsHub()
    with _coalescer(est, hub) as coal:
        _run(est, queries, coal, threads=threads)
    got = _planner(hub)
    assert set(got) == set(COUNTERS + COUNTS)
    assert got["plans"] == len(queries)
    assert got["vlm_answer_calls"] == sum(len(q) for q in queries)
    assert all(got[k] > 0 for k in COUNTERS), got
    # the phases nest inside the plans' wall time
    assert got["mlp_ns"] + got["calibration_ns"] + got["probe_ns"] \
        <= got["wall_ns"]
    assert got["vlm_answer_ns"] <= got["calibration_ns"]
    assert got["embed_ns"] + got["calibration_ns"] <= got["wall_ns"]


def test_without_a_coalescer_nothing_binds_and_the_plans_agree(monkeypatch):
    _, est, queries = _stack()
    bound = []
    inner = est.kvb._thresholds

    def spy(*a, **kw):
        bound.append(phases.current())
        return inner(*a, **kw)

    monkeypatch.setattr(est.kvb, "_thresholds", spy)
    hub = ObsHub()
    plain = [port_opt.plan_query(q, est, seed=10 + i)
             for i, q in enumerate(queries)]
    assert bound == [None] * len(queries)
    assert _planner(hub) == {}
    with _coalescer(est, hub) as coal:
        traced = _run(est, queries, coal)
    assert all(isinstance(c, phases.PhaseClock) for c in bound[len(queries):])
    assert phases.current() is None
    for a, b in zip(plain, traced):
        assert a.filter_order == b.filter_order
        assert [e.selectivity for e in a.estimates] == \
            [e.selectivity for e in b.estimates]
        assert [e.threshold for e in a.estimates] == \
            [e.threshold for e in b.estimates]


@functools.lru_cache(maxsize=None)
def _sized_stack():
    """A store of 4096 rows: enough that the KV-batch sample's binary
    search beats a dense mask for every node (as at the benchmark's 2^23)."""
    corpus, ests = serve.build_stack(
        "wildlife", n_images=4096, sample=16, spec_steps=60, seed=0,
        device="cpu", vlm_smoke=True)
    queries = port_opt.generate_queries(corpus, n_queries=4, n_filters=3,
                                        seed=2)
    return corpus, ests["ensemble"], queries


def test_vlm_answer_counts_each_filter_and_no_dense_mask():
    corpus, est, queries = _sized_stack()
    hub = ObsHub()
    with _coalescer(est, hub) as coal:
        port_opt.plan_query(queries[0], est, seed=20, coalescer=coal)
        first = _planner(hub)
        assert (first["vlm_answer_calls"], first["vlm_answer_dense"]) == \
            (len(queries[0]), 0)
        _run(est, queries[1:], coal, threads=3)
    got = _planner(hub)
    assert got["vlm_answer_calls"] == sum(len(q) for q in queries)
    assert got["vlm_answer_dense"] == 0
    # unbound, with no hub: nothing counts and nothing raises
    assert phases.current() is None
    port_opt.plan_query(queries[0], est, seed=30)
    corpus.vlm_answer(int(queries[0][0]), np.arange(len(corpus.images)))
    assert _planner(hub) == got


def _ranges(prof) -> dict:
    out: dict = {}
    for e in prof.events():
        if e.name.startswith(("planner.", "coalescer.")):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def test_profiled_phases_nest_inside_the_plan():
    _, est, queries = _stack()
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert not flag()
    with _coalescer(est) as coal:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert flag()
            port_opt.plan_query(queries[0], est, seed=3, coalescer=coal)
    assert not flag()
    got = _ranges(prof)
    names = {f"planner.{p}" for p in phases.PHASES}
    assert names <= set(got)
    (wall,) = got["planner.wall"]
    for name in names - {"planner.wall"}:
        for a, b in got[name]:
            assert wall[0] <= a <= b <= wall[1], name
    (cal,) = got["planner.calibration"]
    for a, b in got["planner.vlm_answer"]:
        assert cal[0] <= a <= b <= cal[1]


def test_profiling_every_thread_shows_the_flush():
    _, est, queries = _stack()
    with _coalescer(est) as coal:
        with phases.EveryThreadProfile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _run(est, queries[:3], coal, threads=3)
    got = _ranges(prof)
    assert len(got["planner.wall"]) == 3
    assert got.get("coalescer.flush")
    # each flush opens while some plan waits in the coalescer for it (its
    # range may close after the waiters it released have left)
    probes = got["planner.probe"]
    for a, b in got["coalescer.flush"]:
        assert a <= b
        assert any(p0 <= a <= p1 for p0, p1 in probes)


def test_wakes_count_the_probe_resolved_waits():
    _, est, queries = _stack()
    hub = ObsHub()
    with _coalescer(est, hub) as coal:
        _run(est, queries, coal, threads=3)
        _run(est, queries, coal, threads=3)       # all cache hits
        st = coal.stats()
    c = hub.registry.snapshot()["counters"]
    assert st["cache_hits"] >= 3 * len(queries)
    assert c["coalescer.wakes"] == st["probe_scored"] + st["coalesced_dups"]
    assert 0 < c["coalescer.blocked_wakes"] <= c["coalescer.wakes"]
    assert c["coalescer.wake_ns"] > 0
    # a CPU store takes no device time
    assert "probe.device_ns" not in c and "probe.device_timed" not in c


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_only_a_wait_that_blocked_adds_wake_time():
    """One call's six predicates land in one flush, which sets all six
    results while holding the interpreter: the call's first wait blocked
    until then, the other five began after their results were set. All
    six are wakes; only the first is a blocked wake."""
    x = _unit_rows(300, 16, 5)
    hist = SemanticHistogram(torch.from_numpy(x))
    hub = ObsHub()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        with PredicateCoalescer(
                hist, CoalescerConfig(max_batch=6, window_ms=10_000),
                obs=hub) as coal:
            coal.probe_outcomes(x[:6], np.full(6, 0.5, np.float32))
    finally:
        sys.setswitchinterval(interval)
    c = hub.registry.snapshot()["counters"]
    assert c["coalescer.wakes"] == 6
    assert c["coalescer.blocked_wakes"] == 1
    assert c["coalescer.wake_ns"] > 0


def test_a_profiler_of_one_thread_opens_no_range_on_the_others():
    """The harness's profiler records the thread that starts it: the
    planners' threads open no range it would drop."""
    _, est, queries = _stack()
    seen = []
    with _coalescer(est) as coal:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t = threading.Thread(target=lambda: seen.append(
                phases.profiled_range("planner.x")))
            t.start()
            t.join()
            _run(est, queries[:2], coal, threads=2)
    assert seen == [phases._NULL]
    assert not _ranges(prof)


class _OnCard:
    """A host histogram that reports a CUDA device: the coalescer arms the
    kernel's launch timing around its probes, which never reach the
    kernel."""

    device = torch.device("cuda")

    def __init__(self, hist):
        self._hist = hist

    def __getattr__(self, name):
        return getattr(self._hist, name)

    def probe_batch(self, *a, **kw):
        return self._hist.probe_batch(*a, **kw)


class _Pair:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        if self.ms is None:
            raise RuntimeError("event not recorded")
        return self.ms


@pytest.mark.parametrize("pair", ["none", "read", "unreadable"])
def test_device_time_counts_only_a_pair_the_kernel_recorded(pair,
                                                            monkeypatch):
    x = _unit_rows(300, 16, 4)
    hist = SemanticHistogram(torch.from_numpy(x))
    preds, thrs = x[:6], np.linspace(0.2, 0.8, 6).astype(np.float32)
    if pair != "none":
        ms = 1.5 if pair == "read" else None
        monkeypatch.setattr(probe_kernel, "timed_launch",
                            lambda: (_Pair(ms), _Pair(ms)))
    hub = ObsHub()
    cfg = CoalescerConfig(max_batch=3, window_ms=10_000)
    with PredicateCoalescer(_OnCard(hist), cfg, obs=hub) as coal:
        outs = []
        for lo in range(0, 6, 3):
            outs += coal.probe_outcomes(preds[lo:lo + 3], thrs[lo:lo + 3])
        st = coal.stats()
    c = hub.registry.snapshot()["counters"]
    counts, _ = hist.probe_batch(preds, thrs, k=1, use_cache=False)
    assert [o.sel for o in outs] == [int(n) / hist.n for n in counts[:, 0]]
    assert st["probes_fired"] == 2 and st["flusher_deaths"] == 0
    assert st["flusher_restarts"] == 0
    timed = 2 if pair == "read" else 0
    assert c["probe.device_timed"] == timed
    assert c["probe.device_ns"] == timed * 1_500_000


def test_counters_hold_under_many_threads_switching_often():
    """More planners than cores, switching as often as the interpreter
    can: no plan, wake or phase update is lost."""
    _, est, queries = _stack()
    many = (queries * 8)[:max(16, 2 * (os.cpu_count() or 1))]
    hub = ObsHub()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _coalescer(est, hub) as coal:
            plans = _run(est, many, coal, threads=len(many))
            st = coal.stats()
    finally:
        sys.setswitchinterval(interval)
    assert all(p is not None for p in plans)
    got = _planner(hub)
    c = hub.registry.snapshot()["counters"]
    assert got["plans"] == len(many)
    assert c["coalescer.wakes"] == st["probe_scored"] + st["coalesced_dups"]
    assert st["requests"] == sum(len(q) for q in many)
    assert got["mlp_ns"] + got["calibration_ns"] + got["probe_ns"] \
        <= got["wall_ns"]

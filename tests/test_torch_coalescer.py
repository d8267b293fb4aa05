"""The port's predicate coalescer and LRU cache against the reference's
(``repro.launch.coalescer``), mirroring ``tests/test_coalescer.py``.

Cache keys are equal to the reference's for the same inputs; an idle
flusher takes a call's predicates at once, calls that arrive behind a flush
in flight share the next probe, which holds no window and fires on size;
the coalescer deduplicates in-flight predicates, serves
repeats from the cache without probing and hands a probe error to every
waiter; a flush of b predicates probes exactly b rows (nothing is padded);
and ``plan_query(coalescer=)`` gives the reference's filter order and
selectivities on the same corpus and specificity weights, bitwise the
port's own uncoalesced plan."""

import functools
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_stack import SpecificityModelConfig as JaxCfg  # noqa: E402
from repro.core import estimators as jax_est  # noqa: E402
from repro.core import optimizer as jax_opt  # noqa: E402
from repro.core.histogram import SemanticHistogram as JaxHistogram  # noqa: E402
from repro.core.specificity import train_specificity  # noqa: E402
from repro.core.synthetic import make_corpus, specificity_dataset  # noqa: E402
from repro.launch import coalescer as jax_coal  # noqa: E402
from repro_torch.configs.paper_stack import SpecificityModelConfig  # noqa: E402
from repro_torch.core import estimators as port_est  # noqa: E402
from repro_torch.core import optimizer as port_opt  # noqa: E402
from repro_torch.core.estimators import Estimate  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.kvbatch import CompressedCacheStore  # noqa: E402
from repro_torch.core.specificity import specificity_model_from_numpy  # noqa: E402
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCache,
    PredicateCoalescer,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes at once; small torch ops would wait on descheduled
    threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _hist(x, **kw):
    return SemanticHistogram(torch.from_numpy(x), **kw)


@functools.lru_cache(maxsize=1)
def _rows():
    return _unit_rows(np.random.default_rng(0), 300, 32)


def _recorded(hist):
    """Wrap ``hist.probe_batch``: every call's (preds shape) is recorded."""
    calls, orig = [], hist.probe_batch

    def probe_batch(preds, thresholds, **kw):
        calls.append(np.asarray(preds).shape)
        return orig(preds, thresholds, **kw)

    hist.probe_batch = probe_batch
    return calls


def _hold_first_probe(hist):
    """Hold ``hist.probe_batch``'s first call in flight: ``in_flight`` is
    set once it is held, and it proceeds when ``release`` is set; later
    calls pass straight through. Returns (in_flight, release)."""
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


def _in_thread(fn, *args):
    """Run ``fn(*args)`` in a started thread; (thread, result list)."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args)))
    t.start()
    return t, out


# ------------------------------------------------------------------ cache


def test_cache_eviction_order_is_lru():
    cache = PredicateCache(2)
    e = _rows()[:3, :8]
    ka, kb, kc = (cache.key(e[i], [0.5], 1) for i in range(3))
    cache.put(ka, ("a",))
    cache.put(kb, ("b",))
    assert cache.get(ka) == ("a",)          # refresh a: b is now oldest
    cache.put(kc, ("c",))                   # evicts b, not a
    assert cache.evictions == 1
    assert cache.get(kb) is None
    assert cache.get(ka) == ("a",) and cache.get(kc) == ("c",)
    assert len(cache) == 2
    st = cache.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (3, 1, 2)


def test_cache_keys_equal_the_references():
    """``key``, ``observed_key`` and ``compound_key`` are the reference's,
    bit for bit, for the same inputs and bits (order-invariant compound)."""
    rng = np.random.default_rng(1)
    embs = _unit_rows(rng, 3, 16)
    for bits in (8, 12):
        port, ref = PredicateCache(8, bits=bits), \
            jax_coal.PredicateCache(8, bits=bits)
        for j in range(3):
            for thr, k, ver in (([0.5], 1, 0), ([0.25, 0.75], 7, 3)):
                assert port.key(embs[j], thr, k, version=ver) == \
                    ref.key(embs[j], thr, k, version=ver)
            assert port.observed_key(embs[j], version=2) == \
                ref.observed_key(embs[j], version=2)
        thr = np.asarray([0.4, 0.6, 0.8])
        for mode in ("and", "or"):
            key = port.compound_key(embs, thr, mode, version=5)
            assert key == ref.compound_key(embs, thr, mode, version=5)
            assert key == port.compound_key(embs[::-1], thr[::-1], mode,
                                            version=5)
    cache = PredicateCache(8, bits=8)
    assert cache.key(embs[0], [0.5], 1) == cache.key(embs[0] + 1e-5, [0.5],
                                                     1)
    assert cache.key(embs[0], [0.5], 1) != cache.key(embs[0], [0.5], 1,
                                                     version=1)


def test_observed_side_table_is_separate_from_probe_entries():
    cache = PredicateCache(2)
    e = _rows()[:3]
    cache.put(cache.key(e[0], [0.5], 1), ("probe",))
    for j in range(3):
        cache.put_observed(cache.observed_key(e[j]), 0.1 * j)
    assert cache.get_observed(cache.observed_key(e[0])) is None  # LRU'd out
    assert cache.get_observed(cache.observed_key(e[2])) == 0.2
    assert len(cache) == 1 and cache.stats()["observed"] == {
        "entries": 2, "hits": 1, "misses": 1}


def test_histogram_cache_hit_is_bitwise_the_fresh_probe():
    x = _rows()
    cached = _hist(x, cache=PredicateCache(64))
    plain = _hist(x)
    preds, thrs = x[:3], np.asarray([0.4, 0.8, 1.2], np.float32)
    first = cached.selectivity_batch(preds, thrs)
    hit = cached.selectivity_batch(preds, thrs)
    fresh = plain.selectivity_batch(preds, thrs)
    assert cached.cache.hits == 3 and cached.cache.misses == 3
    assert np.array_equal(first, fresh) and np.array_equal(hit, fresh)
    c1, t1 = cached.probe_batch(preds, thrs, k=7)
    c2, t2 = plain.probe_batch(preds, thrs, k=7)
    assert torch.equal(c1, c2) and torch.equal(t1, t2)


def test_histogram_cache_probes_exactly_the_misses():
    """3 hits + 2 misses: one probe of the 2 missing rows, no padding."""
    x = _rows()
    hist = _hist(x, cache=PredicateCache(64))
    thr5 = np.full(5, 0.9, np.float32)
    hist.selectivity_batch(x[:3], thr5[:3])
    calls = []
    orig = hist._probe_batched
    hist._probe_batched = lambda p, t, **kw: (calls.append(p.shape),
                                              orig(p, t, **kw))[1]
    mixed = hist.selectivity_batch(x[:5], thr5)
    assert calls == [(2, 32)]
    assert np.array_equal(mixed, _hist(x).selectivity_batch(x[:5], thr5))
    assert hist.cache.hits == 3 and hist.cache.misses == 5


# -------------------------------------------------------------- coalescer


def test_window_flushes_on_size():
    """Three calls that pend behind a flush in flight fill max_batch and
    fire in one probe of 6 as that flush ends — no window_ms wait."""
    x = _rows()
    hist = _hist(x)
    calls = _recorded(hist)
    in_flight, release = _hold_first_probe(hist)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=6, window_ms=30_000)) as coal:
        out = {}

        def worker(i):
            out[i] = coal.selectivity_batch(
                x[2 * i:2 * i + 2], np.full(2, 0.8, np.float32))

        t0 = time.monotonic()
        busy, _ = _in_thread(coal.selectivity, x[9], 0.8)
        assert in_flight.wait(timeout=10)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        _wait_until(lambda: coal.queue_depth() == 6)
        release.set()
        for t in threads + [busy]:
            t.join(timeout=30)
        elapsed = time.monotonic() - t0
        stats = coal.stats()
    assert elapsed < 25, "a size-triggered flush must not wait for window_ms"
    assert calls == [(1, 32), (6, 32)]
    assert stats["probes_fired"] == 2 and stats["predicates_probed"] == 7
    for i in range(3):
        assert np.array_equal(out[i], hist.selectivity_batch(
            x[2 * i:2 * i + 2], np.full(2, 0.8, np.float32)))


def test_lone_predicate_flushes_at_once_on_an_idle_card():
    """A lone predicate with max_batch to spare is probed at once by an
    idle flusher, far under window_ms, as an idle flush."""
    from repro_torch.obs import ObsHub

    x = _rows()
    hist = _hist(x)
    hub = ObsHub()
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=64, window_ms=30_000),
            obs=hub) as coal:
        t0 = time.monotonic()
        sel = coal.selectivity(x[7], 0.8)
        elapsed = time.monotonic() - t0
        stats = coal.stats()
    c = hub.registry.snapshot()["counters"]
    assert elapsed < 10, "an idle flusher must not wait for window_ms"
    assert stats["probes_fired"] == 1 and stats["predicates_probed"] == 1
    assert c["coalescer.idle_flushes"] == 1
    assert sel == hist.selectivity(x[7], 0.8)


def test_idle_coalescer_flushes_a_call_at_once():
    """An idle flusher holds no window: one call's four predicates go in
    one probe at once, far under window_ms, and it counts an idle flush."""
    from repro_torch.obs import ObsHub

    x = _rows()
    hist = _hist(x)
    calls = _recorded(hist)
    hub = ObsHub()
    thr = np.linspace(0.6, 0.9, 4).astype(np.float32)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=64, window_ms=30_000),
            obs=hub) as coal:
        t0 = time.monotonic()
        sels = coal.selectivity_batch(x[30:34], thr)
        elapsed = time.monotonic() - t0
    c = hub.registry.snapshot()["counters"]
    assert elapsed < 10, "an idle flusher must not wait for window_ms"
    assert calls == [(4, 32)]
    assert c["coalescer.probes_fired"] == 1
    assert c["coalescer.idle_flushes"] == 1
    assert np.array_equal(sels, hist.selectivity_batch(x[30:34], thr))


def test_calls_behind_a_flush_in_flight_share_the_next_probe():
    """Calls of 1 to 4 predicates that arrive while a flush is held in
    flight all go in the next single probe, which is not an idle flush."""
    from repro_torch.obs import ObsHub

    x = _rows()
    hist = _hist(x)
    calls = _recorded(hist)
    in_flight, release = _hold_first_probe(hist)
    hub = ObsHub()
    spans = [(40, 41), (41, 43), (43, 46), (46, 50)]
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=64, window_ms=30_000),
            obs=hub) as coal:
        busy, first = _in_thread(coal.selectivity, x[39], 0.8)
        assert in_flight.wait(timeout=10)
        runs = [_in_thread(coal.selectivity_batch, x[lo:hi],
                           np.full(hi - lo, 0.8, np.float32))
                for lo, hi in spans]
        _wait_until(lambda: coal.queue_depth() == 10)
        release.set()
        for t, _ in [(busy, first)] + runs:
            t.join(timeout=30)
    c = hub.registry.snapshot()["counters"]
    assert calls == [(1, 32), (10, 32)]
    assert c["coalescer.probes_fired"] == 2
    assert c["coalescer.idle_flushes"] == 1      # the held flush alone
    assert first == [hist.selectivity(x[39], 0.8)]
    for (lo, hi), (_, out) in zip(spans, runs):
        assert np.array_equal(out[0], hist.selectivity_batch(
            x[lo:hi], np.full(hi - lo, 0.8, np.float32)))


def test_inflight_duplicates_coalesce():
    x = _rows()
    hist = _hist(x)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=4, window_ms=150)) as coal:
        dup = np.stack([x[5], x[5], x[6], x[6]])
        sels = coal.selectivity_batch(dup, np.full(4, 0.8, np.float32))
        stats = coal.stats()
    assert stats["predicates_probed"] == 2      # only the unique pair
    assert stats["coalesced_dups"] == 2
    assert sels[0] == sels[1] and sels[2] == sels[3]
    assert [sels[0], sels[2]] == [hist.selectivity(x[5], 0.8),
                                  hist.selectivity(x[6], 0.8)]


def test_repeat_requests_hit_cache_without_probing():
    x = _rows()
    hist = _hist(x)
    calls = _recorded(hist)
    thr = np.full(4, 0.8, np.float32)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=4, window_ms=10_000)) as coal:
        first = coal.selectivity_batch(x[:4], thr)
        again = coal.selectivity_batch(x[:4], thr)
        stats = coal.stats()
    assert calls == [(4, 32)]                   # the second round: all hits
    assert stats["probes_fired"] == 1 and stats["cache"]["hits"] == 4
    assert np.array_equal(first, again)


def test_coalesced_cache_hit_is_bitwise_the_fresh_probe():
    """The values the flush cached are the fresh probe's, bit for bit."""
    x = _rows()
    hist = _hist(x)
    thr = np.linspace(0.5, 1.1, 5).astype(np.float32)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=5, window_ms=10_000)) as coal:
        coal.selectivity_batch(x[10:15], thr)
        cache = coal.cache
    c, t = hist.probe_batch(x[10:15], thr, k=1, use_cache=False)
    for j in range(5):
        hit = cache.get(cache.key(x[10 + j], [thr[j]], 1))
        assert np.array_equal(hit[0], c[j].numpy())
        assert np.array_equal(hit[1], t[j].numpy())


@pytest.mark.parametrize("b", [3, 5, 9])
def test_flush_probes_exactly_its_predicates(b, tmp_path):
    """A flush of b predicates probes a (b, d) batch — no power-of-two
    padding — and the flush span reports B = b."""
    import json

    from repro_torch.obs import ObsHub, Tracer

    x = _rows()
    hist = _hist(x)
    calls = _recorded(hist)
    tr = Tracer(str(tmp_path / "t.jsonl"))
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=b, window_ms=10_000),
            obs=ObsHub(tracer=tr)) as coal:
        sels = coal.selectivity_batch(x[20:20 + b],
                                      np.full(b, 0.8, np.float32))
    tr.close()
    assert calls == [(b, 32)]
    flush = [json.loads(line) for line in open(tmp_path / "t.jsonl")
             if '"flush"' in line]
    assert [f["batch"] for f in flush] == [b]
    assert np.array_equal(sels, hist.selectivity_batch(
        x[20:20 + b], np.full(b, 0.8, np.float32)))


def test_probe_error_reaches_every_waiter():
    """Three waiters pend behind a flush held in flight; the probe of
    their one flush raises, and each of them gets its error."""
    x = _rows()
    hist = _hist(x)
    in_flight, release = _hold_first_probe(hist)
    held = hist.probe_batch

    def boom(*a, **kw):
        if not in_flight.is_set():
            return held(*a, **kw)
        raise RuntimeError("probe exploded")

    hist.probe_batch = boom
    errors = []
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=3, window_ms=10_000)) as coal:

        def worker(i):
            try:
                coal.selectivity(x[i], 0.8)
            except RuntimeError as e:
                errors.append(str(e))

        busy, first = _in_thread(coal.selectivity, x[9], 0.8)
        assert in_flight.wait(timeout=10)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        _wait_until(lambda: coal.queue_depth() == 3)
        release.set()
        for t in threads + [busy]:
            t.join(timeout=30)
        st = coal.stats()
    assert first == [_hist(x).selectivity(x[9], 0.8)]
    assert errors == ["probe exploded"] * 3
    assert st["errors"] == 3 and st["probe_failures"] == 1


# --------------------------------------------------------- planner routing


@functools.lru_cache(maxsize=1)
def _stacks():
    """(corpus, reference estimators, port estimators) on the same corpus
    and specificity weights; the KV-batch machinery off on both sides (it
    does not change an estimate)."""
    corpus = make_corpus("wildlife", n_images=600, dim=96, seed=0)
    X, y = specificity_dataset(corpus, n_samples=600, seed=0)
    jax_model, _ = train_specificity(X, y, JaxCfg(embed_dim=96, steps=60))
    port_model = specificity_model_from_numpy(
        {k: np.asarray(v) for k, v in jax_model.params.items()},
        SpecificityModelConfig(embed_dim=96), device="cpu")
    ids = np.arange(0, 600, 40)

    def make(mod, hist, model, store):
        spec = mod.SpecificityEstimator(corpus, hist, model)
        kvb = mod.KVBatchEstimator(corpus, hist, store, run_machinery=False)
        return {"specificity": spec, "kvbatch": kvb,
                "ensemble": mod.EnsembleEstimator(spec, kvb)}

    ref = make(jax_est, JaxHistogram(jnp.asarray(corpus.images), impl="xla"),
               jax_model, SimpleNamespace(sample_ids=ids))
    port = make(port_est, SemanticHistogram(torch.from_numpy(corpus.images)),
                port_model, CompressedCacheStore(sample_ids=ids))
    return corpus, ref, port


@pytest.mark.parametrize("name", ["specificity", "kvbatch", "ensemble"])
def test_plan_query_through_the_coalescer_matches_the_reference(name):
    corpus, ref, port = _stacks()
    queries = port_opt.generate_queries(corpus, n_queries=4, n_filters=3,
                                        seed=1)
    est, est_ref = port[name], ref[name]
    with PredicateCoalescer(
            est.hist, CoalescerConfig(max_batch=3, window_ms=5)) as coal, \
            jax_coal.PredicateCoalescer(
                est_ref.hist, jax_coal.CoalescerConfig(
                    max_batch=3, window_ms=5)) as coal_ref:
        for q in queries:
            plan = port_opt.plan_query(q, est, seed=0, coalescer=coal)
            plan_ref = jax_opt.plan_query(q, est_ref, seed=0,
                                          coalescer=coal_ref)
            plain = port_opt.plan_query(q, est, seed=0)
            assert [int(f) for f in plan.filter_order] == \
                [int(f) for f in plan_ref.filter_order]
            assert plan.filter_order == plain.filter_order
            assert not plan.degraded
            for e, er, ep in zip(plan.estimates, plan_ref.estimates,
                                 plain.estimates):
                assert e.selectivity == ep.selectivity     # bitwise
                assert e.threshold == ep.threshold
                assert abs(e.selectivity - er.selectivity) <= 1e-6
        st, st_ref = coal.stats(), coal_ref.stats()
    for key in ("requests", "cache_hits", "coalesced_dups",
                "probe_scored", "predicates_probed"):
        assert st[key] == st_ref[key], key


def test_plan_query_routes_every_probe_through_the_coalescer():
    corpus, _, port = _stacks()
    est = port["specificity"]
    filters = corpus.predicate_nodes()[:4]
    baseline = port_opt.plan_query(filters, est, seed=0)
    direct = []
    orig = est.hist.selectivity_batch
    est.hist.selectivity_batch = lambda *a, **kw: (direct.append(1),
                                                   orig(*a, **kw))[1]
    try:
        with PredicateCoalescer(
                est.hist, CoalescerConfig(max_batch=4,
                                          window_ms=10_000)) as coal:
            plan = port_opt.plan_query(filters, est, seed=0, coalescer=coal)
            stats = coal.stats()
    finally:
        est.hist.selectivity_batch = orig
    assert direct == []
    assert stats["probes_fired"] == 1 and stats["requests"] == 4
    assert plan.filter_order == baseline.filter_order
    assert [e.selectivity for e in plan.estimates] == \
        [e.selectivity for e in baseline.estimates]


def test_plan_query_ignores_coalescer_for_scalar_estimators():
    class Scalar:
        name = "scalar"

        def estimate(self, node_id, seed=0):
            return Estimate({1: 0.9, 2: 0.1}[node_id], 0.0, 0.0)

    plan = port_opt.plan_query([1, 2], Scalar(), coalescer=object())
    assert plan.filter_order == [2, 1]


def test_ensemble_observed_cache_matches_the_reference():
    """Observed ground truth written back by ``observe`` answers the next
    ``estimate_batch`` and ``compound_selectivity`` first, as the
    reference's does; the correction follows ``feedback_alpha``."""
    corpus, ref, port = _stacks()
    queries = port_opt.generate_queries(corpus, n_queries=3, n_filters=3,
                                        seed=2)
    ens = port_est.EnsembleEstimator(
        port["specificity"], port["kvbatch"], feedback=True,
        observed_cache=PredicateCache(64), feedback_alpha=0.5)
    ens_ref = jax_est.EnsembleEstimator(
        ref["specificity"], ref["kvbatch"], feedback=True,
        observed_cache=jax_coal.PredicateCache(64), feedback_alpha=0.5)
    for q in queries:
        for e, opt in ((ens, port_opt), (ens_ref, jax_opt)):
            opt.execute_cascade(corpus, opt.plan_query(q, e, seed=0),
                                feedback=e)
    assert abs(ens._log_corr - ens_ref._log_corr) < 1e-9
    q = queries[0]
    got = ens.estimate_batch(q)
    want = ens_ref.estimate_batch(q)
    for e, er, node in zip(got, want, q):
        assert e.extra.get("observed") is True is er.extra.get("observed")
        assert e.selectivity == er.selectivity == \
            corpus.true_selectivity(node)
    thrs = [e.threshold for e in got[:2]]
    assert ens.compound_selectivity(q[:2], thrs) == \
        ens_ref.compound_selectivity(q[:2], thrs)
    assert ens.observed_cache.stats()["observed"]["hits"] == \
        ens_ref.observed_cache.stats()["observed"]["hits"]

"""The port's predicate coalescer and LRU cache against the reference's
(``repro.launch.coalescer``), mirroring ``tests/test_coalescer.py``.

Cache keys are equal to the reference's for the same inputs; the window
flushes on size and on timeout, deduplicates in-flight predicates, serves
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
    """max_batch pending predicates fire at once — no window_ms wait."""
    x = _rows()
    hist = _hist(x)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=6, window_ms=30_000)) as coal:
        out = {}

        def worker(i):
            out[i] = coal.selectivity_batch(
                x[2 * i:2 * i + 2], np.full(2, 0.8, np.float32))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        elapsed = time.monotonic() - t0
        stats = coal.stats()
    assert elapsed < 25, "a size-triggered flush must not wait for window_ms"
    assert stats["probes_fired"] == 1 and stats["predicates_probed"] == 6
    for i in range(3):
        assert np.array_equal(out[i], hist.selectivity_batch(
            x[2 * i:2 * i + 2], np.full(2, 0.8, np.float32)))


def test_window_flushes_on_timeout():
    x = _rows()
    hist = _hist(x)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=64, window_ms=30)) as coal:
        sel = coal.selectivity(x[7], 0.8)
        stats = coal.stats()
    assert stats["probes_fired"] == 1 and stats["predicates_probed"] == 1
    assert sel == hist.selectivity(x[7], 0.8)


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
    x = _rows()
    hist = _hist(x)

    def boom(*a, **kw):
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

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        st = coal.stats()
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

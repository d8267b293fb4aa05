"""The port's concurrent serve path (``serve_concurrent`` and the CLI's
concurrency, control-plane and telemetry flags) on the CPU.

``serve_concurrent`` at 4 threads and 2 passes reconciles its counters,
answers pass 2 from the cache alone, and gives every query the VLM calls
``serve_sequential`` gives it; ``--feedback`` q-error medians fall over the
passes to what the reference's own loop reaches (compared with the
reference's numbers, not with its red convergence test); under ingest the
cache keys on the store version and every entry at the final version is
bitwise a fresh probe; ``main`` writes ``--metrics-json`` and
``--trace-out`` files with the reference's schema. The KV-batch
machinery's one decode runs once, however many planners ask for it."""

import functools
import json
import sys
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
from repro.core.metrics import q_error  # noqa: E402
from repro.core.specificity import train_specificity  # noqa: E402
from repro.core.synthetic import make_corpus, specificity_dataset  # noqa: E402
from repro.launch import coalescer as jax_coal  # noqa: E402
from repro.obs import MetricsRegistry as RefRegistry  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro_torch.configs.paper_stack import SpecificityModelConfig  # noqa: E402
from repro_torch.core import estimators as port_est  # noqa: E402
from repro_torch.core import optimizer as port_opt  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.kvbatch import CompressedCacheStore  # noqa: E402
from repro_torch.core.specificity import specificity_model_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCache,
    PredicateCoalescer,
)

SERVE = dict(est_name="ensemble", seed=0, concurrency=4, window_ms=4.0,
             max_batch=64, cache_size=256, cache_bits=12)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see test_torch_coalescer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reconciles(st):
    return st["requests"] == sum(st[b] for b in (
        "probe_scored", "cache_hits", "coalesced_dups", "shed", "degraded",
        "errors"))


@functools.lru_cache(maxsize=None)
def _stack(ingest: bool):
    """The port's full serve stack on the CPU at a smoke size."""
    return serve.build_stack(
        "wildlife", n_images=600, sample=16, spec_steps=60, seed=0,
        device="cpu", vlm_smoke=True, index_clusters=8 if ingest else 0,
        ingest=ingest, rebuild_tail_frac=0.05)


def test_concurrent_passes_reconcile_and_pass_2_is_all_cache_hits():
    corpus, estimators = _stack(False)
    queries = port_opt.generate_queries(corpus, n_queries=6, n_filters=3,
                                        seed=0)
    run = serve.serve_concurrent(corpus, estimators, queries, passes=2,
                                 **SERVE)
    st = run.stats
    assert _reconciles(st) and not run.failures
    assert st["requests"] == 2 * 6 * 3
    assert st["errors"] == st["degraded"] == st["shed"] == 0
    first, second = run.passes
    assert _reconciles(first) and first["requests"] == 18
    assert first["predicates_probed"] == first["probe_scored"] > 0
    assert second["cache_hits"] == second["requests"] == 18
    assert second["probes_fired"] == 0
    assert st["predicates_probed"] == len({
        int(n) for q in queries for n in q})       # each predicate once
    seq = serve.serve_sequential(corpus, estimators, queries, seed=0)
    for p, qi, res in run.results:
        want = seq["ensemble"][qi]
        assert res.vlm_calls == want.vlm_calls, (p, qi)
        assert res.plan.filter_order == want.plan.filter_order
        assert [e.selectivity for e in res.plan.estimates] == \
            [e.selectivity for e in want.plan.estimates]     # bitwise


@functools.lru_cache(maxsize=1)
def _both_stacks():
    """(corpus, reference estimators, port estimator factory) on the same
    corpus and specificity weights, the KV-batch machinery off."""
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
                "ensemble": mod.EnsembleEstimator(spec, kvb),
                "oracle": mod.OracleEstimator(corpus)}

    ref = make(jax_est, JaxHistogram(jnp.asarray(corpus.images), impl="xla"),
               jax_model, SimpleNamespace(sample_ids=ids))

    def port():
        return make(port_est,
                    SemanticHistogram(torch.from_numpy(corpus.images)),
                    port_model, CompressedCacheStore(sample_ids=ids))

    return corpus, ref, port


def _medians(corpus, plans_by_pass):
    n = len(corpus.images)
    return [float(np.median([
        q_error(e.selectivity, corpus.true_selectivity(node), n)
        for plan in plans for node, e in zip(plan.filter_order,
                                             plan.estimates)]))
        for plans in plans_by_pass]


def _sequential_feedback(corpus, opt, ens, cache, queries, passes):
    ens.feedback, ens.observed_cache = True, cache
    by_pass = []
    for _ in range(passes):
        plans = []
        for q in queries:
            plan = opt.plan_query(q, ens, seed=0)
            opt.execute_cascade(corpus, plan, seed=0, feedback=ens)
            plans.append(plan)
        by_pass.append(plans)
    return _medians(corpus, by_pass)


def test_feedback_medians_fall_to_what_the_reference_reaches():
    """The reference's own loop (one plan after another, its red
    convergence test's protocol without the index): the port's sequential
    loop gives its medians within 1e-6, and the concurrent path's medians
    fall over the passes to the same final value. Concurrent planners of
    pass 1 cannot see each other's observations, so its first median may
    lie above the sequential one."""
    corpus, ref, make_port = _both_stacks()
    queries = port_opt.generate_queries(corpus, n_queries=6, n_filters=3,
                                        seed=2)
    want = _sequential_feedback(corpus, jax_opt, ref["ensemble"],
                                jax_coal.PredicateCache(256), queries, 3)
    got = _sequential_feedback(corpus, port_opt, make_port()["ensemble"],
                               PredicateCache(256), queries, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    run = serve.serve_concurrent(corpus, make_port(), queries, passes=3,
                                 feedback=True, **SERVE)
    assert _reconciles(run.stats) and not run.failures
    meds = _medians(corpus, [[r.plan for p, _, r in run.results if p == k]
                             for k in range(3)])
    assert meds[0] >= meds[1] >= meds[2]
    assert abs(meds[-1] - want[-1]) <= 1e-6
    assert run.cache.stats()["observed"]["hits"] > 0


def test_ingest_keys_the_cache_on_the_store_version():
    """Rows stream in while the workload runs: every plan resolves and the
    store moves on. After one more insert, a pass over the same cache
    misses every entry of the earlier versions and fills them at the final
    one, and each such entry is bitwise a fresh probe — and the plain
    version's scan of the live rows."""
    from repro_torch.kernels.cosine_topk.ref import cosine_probe_batch_ref

    corpus, estimators = _stack(True)
    est = estimators["ensemble"]
    hist, index = est.hist, est.hist.index
    queries = port_opt.generate_queries(corpus, n_queries=8, n_filters=3,
                                        seed=1)
    v0 = hist.version
    run = serve.serve_concurrent(corpus, estimators, queries, passes=2,
                                 ingest_rate=400.0, **SERVE)
    assert _reconciles(run.stats) and not run.failures
    assert hist.version > v0 and index.stats()["inserts"] > 0
    cache = run.cache
    assert len(cache) and max(key[3] for key in cache._od) <= hist.version
    index.insert(corpus.images[:1] * 0.5 + corpus.images[1:2] * 0.5)
    index.drain_rebuild(timeout=60)     # a rebuild the insert may start
    final = hist.version
    with PredicateCoalescer(hist, CoalescerConfig(max_batch=64,
                                                  window_ms=4.0),
                            cache=cache) as coal:
        plans = [port_opt.plan_query(q, est, seed=0, coalescer=coal)
                 for q in queries]
        st = coal.stats()
    nodes = {int(n) for q in queries for n in q}
    assert st["probe_scored"] == len(nodes)      # no stale entry served
    assert st["cache_hits"] + st["coalesced_dups"] + len(nodes) \
        == st["requests"]
    live = index.live_rows()
    seen = set()
    for plan in plans:
        for node, e in zip(plan.filter_order, plan.estimates):
            if node in seen:
                continue
            seen.add(node)
            pred = corpus.text_embedding(node)
            thr = np.asarray([e.threshold], np.float32)
            counts, topk = cache.get(cache.key(pred, thr, 1, version=final))
            assert e.selectivity == int(counts[0]) / hist.n
            fresh_c, fresh_t = hist.probe_batch(pred[None], thr[None], k=1,
                                                use_cache=False)
            full_c, full_t = cosine_probe_batch_ref(
                live, torch.from_numpy(pred[None]),
                torch.from_numpy(thr[None]), 1)
            for c, t in ((fresh_c, fresh_t), (full_c, full_t)):
                assert np.array_equal(counts, c[0].numpy())
                assert np.array_equal(topk, t[0].numpy())
    assert seen == nodes


def test_machinery_latency_runs_one_decode_for_many_planners(monkeypatch):
    calls = []

    def slow_decode(store, prompt):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return None, 0.125

    monkeypatch.setattr(port_est, "batched_prompt_decode", slow_decode)
    store = SimpleNamespace(params={"embed": torch.zeros(1)},
                            cfg=SimpleNamespace(vocab_size=10),
                            sample_ids=np.arange(4))
    kvb = port_est.KVBatchEstimator(None, None, store)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        kvb._machinery_latency())) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and got == [0.125] * 8


def test_main_writes_metrics_and_trace_with_the_reference_schema(tmp_path):
    metrics, trace = tmp_path / "m.json", tmp_path / "t.jsonl"
    run = serve.main(["--dataset", "wildlife", "--device", "cpu",
                      "--vlm-smoke", "--n-images", "600", "--queries", "4",
                      "--concurrency", "4", "--metrics-json", str(metrics),
                      "--trace-out", str(trace)])
    snap = json.loads(metrics.read_text())
    recs = [json.loads(line) for line in trace.read_text().splitlines()]
    assert _reconciles(run.stats) and snap["coalescer"]["reconciles"]
    # the reference snapshot of a reference coalescer's stats
    with jax_coal.PredicateCoalescer(SimpleNamespace(n=1)) as ref_coal:
        ref_stats = ref_coal.stats()
    reg = RefRegistry()
    for ph in ("queue_wait", "probe", "combine", "request"):
        reg.histogram(f"serve.{ph}_ms").observe(1.0)
    reg.histogram("qerror.ensemble").observe(1.0)
    ref_snap = ref_report.build_snapshot(registry=reg, coalescer=ref_stats)
    assert set(snap) == set(ref_snap)
    for part in ("coalescer", "latency_ms", "degraded_answers", "serve",
                 "registry"):
        assert set(snap[part]) == set(ref_snap[part]), part
    assert set(snap["coalescer"]["cache"]) == set(ref_snap["coalescer"]
                                                  ["cache"])
    assert snap["schema"] == ref_snap["schema"]
    assert snap["serve"]["queries"] == 8
    kinds = {r["kind"] for r in recs}
    assert {"submit", "flush", "plan", "summary"} <= kinds
    summary = recs[-1]
    assert summary["kind"] == "summary"
    assert summary["requests"] == snap["coalescer"]["requests"] == 24
    assert sum(1 for r in recs if r["kind"] == "submit") == 24


def test_main_defaults_to_the_card_and_refuses_later_flags(monkeypatch):
    """``main`` runs on the card unless told otherwise; the sharding and
    fleet flags, once refused, now parse with the reference's defaults and
    reach the build and the serve loop; the flags that need the concurrent
    path still refuse to run without it."""
    import argparse

    from repro.launch import serve as ref_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--concurrency", "8"])

    class Parsed(Exception):
        pass

    seen = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *a, **kw):
        seen.append(parse(self, *a, **kw))
        return seen[-1]

    def stop(*a, **kw):
        raise Parsed(kw)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    monkeypatch.setattr(serve, "build_stack", stop)
    monkeypatch.setattr(ref_serve, "build_stack", stop)
    flags = ("shards", "balance_boundary", "replicas", "hedge_ms",
             "heartbeat_ms")
    for argv in ([], ["--shards", "4", "--index-clusters", "256",
                      "--balance-boundary", "--concurrency", "16",
                      "--replicas", "3", "--hedge-ms", "5",
                      "--heartbeat-ms", "20"]):
        with pytest.raises(Parsed) as built:
            serve.main(["--device", "cpu"] + argv)
        mine = {f: getattr(seen[-1], f) for f in flags}
        with pytest.raises(Parsed):
            ref_serve.main(argv)
        assert mine == {f: getattr(seen[-1], f) for f in flags}
        kw = built.value.args[0]
        assert (kw["shards"], kw["balance_boundary"]) == \
            (mine["shards"], mine["balance_boundary"])
    assert mine == dict(shards=4, balance_boundary=True, replicas=3,
                        hedge_ms=5.0, heartbeat_ms=20.0)
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--ingest-rate", "10"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--replicas", "2"])

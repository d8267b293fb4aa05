"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``), mirroring ``tests/test_observability.py``: the same values
fed to both give equal histograms, snapshots, trace files, q-error records
and exit summaries; the registry is idempotent and thread-safe; the tracer
samples 1-in-N; the flush context is thread-local and scan spans appear
only inside a flush; the index and the mutable store report through their
``obs`` hooks; and probe results are bitwise the same with telemetry on
and off."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.core import optimizer as jax_opt  # noqa: E402
from repro.core.synthetic import make_corpus  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro_torch import obs as port_obs  # noqa: E402
from repro_torch.core import phases  # noqa: E402
from repro_torch.core.estimators import Estimate  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.optimizer import QueryPlan, execute_cascade  # noqa: E402
from repro_torch.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro_torch.index import (  # noqa: E402
    MutableClusteredStore,
    build_clustered_store,
)
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCoalescer,
)
from repro_torch.obs import (  # noqa: E402
    LATENCY_MS_EDGES,
    QERROR_EDGES,
    SECONDS_EDGES,
    UNIT_EDGES,
    Histogram,
    MetricsRegistry,
    ObsHub,
    Tracer,
    get_flush_ctx,
    set_flush_ctx,
)
from repro_torch.obs import report  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see test_torch_coalescer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(mod, vals):
    """The same metric operations on a registry of ``mod``."""
    reg = mod.MetricsRegistry()
    reg.counter("z.c").inc(3)
    reg.counter("a.c").inc()
    reg.gauge("a.g").set(1.5)
    reg.gauge("b.g").record_max(4.0)
    reg.gauge("b.g").record_max(2.0)
    h = reg.histogram("serve.request_ms")
    q = reg.histogram("qerror.ensemble", edges=mod.QERROR_EDGES)
    for v in vals:
        h.observe(v)
        q.observe(1.0 + v)
    reg.histogram("serve.probe_ms").observe(0.25)
    return reg


# ------------------------------------------------------------- registry


def test_edges_are_the_references():
    assert LATENCY_MS_EDGES == ref_obs.LATENCY_MS_EDGES
    assert QERROR_EDGES == ref_obs.QERROR_EDGES
    assert SECONDS_EDGES == ref_obs.SECONDS_EDGES
    assert UNIT_EDGES == ref_obs.UNIT_EDGES
    assert QERROR_EDGES[0] == pytest.approx(1.0)


def test_histogram_exact_percentiles_match_the_reference():
    vals = np.random.default_rng(0).lognormal(mean=1.0, sigma=1.5,
                                              size=1000)
    h = MetricsRegistry().histogram("t.lat")
    h_ref = ref_obs.MetricsRegistry().histogram("t.lat")
    for v in vals:
        h.observe(v)
        h_ref.observe(v)
    s = h.summary()
    assert s == h_ref.summary()
    assert s["count"] == 1000
    for q, key in ((50, "p50"), (95, "p95"), (99, "p99")):
        assert s[key] == np.percentile(vals, q)
    assert s["min"] == vals.min() and s["max"] == vals.max()
    assert sum(c for _, c in s["buckets"]) == 1000
    np.testing.assert_array_equal(h.values(), vals)   # the buffer doubled


def test_empty_histogram_and_zero_percentile():
    h = Histogram("x", threading.Lock())
    assert h.summary() == {"count": 0}
    assert h.percentile(95) == 0.0


def test_registry_get_or_create_is_idempotent_and_typed():
    reg = MetricsRegistry()
    c1 = reg.counter("a")
    assert reg.counter("a") is c1
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("a")
    with pytest.raises(TypeError):
        reg.histogram("a")
    g = reg.gauge("g")
    g.set(2.0)
    g.record_max(1.0)
    g.record_max(7.5)
    assert g.value == 7.5


def test_registry_thread_safety():
    reg = MetricsRegistry()
    c = reg.counter("hits")
    h = reg.histogram("lat")

    def worker():
        for i in range(1000):
            c.inc()
            h.observe(float(i))
            reg.counter("hits").inc(0)      # get-or-create under contention

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8000 and h.count == 8000


def test_snapshot_equals_the_references():
    vals = [0.5, 2.0, 7.25, 30.0, 0.01]
    snap = _feed(port_obs, vals).snapshot()
    snap_ref = _feed(ref_obs, vals).snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert snap == snap_ref
    assert snap["counters"] == {"a.c": 1, "z.c": 3}
    assert snap["gauges"] == {"a.g": 1.5, "b.g": 4.0}


# --------------------------------------------------------------- tracer


def _trace(mod, path):
    with mod.Tracer(path, sample=3) as tr:
        hits = [tr.sample_hit("submit") for _ in range(10)]
        tr.emit("submit", resolution="cache_hits", pred=0)
        tr.emit("submit", resolution="probe_scored", pred=1, wall_ms=0.5)
        tr.emit("flush", batch=2, bucket=2)
        ids = [tr.next_id(), tr.next_id()]
    tr.emit("submit", resolution="late")        # after close: dropped
    return hits, ids, tr


def test_tracer_sampling_and_jsonl_match_the_reference(tmp_path):
    hits, ids, tr = _trace(port_obs, str(tmp_path / "port.jsonl"))
    hits_ref, ids_ref, tr_ref = _trace(ref_obs, str(tmp_path / "ref.jsonl"))
    assert hits == [True, False, False] * 3 + [True] == hits_ref
    assert ids == ids_ref and ids[0] < ids[1]
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    recs = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    assert [r["kind"] for r in recs] == ["submit", "submit", "flush"]
    assert tr.span_counts() == {"submit": 2, "flush": 1}
    assert tr.submit_counts() == {"cache_hits": 1, "probe_scored": 1}
    assert tr.emitted == 3 == tr_ref.emitted
    tr.close()                                  # idempotent
    with pytest.raises(ValueError, match="sample"):
        Tracer(str(tmp_path / "u.jsonl"), sample=0)


def test_flush_ctx_is_thread_local():
    set_flush_ctx(7)
    seen = []
    t = threading.Thread(target=lambda: seen.append(get_flush_ctx()))
    t.start()
    t.join()
    assert get_flush_ctx() == 7 and seen == [None]
    set_flush_ctx(None)
    assert get_flush_ctx() is None


def test_scan_span_only_inside_flush_ctx(tmp_path):
    hub = ObsHub(tracer=Tracer(str(tmp_path / "t.jsonl")))
    st = {"launches": 1, "rows_scanned": 10, "rows_full_equiv": 100,
          "scan_fraction": 0.1}
    hub.index_scan(st, fraction=0.1)            # outside a flush: no span
    set_flush_ctx(42)
    try:
        hub.index_scan(st, fraction=0.1)
    finally:
        set_flush_ctx(None)
    hub.tracer.close()
    assert hub.tracer.span_counts() == {"scan": 1}
    assert hub.registry.counter("index.rows_scanned").value == 20
    assert hub.registry.gauge("index.scan_fraction").value == 0.1
    (rec,) = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert rec == {"kind": "scan", "flush": 42, "rows_scanned": 10,
                   "rows_full_equiv": 100, "launches": 1,
                   "scan_fraction": 0.1}


def test_hub_events_and_rebuild_match_the_reference(tmp_path):
    def run(mod, path):
        hub = mod.ObsHub(tracer=mod.Tracer(path))
        hub.event("retry", flush=1, attempt=0, error="TransientError")
        hub.event("retry", flush=2, attempt=0, error="TransientError")
        hub.rebuild(seconds=0.25, incremental=True, generation=3)
        hub.tracer.close()
        return hub.registry.snapshot()

    snap = run(port_obs, str(tmp_path / "p.jsonl"))
    assert snap == run(ref_obs, str(tmp_path / "r.jsonl"))
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()
    assert snap["counters"]["events.retry"] == 2
    assert snap["counters"]["index.generation_swaps"] == 1
    assert snap["gauges"]["index.generation"] == 3


# ------------------------------------------------------ q-error accounting


def _plan(nodes, ests, prefix=None):
    return QueryPlan(filter_order=list(nodes), estimates=list(ests),
                     est_latency_s=0.0, est_vlm_calls=0.0,
                     prefix_sels=prefix)


def test_record_plan_matches_the_reference():
    """Exact estimates record a q-error, degraded ones their interval width
    and containment, compound plans their prefix q-errors: the same
    records as the reference's hub, within 1e-6."""
    c = make_corpus("wildlife", n_images=300, dim=32, seed=0)
    nodes = c.predicate_nodes()[:3]
    true = [c.true_selectivity(n) for n in nodes]
    ests = [
        Estimate(min(1.0, true[0] * 2 + 0.01), 0.0, 0.0),
        Estimate(0.4, 0.0, 0.0, extra={
            "degraded": True,
            "sel_interval": (max(0.0, true[1] - 0.1), true[1] + 0.2)}),
        Estimate(0.5, 0.0, 0.0, extra={
            "degraded": True, "sel_interval": (true[2] + 0.1,
                                               true[2] + 0.3)}),
    ]
    plan = _plan(nodes, ests, prefix=[0.3, 0.1, 0.05])
    hub, hub_ref = ObsHub(), ref_obs.ObsHub()
    for h in (hub, hub_ref):
        h.record_plan("ensemble", c, plan, observed_prefix=[0.2, 0.1, 0.0])
    snap, snap_ref = hub.registry.snapshot(), hub_ref.registry.snapshot()
    assert snap["counters"] == snap_ref["counters"] == {
        "qerror.bound_contained": 1, "qerror.bound_violations": 1}
    assert set(snap["histograms"]) == set(snap_ref["histograms"]) == {
        "qerror.ensemble", "qerror.degraded_interval_width",
        "qerror.prefix.ensemble"}
    for name, h in snap["histograms"].items():
        for key in ("p50", "p95", "p99", "min", "max", "sum"):
            assert abs(h[key] - snap_ref["histograms"][name][key]) <= 1e-6
        assert h["count"] == snap_ref["histograms"][name]["count"]


def test_execute_cascade_feeds_q_error_like_the_reference():
    c = make_corpus("wildlife", n_images=300, dim=32, seed=0)
    nodes = c.predicate_nodes()[1:3]
    ests = [Estimate(0.3, 0.0, 0.0), Estimate(0.05, 0.0, 0.0)]
    hub, hub_ref = ObsHub(), ref_obs.ObsHub()
    res = execute_cascade(c, _plan(nodes, ests), seed=0, obs=hub,
                          est_name="kvbatch")
    res_ref = jax_opt.execute_cascade(
        c, jax_opt.QueryPlan(filter_order=list(nodes), estimates=ests,
                             est_latency_s=0.0, est_vlm_calls=0.0),
        seed=0, obs=hub_ref, est_name="kvbatch")
    assert res.vlm_calls == res_ref.vlm_calls
    h = hub.registry.histogram("qerror.kvbatch", edges=QERROR_EDGES)
    h_ref = hub_ref.registry.histogram("qerror.kvbatch",
                                       edges=ref_obs.QERROR_EDGES)
    assert h.count == 2
    np.testing.assert_allclose(h.values(), h_ref.values(), rtol=0,
                               atol=1e-6)
    execute_cascade(c, _plan(nodes, ests), seed=0)     # obs=None: nothing


# --------------------------------------------------------------- report


def _coal_stats():
    return {"requests": 12, "probes_fired": 2, "predicates_probed": 6,
            "probe_scored": 6, "cache_hits": 5, "coalesced_dups": 1,
            "shed": 0, "degraded": 0, "errors": 0, "retries": 1,
            "probe_failures": 1, "breaker_fastfails": 0,
            "flusher_deaths": 0, "flusher_restarts": 0,
            "queue_depth_hwm": 4, "flush_ewma_s": 0.002,
            "breaker": {"state": "closed", "failures": 0, "opens": 0},
            "cache": {"entries": 6, "capacity": 64, "hits": 5, "misses": 7,
                      "evictions": 0, "hit_rate": 5 / 12,
                      "observed": {"entries": 0, "hits": 0, "misses": 0}},
            "chaos": {"launches": 3, "injected_failures": 1,
                      "injected_delays": 0, "injected_kills": 0}}


def test_snapshot_and_render_equal_the_references(tmp_path):
    """The same registry contents and stats give the reference's snapshot
    (schema, keys, values) and the same exit summary, and ``write_json``
    round-trips."""
    vals = [0.5, 2.0, 7.25]
    index = {"n_live": 10, "base_rows": 8, "base_live": 7, "base_dead": 1,
             "tail_rows": 3, "tail_live": 3, "inserts": 3, "deletes": 1,
             "rebuilds": 1, "generation": 1, "version": 5,
             "rebuilding": False, "max_inflation": 1.0,
             "last_rebuild_s": 0.5, "last_rebuild_incremental": True,
             "base_stats": {"probes": 4, "launches": 3, "rows_scanned": 9,
                            "rows_full_equiv": 32, "scan_fraction": 9 / 32}}
    out = {}
    for name, mod, rep in (("port", __import__("repro_torch.obs",
                                               fromlist=["x"]), report),
                           ("ref", ref_obs, ref_report)):
        reg = _feed(mod, vals)
        reg.counter("serve.queries").inc(4)
        reg.gauge("serve.wall_s").set(0.5)
        snap = rep.build_snapshot(registry=reg, coalescer=_coal_stats(),
                                  index=index, mutable=True)
        out[name] = (snap, rep.render(snap))
    (snap, text), (snap_ref, text_ref) = out["port"], out["ref"]
    assert snap == snap_ref and text == text_ref
    assert snap["schema"] == ref_report.SCHEMA_VERSION
    assert snap["coalescer"]["reconciles"]
    assert "reconciliation: requests == " in text and "OK" in text
    path = str(tmp_path / "m.json")
    report.write_json(snap, path)
    assert json.load(open(path))["coalescer"]["requests"] == 12


# ------------------------------------------------- index telemetry hooks


def test_index_reports_every_probe_and_scan_spans_inside_a_flush(tmp_path):
    x, _ = clustered_unit_vectors(800, 32, n_centers=8, spread=0.2, seed=0)
    cs = build_clustered_store(torch.from_numpy(x), 8, iters=4, seed=0)
    tr = Tracer(str(tmp_path / "t.jsonl"))
    hub = ObsHub(tracer=tr)
    cs.obs = hub
    hist = SemanticHistogram(torch.from_numpy(x), index=cs)
    thr = np.full(3, 0.6, np.float32)
    hist.selectivity_batch(x[:3], thr)           # outside a flush: no span
    with PredicateCoalescer(hist, CoalescerConfig(max_batch=3,
                                                  window_ms=10_000),
                            obs=hub) as coal:
        coal.selectivity_batch(x[3:6], thr)
    tr.close()
    st = cs.stats()
    reg = hub.registry.snapshot()
    assert reg["counters"]["index.probes"] == st["probes"] == 2
    assert reg["counters"]["index.rows_scanned"] == st["rows_scanned"]
    assert reg["gauges"]["index.scan_fraction"] == st["scan_fraction"]
    recs = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    (scan,) = [r for r in recs if r["kind"] == "scan"]
    (flush,) = [r for r in recs if r["kind"] == "flush"]
    assert scan["flush"] == flush["flush"]


def test_mutable_store_forwards_obs_across_a_rebuild():
    x, _ = clustered_unit_vectors(600, 32, n_centers=6, spread=0.2, seed=1)
    ms = MutableClusteredStore(torch.from_numpy(x), 6, seed=0,
                               auto_rebuild=False)
    hub = ObsHub()
    ms.obs = hub
    assert ms.obs is hub and ms._base.obs is hub
    ms.insert(x[:40] * 0.5 + x[40:80] * 0.5)
    ms.probe(x[:2], np.full(2, 0.7, np.float32))
    assert ms.rebuild(wait=True)
    assert ms._base.obs is hub                  # the new generation too
    ms.probe(x[:2], np.full(2, 0.7, np.float32))
    snap = hub.registry.snapshot()
    assert snap["counters"]["index.generation_swaps"] == 1
    assert snap["counters"]["events.generation_swap"] == 1
    assert snap["gauges"]["index.generation"] == ms.generation == 1
    assert snap["histograms"]["index.rebuild_s"]["count"] == 1
    assert snap["counters"]["index.probes"] == 2


def test_probe_results_bitwise_equal_with_telemetry_on(tmp_path):
    x = np.random.default_rng(0).standard_normal((400, 32)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    hist = SemanticHistogram(torch.from_numpy(x))
    preds, thrs = x[:6], np.linspace(0.3, 0.9, 6).astype(np.float32)

    def run(obs):
        with PredicateCoalescer(
                hist, CoalescerConfig(max_batch=3, window_ms=5),
                obs=obs) as coal:
            outs = []
            for lo in range(0, 6, 3):
                outs += coal.probe_outcomes(preds[lo:lo + 3],
                                            thrs[lo:lo + 3])
            return [(o.sel, o.lo, o.hi, o.degraded) for o in outs]

    tr = Tracer(str(tmp_path / "t.jsonl"), sample=1)
    traced = run(ObsHub(tracer=tr))
    tr.close()
    assert traced == run(None)
    assert tr.submit_counts().get("probe_scored", 0) == 6


def test_probe_results_bitwise_equal_with_profiled_spans_on(tmp_path):
    """The flush's ``coalescer.flush`` range, its wake stamps and the trace's
    start times under a profiler of every thread leave every probe result
    bitwise as it is with telemetry off; the flush record carries ``t_ns``
    and no ``bucket``."""
    x = np.random.default_rng(2).standard_normal((400, 32)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    hist = SemanticHistogram(torch.from_numpy(x))
    preds, thrs = x[:6], np.linspace(0.3, 0.9, 6).astype(np.float32)

    def run(obs):
        with PredicateCoalescer(
                hist, CoalescerConfig(max_batch=3, window_ms=5),
                obs=obs) as coal:
            outs = []
            for lo in range(0, 6, 3):
                outs += coal.probe_outcomes(preds[lo:lo + 3],
                                            thrs[lo:lo + 3])
            return [(o.sel, o.lo, o.hi, o.degraded) for o in outs]

    tr = Tracer(str(tmp_path / "t.jsonl"), sample=1)
    with phases.EveryThreadProfile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run(ObsHub(tracer=tr))
    tr.close()
    assert traced == run(None)
    assert sum(e.name == "coalescer.flush" for e in prof.events()) == 2
    recs = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    flushes = [r for r in recs if r["kind"] == "flush"]
    submits = [r for r in recs if r["kind"] == "submit"]
    assert len(flushes) == 2 and len(submits) == 6
    assert all("bucket" not in r and r["t_ns"] > 0 for r in flushes)
    assert all(r["t_ns"] > 0 for r in submits)
    assert min(r["t_ns"] for r in submits) < flushes[0]["t_ns"]


def test_stats_registry_and_spans_reconcile(tmp_path):
    x = np.random.default_rng(1).standard_normal((300, 32)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    hist = SemanticHistogram(torch.from_numpy(x))
    tr = Tracer(str(tmp_path / "t.jsonl"), sample=1)
    hub = ObsHub(tracer=tr)
    with PredicateCoalescer(
            hist, CoalescerConfig(max_batch=4, window_ms=5),
            obs=hub) as coal:
        coal.probe_outcomes(x[:4], np.full(4, 0.8, np.float32))
        coal.probe_outcomes(x[:4], np.full(4, 0.8, np.float32))  # hits
        st = coal.stats()
    hub.write_trace_summary(st)
    tr.close()
    assert st["requests"] == 8
    assert st["probe_scored"] == 4 and st["cache_hits"] == 4
    counters = hub.registry.snapshot()["counters"]
    for name in ("requests", "probe_scored", "cache_hits",
                 "coalesced_dups", "shed", "degraded", "errors"):
        assert counters[f"coalescer.{name}"] == st[name], name
    sub = tr.submit_counts()
    assert sum(sub.values()) == st["requests"]
    summary = json.loads(open(tmp_path / "t.jsonl").readlines()[-1])
    assert summary["kind"] == "summary"
    assert summary["requests"] == 8 and summary["cache_hits"] == 4
    hists = hub.registry.snapshot()["histograms"]
    assert hists["serve.request_ms"]["count"] == 8
    assert hists["serve.probe_ms"]["count"] == 4

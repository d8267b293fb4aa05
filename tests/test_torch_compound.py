"""Compound predicates in the port: the compound probe (pruned, unpruned,
mutable) and the conditional-selectivity planner.

Within the port the pruned compound count is bitwise the unpruned one and
the AND/OR of the plain version's per-row decisions. Against the
reference (``impl="xla"``), counts are exactly equal with every threshold
in a gap between row distances, and ``plan_query(compound=True)`` gives the
reference's filter order on the same corpus and weights."""

import functools
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
from repro.index import build_clustered_store as jax_build  # noqa: E402
from repro.index.clustered import _compound_masked_xla  # noqa: E402
from repro_torch.configs.paper_stack import SpecificityModelConfig  # noqa: E402
from repro_torch.core import estimators as port_est  # noqa: E402
from repro_torch.core import optimizer as port_opt  # noqa: E402
from repro_torch.core.estimators import Estimate  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.kvbatch import CompressedCacheStore  # noqa: E402
from repro_torch.core.specificity import specificity_model_from_numpy  # noqa: E402
from repro_torch.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro_torch.index import (  # noqa: E402
    MutableClusteredStore,
    build_clustered_store,
)
from repro_torch.kernels.cosine_topk import ops, ref  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the many small torch ops here would otherwise
    wait on descheduled threads, many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _fixture():
    """(x, labels): 2048 x 64 unit rows in 8 planted clusters — predicates
    from one planted cluster overlap, so conjunctions match rows."""
    x, labels = clustered_unit_vectors(2048, 64, n_centers=8, spread=0.3,
                                       seed=0)
    return x, np.asarray(labels)


def _correlated(x, labels, b, seed, sel):
    """b predicates from one planted cluster, each with a threshold at ~sel
    placed mid-gap between two row distances."""
    rng = np.random.default_rng(seed)
    rows = np.flatnonzero(labels == int(rng.integers(labels.max() + 1)))
    preds = x[rng.choice(rows, size=b, replace=False)].astype(np.float32)
    thr = []
    for p in preds:
        d = np.sort(1.0 - x.astype(np.float64) @ p.astype(np.float64))
        i = int(sel * len(x))
        while d[i + 1] - d[i] < 2e-6:
            i += 1
        thr.append(0.5 * (d[i] + d[i + 1]))
    return preds, np.asarray(thr, np.float32)


def _plain_count(x, preds, thr, mode):
    """The AND/OR of per-conjunct full scans, from the row-local distances."""
    match = ref.cosine_distances(torch.from_numpy(x),
                                 torch.from_numpy(preds)) <= \
        torch.from_numpy(thr)[:, None]
    hit = match.all(dim=0) if mode == "and" else match.any(dim=0)
    return int(hit.sum())


@pytest.mark.parametrize("mode", ["and", "or"])
@pytest.mark.parametrize("k_clusters,sel,b", [
    (8, 0.01, 2), (8, 0.10, 3), (32, 0.01, 3), (32, 0.10, 2)])
def test_pruned_compound_is_bitwise_the_unpruned(mode, k_clusters, sel, b):
    x, labels = _fixture()
    cs = build_clustered_store(x, k_clusters, iters=4, device="cpu")
    bare = SemanticHistogram(torch.from_numpy(x))
    for seed in range(3):
        preds, thr = _correlated(x, labels, b, seed, sel)
        got, stats = cs.probe_compound(preds, thr, mode=mode)
        assert got == bare.count_compound(preds, thr, mode=mode) \
            == _plain_count(x, preds, thr, mode)
        lo, hi = cs.compound_count_bounds(preds, thr, mode=mode)
        assert lo <= got <= hi
    assert stats["rows_scanned"] <= len(x)


@pytest.mark.parametrize("mode", ["and", "or"])
def test_compound_matches_the_reference(mode):
    x, labels = _fixture()
    ref_cs = jax_build(x, 16, iters=4, seed=0, impl="xla")
    port_cs = build_clustered_store(x, 16, iters=4, device="cpu")
    ref_h = JaxHistogram(jnp.asarray(x), impl="xla", index=ref_cs)
    port_h = SemanticHistogram(torch.from_numpy(x), index=port_cs)
    for seed, sel in ((1, 0.02), (2, 0.2), (3, 0.05)):
        preds, thr = _correlated(x, labels, 3, seed, sel)
        want, _ = ref_cs.probe_compound(preds, thr, mode=mode)
        got, _ = port_cs.probe_compound(preds, thr, mode=mode)
        assert got == want
        assert port_h.selectivity_compound(preds, thr, mode=mode) == \
            ref_h.selectivity_compound(preds, thr, mode=mode)


@pytest.mark.parametrize("mode", ["and", "or"])
def test_mutable_compound_is_bitwise_a_fresh_scan(mode):
    x, labels = _fixture()
    ms = MutableClusteredStore(x[:1800], 8, iters=3, auto_rebuild=False,
                               device="cpu")
    hist = SemanticHistogram(torch.from_numpy(x[:1800]), index=ms)
    ids = ms.insert(x[1800:])
    dead = list(range(0, 1800, 9)) + [int(ids[0]), int(ids[5])]
    ms.delete(dead)
    keep = np.setdiff1d(np.arange(len(x)), dead)
    for seed in range(3):
        preds, thr = _correlated(x, labels, 3, seed, 0.05)
        assert hist.count_compound(preds, thr, mode=mode) == \
            _plain_count(x[keep], preds, thr, mode)
    ms.rebuild(wait=True)
    assert hist.count_compound(preds, thr, mode=mode) == \
        _plain_count(x[keep], preds, thr, mode)


def test_compound_ops_honour_n_valid_and_the_mask():
    x, labels = _fixture()
    preds, thr = _correlated(x, labels, 2, 4, 0.2)
    xt, pt, tt = map(torch.from_numpy, (x, preds, thr))
    mask = torch.from_numpy((np.arange(len(x)) % 3 == 0).astype(np.int32))
    for mode in ("and", "or"):
        assert int(ops.cosine_compound_count(xt, pt, tt, mode=mode,
                                             n_valid=700)) == \
            _plain_count(x[:700], preds, thr, mode)
        assert int(ops.cosine_compound_count(xt, pt, tt, mode=mode,
                                             mask=mask)) == \
            _plain_count(x[::3], preds, thr, mode)


@pytest.mark.parametrize("mode", ["and", "or"])
@pytest.mark.parametrize("b", [9, 16])
def test_many_conjuncts_match_the_reference(mode, b):
    """More conjuncts than one predicate tile of the card's kernel (8): the
    compound count through the ops (all rows, n_valid, a mask) and through
    ``count_compound`` (bare and with the index) equals the reference's
    ``_compound_masked_xla`` exactly; every threshold sits mid-gap between
    two adjacent row distances."""
    x, labels = _fixture()
    preds, thr = _correlated(x, labels, b, b, 0.2)
    want = {nv: int(_compound_masked_xla(jnp.asarray(x), nv,
                                         jnp.asarray(preds), jnp.asarray(thr),
                                         mode=mode))
            for nv in (len(x), 1500)}
    assert min(want.values()) > 0
    xt, pt, tt = (torch.from_numpy(a) for a in (x, preds, thr))
    for nv, count in want.items():
        assert int(ops.cosine_compound_count(xt, pt, tt, mode=mode,
                                             n_valid=nv)) == count
    mask = (torch.arange(len(x)) < 1500).to(torch.int32)
    assert int(ops.cosine_compound_count(xt, pt, tt, mode=mode,
                                         mask=mask)) == want[1500]
    bare = SemanticHistogram(xt)
    indexed = SemanticHistogram(xt, index=build_clustered_store(
        x, 8, iters=4, device="cpu"))
    for hist in (bare, indexed):
        assert hist.count_compound(preds, thr, mode=mode) == want[len(x)]


def test_compound_mode_validation():
    x, _ = _fixture()
    cs = build_clustered_store(x, 8, iters=2, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        cs.probe_compound(x[:2], np.array([0.1, 0.1]), mode="xor")
    with pytest.raises(ValueError, match="mode"):
        SemanticHistogram(torch.from_numpy(x)).count_compound(
            x[:2], np.array([0.1, 0.1]), mode="xor")


# -------------------------------------------------------------- planner


class _JointTableEstimator:
    """Fixed marginals + a joint-selectivity table: the greedy conditional
    planner against hand-computed orders."""

    def __init__(self, marginals, joints):
        self.marginals, self.joints = marginals, joints

    def estimate_batch(self, node_ids, seed=0):
        return [Estimate(self.marginals[n], 0.0, 0.0, threshold=0.5)
                for n in node_ids]

    def compound_selectivity(self, node_ids, thresholds, seed=0):
        return self.joints[frozenset(node_ids)]


def test_plan_query_compound_orders_by_conditional_selectivity():
    est = _JointTableEstimator(
        marginals={1: 0.30, 2: 0.35, 3: 0.40},
        joints={frozenset({1, 2}): 0.30, frozenset({1, 3}): 0.12,
                frozenset({1, 2, 3}): 0.10})
    indep = port_opt.plan_query([1, 2, 3], est)
    assert indep.filter_order == [1, 2, 3] and indep.prefix_sels is None
    plan = port_opt.plan_query([1, 2, 3], est, compound=True)
    assert plan.filter_order == [1, 3, 2]
    assert plan.prefix_sels == [0.30, 0.12, 0.10]


def test_plan_query_compound_skips_without_thresholds():
    class NoThr(_JointTableEstimator):
        def estimate_batch(self, node_ids, seed=0):
            return [Estimate(self.marginals[n], 0.0, 0.0) for n in node_ids]

    plan = port_opt.plan_query([1, 2], NoThr({1: 0.3, 2: 0.2},
                                             {frozenset({1, 2}): 0.1}),
                               compound=True)
    assert plan.filter_order == [2, 1] and plan.prefix_sels is None


def test_compound_plans_match_the_reference():
    """The ensemble's compound plans through each side's cluster index, on
    the same corpus and specificity weights: the same filter order, cascade
    calls and per-prefix joint selectivities."""
    corpus = make_corpus("wildlife", n_images=1200, dim=96, seed=0)
    X, y = specificity_dataset(corpus, n_samples=600, seed=0)
    jax_model, _ = train_specificity(X, y, JaxCfg(embed_dim=96, steps=60))
    port_model = specificity_model_from_numpy(
        {k: np.asarray(v) for k, v in jax_model.params.items()},
        SpecificityModelConfig(embed_dim=96), device="cpu")
    ids = np.arange(0, 1200, 75)
    ref_idx = jax_build(corpus.images, 16, iters=4, seed=0, impl="xla")
    port_idx = build_clustered_store(corpus.images, 16, iters=4,
                                     device="cpu")

    def ensemble(mod, hist, model, store):
        spec = mod.SpecificityEstimator(corpus, hist, model)
        kvb = mod.KVBatchEstimator(corpus, hist, store, run_machinery=False)
        return mod.EnsembleEstimator(spec, kvb)

    ref = ensemble(jax_est, JaxHistogram(jnp.asarray(corpus.images),
                                         impl="xla", index=ref_idx),
                   jax_model, SimpleNamespace(sample_ids=ids))
    port = ensemble(port_est, SemanticHistogram(
        torch.from_numpy(corpus.images), index=port_idx), port_model,
        CompressedCacheStore(sample_ids=ids))
    queries = port_opt.generate_queries(corpus, n_queries=6, n_filters=3)
    for q in queries:
        rp = jax_opt.execute_cascade(
            corpus, jax_opt.plan_query(q, ref, compound=True))
        pp = port_opt.execute_cascade(
            corpus, port_opt.plan_query(q, port, compound=True))
        assert [int(f) for f in pp.plan.filter_order] == \
            [int(f) for f in rp.plan.filter_order], q
        assert pp.vlm_calls == rp.vlm_calls
        assert len(pp.plan.prefix_sels) == 3
        # the thresholds come from the estimators, not from gaps: a count
        # may differ by a row whose distance rounds across its threshold
        np.testing.assert_allclose(pp.plan.prefix_sels, rp.plan.prefix_sels,
                                   rtol=0, atol=1.0 / 1200)


def test_serve_main_with_the_index_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    results = main(["--dataset", "wildlife", "--device", "cpu", "--vlm-smoke",
                    "--n-images", "600", "--queries", "2", "--filters", "3",
                    "--index-clusters", "16", "--compound"])
    out = capsys.readouterr().out
    assert "index: 16 clusters over 600 rows" in out
    assert "scan_fraction=" in out          # the reference's exit summary
    for r in results["ensemble"]:
        assert r.plan.prefix_sels is not None and r.vlm_calls > 0

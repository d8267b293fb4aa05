"""The slice as a whole: the port's estimate -> plan -> cascade path against
the reference's on the same corpus, queries and specificity weights.

Both sides build their estimators directly (the reference's KV-batch
estimator without its machinery, which does not change an estimate). For
every query and estimator the filter order, the cascade's VLM calls and the
selectivities must agree; a count may differ only by rows whose distance
lies within 1e-5 of the threshold, and the test counts those rows."""

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
from repro.kernels.kmeans.ops import medoid_sample as jax_medoids  # noqa: E402
from repro_torch.configs.paper_stack import SpecificityModelConfig  # noqa: E402
from repro_torch.core import estimators as port_est  # noqa: E402
from repro_torch.core import optimizer as port_opt  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.kvbatch import CompressedCacheStore  # noqa: E402
from repro_torch.core.specificity import specificity_model_from_numpy  # noqa: E402
from repro_torch.kernels.kmeans.ops import medoid_sample  # noqa: E402

NEAR = 1e-5


def _estimators(mod, corpus, hist, model, store):
    spec = mod.SpecificityEstimator(corpus, hist, model)
    kvb = mod.KVBatchEstimator(corpus, hist, store, run_machinery=False)
    return {"specificity": spec, "kvbatch": kvb,
            "ensemble": mod.EnsembleEstimator(spec, kvb),
            "sampling-16": mod.SamplingEstimator(corpus, 16),
            "oracle": mod.OracleEstimator(corpus)}


def _stacks(dataset):
    """(corpus, reference estimators, port estimators) on the same data and
    specificity weights."""
    corpus = make_corpus(dataset, n_images=1200, dim=96, seed=0)
    X, y = specificity_dataset(corpus, n_samples=600, seed=0)
    jax_model, _ = train_specificity(X, y, JaxCfg(embed_dim=96, steps=60))
    port_model = specificity_model_from_numpy(
        {k: np.asarray(v) for k, v in jax_model.params.items()},
        SpecificityModelConfig(embed_dim=96), device="cpu")
    ids_ref = jax_medoids(corpus.images, 16, iters=5, seed=0)
    ids = medoid_sample(torch.from_numpy(corpus.images), 16, iters=5, seed=0)
    assert np.array_equal(ids, ids_ref)

    ref = _estimators(jax_est, corpus,
                      JaxHistogram(jnp.asarray(corpus.images), impl="xla"),
                      jax_model, SimpleNamespace(sample_ids=ids_ref))
    port = _estimators(port_est, corpus,
                       SemanticHistogram(torch.from_numpy(corpus.images)),
                       port_model, CompressedCacheStore(sample_ids=ids))
    return corpus, ref, port


@pytest.mark.parametrize("dataset", ["wildlife", "ecommerce"])
def test_slice_matches_the_reference(dataset):
    corpus, ref, port = _stacks(dataset)
    images = corpus.images.astype(np.float64)
    n = len(images)
    queries = port_opt.generate_queries(corpus, n_queries=5, n_filters=3)
    near_rows = 0
    for q in queries:
        for name in ref:
            rp = jax_opt.execute_cascade(
                corpus, jax_opt.plan_query(q, ref[name]))
            pp = port_opt.execute_cascade(
                corpus, port_opt.plan_query(q, port[name]))
            assert [int(f) for f in pp.plan.filter_order] == \
                [int(f) for f in rp.plan.filter_order], (name, q)
            assert pp.vlm_calls == rp.vlm_calls, (name, q)
            assert np.array_equal(pp.result_ids, rp.result_ids)
            for node, ep, er in zip(pp.plan.filter_order, pp.plan.estimates,
                                    rp.plan.estimates):
                if ep.threshold is None:
                    assert ep.selectivity == er.selectivity, (name, node)
                    continue
                assert abs(ep.threshold - er.threshold) < 1e-5, (name, node)
                dist = 1.0 - images @ corpus.text_embedding(node).astype(
                    np.float64)
                near = int((np.abs(dist - ep.threshold) < NEAR).sum())
                near_rows += near
                diff = abs(round(ep.selectivity * n) - round(er.selectivity * n))
                assert diff <= near, (name, node, diff, near)
    # the tolerance is the rows this close to a threshold: report how many
    print(f"{dataset}: {near_rows} row(s) within {NEAR} of a threshold")


def test_ensemble_feedback_correction_matches():
    """The ensemble's learned EMA correction, fed by the same cascades,
    reaches the same value and moves the next estimates the same way."""
    corpus, ref, port = _stacks("artwork")
    ens_ref, ens_port = ref["ensemble"], port["ensemble"]
    ens_ref.feedback = ens_port.feedback = True
    queries = port_opt.generate_queries(corpus, n_queries=4, n_filters=2,
                                        seed=1)
    for q in queries:
        jax_opt.execute_cascade(corpus, jax_opt.plan_query(q, ens_ref),
                                feedback=ens_ref)
        port_opt.execute_cascade(corpus, port_opt.plan_query(q, ens_port),
                                 feedback=ens_port)
    assert ens_port._log_corr != 0.0
    assert abs(ens_port._log_corr - ens_ref._log_corr) < 1e-9
    sels_ref = [e.selectivity for e in ens_ref.estimate_batch(queries[0])]
    sels = [e.selectivity for e in ens_port.estimate_batch(queries[0])]
    np.testing.assert_allclose(sels, sels_ref, rtol=1e-9, atol=0)


def test_serve_main_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    results = main(["--dataset", "wildlife", "--device", "cpu", "--vlm-smoke",
                    "--n-images", "600", "--queries", "2", "--filters", "3"])
    out = capsys.readouterr().out
    assert out.count("\nquery ") == 2
    assert set(results) == {"specificity", "kvbatch", "ensemble",
                            "sampling-16", "oracle"}
    for name, res in results.items():
        assert len(res) == 2
        for r in res:
            assert r.vlm_calls > 0
            assert all(0.0 <= e.selectivity <= 1.0 for e in r.plan.estimates)

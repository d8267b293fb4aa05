"""The KV-batch slice as a whole: the port's compressed-store build and
batched prompt decode against the reference's, from the reference's own
parameters, patch embeddings and calibration tokens (``jax.random`` draws
cannot be reproduced in torch, so they are handed across).

Both sides run the ``llava-next-8b`` smoke config in float32: the query
statistics, the compressed caches and the answer logits agree within 1e-4.
Kept positions are compared exactly, so the test asserts that every
layer's top-keep is well posed (keep-th and (keep+1)-th scores differ by
more than 1e-5 relative)."""

import dataclasses
import inspect
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import kvbatch as jax_kvbatch  # noqa: E402
from repro.core.synthetic import make_corpus  # noqa: E402
from repro.kernels.kmeans.ops import medoid_sample as jax_medoids  # noqa: E402
from repro.launch.serve import build_stack as jax_build_stack  # noqa: E402
from repro.serving.compress import calibration_q_stats as jax_q_stats  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.estimators import (  # noqa: E402
    EnsembleEstimator,
    KVBatchEstimator,
)
from repro_torch.core.kvbatch import assemble_store, batched_prompt_decode  # noqa: E402
from repro_torch.kernels.expected_attention.ops import ea_scores  # noqa: E402
from repro_torch.launch.serve import COMPRESSION_RATE, build_stack  # noqa: E402
from repro_torch.models import nn, steps  # noqa: E402
from repro_torch.serving.compress import calibration_q_stats  # noqa: E402

SEED, RATE, TOL, TIE = 1, 0.5, 1e-4, 1e-5   # seed 0 has a 7e-7 near-tie
PROMPT = np.array([3, 1, 4, 1, 5])


def _f32(cfg, dtype):
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


@pytest.fixture(scope="module")
def reference():
    return reference_build(SEED)


def reference_build(seed):
    """The reference's float32 store and the draws it was built from."""
    corpus = make_corpus("wildlife", n_images=300, seed=seed)
    ids = jax_medoids(corpus.images, 8, iters=3, seed=seed)
    jcfg = _f32(jax_get_config("llava-next-8b", smoke=True), jax.numpy.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_kvbatch, "get_config", lambda arch, smoke=True: jcfg)
        jstore = jax_kvbatch.build_compressed_store(corpus.images, ids,
                                                    rate=RATE, seed=seed)
    n_patches = jcfg.vlm.num_patch_tokens
    patches = jax_kvbatch.fabricate_patch_embeds(corpus.images[ids], jcfg,
                                                 n_patches, seed)
    calib = jax.random.randint(jax.random.PRNGKey(seed + 1), (2, 32), 0,
                               jcfg.vocab_size)
    return {"ids": ids, "cfg": jcfg, "store": jstore,
            "patches": np.asarray(patches, np.float32),
            "calib": np.asarray(calib), "qstats": jax_q_stats(
                jstore.params, jcfg, calib)}


def _port_store(ref):
    cfg = _f32(get_config("llava-next-8b", smoke=True), torch.float32)
    params = nn.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref["store"].params),
        cfg)
    patches = torch.from_numpy(ref["patches"].copy())
    calib = torch.from_numpy(ref["calib"].copy()).long()
    return assemble_store(cfg, params, patches, calib, ref["ids"],
                          rate=RATE), patches, calib


def _ref_layer(jstore, li):
    return {n: np.asarray(jstore.cache["blocks"][0][n][li], np.float32)
            for n in ("k", "v")}


def test_store_and_decode_match_the_reference(reference):
    jstore = reference["store"]
    store, patches, calib = _port_store(reference)
    cfg = store.cfg
    assert (store.cache_len, store.cache_capacity) == (
        jstore.cache_len, jstore.cache_capacity)
    assert np.array_equal(store.sample_ids, jstore.sample_ids)

    qstats = calibration_q_stats(store.params, cfg, calib)
    for li in range(cfg.num_layers):
        np.testing.assert_allclose(qstats.mu[li].numpy(),
                                   reference["qstats"].mu[li], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(qstats.var[li].numpy(),
                                   reference["qstats"].var[li], atol=TOL,
                                   rtol=TOL)

    # every layer's top-keep is well posed on these inputs
    prefill = steps.make_prefill_step(cfg, batch=len(store.sample_ids),
                                      max_len=patches.shape[1])
    _, full = prefill(store.params, {"patch_embeds": patches})
    for li in range(cfg.num_layers):
        s = ea_scores(full[li]["k"], full[li]["v"], qstats.mu[li],
                      qstats.var[li]).double()
        s = torch.sort(s, dim=1, descending=True).values
        keep = store.cache_len
        gap = (s[:, keep - 1] - s[:, keep]) / s[:, keep - 1]
        assert float(gap.min()) > TIE, (li, float(gap.min()))

    for li in range(cfg.num_layers):
        want = _ref_layer(jstore, li)
        for n in ("k", "v"):
            np.testing.assert_allclose(store.cache[li][n].numpy(), want[n],
                                       atol=TOL, rtol=TOL)

    jlogits, jdt = jax_kvbatch.batched_prompt_decode(jstore, PROMPT)
    logits, dt = batched_prompt_decode(store, PROMPT)
    assert logits.shape == (len(store.sample_ids), cfg.vocab_size) and dt > 0
    np.testing.assert_allclose(logits, jlogits, atol=TOL, rtol=TOL)


def test_repeated_decodes_each_equal_a_fresh_store(reference):
    """Decode writes the prompt's K/V into the store in place; a later call
    with another (shorter) prompt must still see the caches as built."""
    store, _, _ = _port_store(reference)
    first, _ = batched_prompt_decode(store, PROMPT)
    second, _ = batched_prompt_decode(store, np.array([7, 2, 9]))
    assert not np.array_equal(first[:, :8], second[:, :8])
    for prompt, got in ((np.array([7, 2, 9]), second), (PROMPT, first)):
        fresh, _, _ = _port_store(reference)
        want, _ = batched_prompt_decode(fresh, prompt)
        assert np.array_equal(got, want)


def test_build_stack_machinery_on_changes_no_estimate():
    """With the machinery on (the default) the KV-batch and ensemble
    estimates are the ones of the machinery off; the measured batched
    decode latency rides along and is > 0."""
    corpus, ests = build_stack("wildlife", n_images=600, sample=16,
                               spec_steps=50, device="cpu", vlm_smoke=True)
    kvb = ests["kvbatch"]
    assert kvb.run_machinery and kvb.store.cache is not None
    assert kvb.store.params["embed"].shape == (256, 64)
    # the reference's build_stack compresses at rate 0.6: 4 of 8 patches
    assert kvb.store.cache_len == math.ceil(8 * (1 - 0.6))
    off = KVBatchEstimator(corpus, kvb.hist, kvb.store, run_machinery=False)
    nodes = corpus.predicate_nodes()[:6]
    for on_est, off_est in (
            (kvb, off),
            (ests["ensemble"], EnsembleEstimator(ests["specificity"], off))):
        got = on_est.estimate_batch(nodes)
        want = off_est.estimate_batch(nodes)
        assert [e.threshold for e in got] == [e.threshold for e in want]
        assert [e.selectivity for e in got] == [e.selectivity for e in want]
        assert all(e.extra["machine_cpu_s"] > 0 for e in got)
        assert all(e.extra["machine_cpu_s"] == 0 for e in want)
    one, one_off = kvb.estimate(nodes[0]), off.estimate(nodes[0])
    assert (one.threshold, one.selectivity) == (one_off.threshold,
                                                one_off.selectivity)
    assert one.extra["machine_cpu_s"] == got[0].extra["machine_cpu_s"] > 0


def test_build_stack_compresses_at_the_reference_rate():
    """The compression rate of the main path is the reference
    ``build_stack``'s (0.6), not ``build_compressed_store``'s own default
    there (0.9), so the decode kernel runs on the cache length the
    reference's path gives it."""
    ref_rate = inspect.signature(jax_build_stack).parameters["rate"].default
    assert COMPRESSION_RATE == ref_rate == 0.6

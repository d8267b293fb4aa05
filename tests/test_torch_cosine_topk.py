"""The port's probe (``repro_torch.kernels.cosine_topk.ops``) against the
reference's Pallas probe in interpret mode, at the reference kernel test's
shapes. Counts must be exactly equal — every threshold sits in a gap between
two adjacent row distances — and top-k distances agree within 1e-4, the
tolerance the Pallas kernel itself is held to."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.cosine_topk import ops as jax_ops  # noqa: E402
from repro_torch.kernels.cosine_topk import ops  # noqa: E402

SHAPES = [(1000, 1152, 5, 16), (4096, 768, 1, 128), (257, 96, 3, 8),
          (128, 128, 2, 128)]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def gap_thresholds(store, preds, t, rng, min_gap=2e-6):
    """(B, T) f32 thresholds, each the midpoint of a gap >= ``min_gap``
    between two adjacent row distances (float64), so no f32 rounding of a
    distance can move a row across one."""
    d = 1.0 - preds.astype(np.float64) @ store.astype(np.float64).T
    n = store.shape[0]
    out = np.empty((len(preds), t), np.float32)
    for b in range(len(preds)):
        s = np.sort(d[b])
        ok = np.nonzero(np.diff(s) > min_gap)[0]
        for j, target in enumerate(np.sort(rng.uniform(0.02, 0.98, t))):
            i = ok[np.argmin(np.abs(ok - target * (n - 1)))]
            out[b, j] = 0.5 * (s[i] + s[i + 1])
    return out


def _case(n, d, b, t, seed):
    rng = np.random.default_rng(seed)
    store = _unit(rng, n, d)
    preds = _unit(rng, b, d)
    return store, preds, gap_thresholds(store, preds, t, rng)


@pytest.mark.parametrize("n,d,t,k", SHAPES)
def test_scalar_probe_matches_pallas(n, d, t, k):
    store, preds, thr = _case(n, d, 1, t, seed=n + d)
    c1, t1 = jax_ops.cosine_probe(jnp.asarray(store), jnp.asarray(preds[0]),
                                  jnp.asarray(thr[0]), k=k)
    c2, t2 = ops.cosine_probe(torch.from_numpy(store),
                              torch.from_numpy(preds[0]),
                              torch.from_numpy(thr[0]), k=k)
    assert c2.dtype == torch.int32 and t2.shape == (min(k, n),)
    assert np.array_equal(np.asarray(c1), c2.numpy())
    np.testing.assert_allclose(t2.numpy(), np.asarray(t1), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("b", [1, 7, 130])
@pytest.mark.parametrize("n,d,t,k", SHAPES)
def test_batched_probe_matches_pallas(n, d, t, k, b):
    """B = 130 takes the reference's B-tiled kernel."""
    store, preds, thr = _case(n, d, b, t, seed=n + d + b)
    c1, t1 = jax_ops.cosine_probe_batch(jnp.asarray(store),
                                        jnp.asarray(preds), jnp.asarray(thr),
                                        k=k)
    c2, t2 = ops.cosine_probe_batch(torch.from_numpy(store),
                                    torch.from_numpy(preds),
                                    torch.from_numpy(thr), k=k)
    assert c2.shape == (b, t) and t2.shape == (b, min(k, n))
    assert np.array_equal(np.asarray(c1), c2.numpy())
    np.testing.assert_allclose(t2.numpy(), np.asarray(t1), rtol=1e-4,
                               atol=1e-4)


def test_k_is_clamped_to_the_store():
    store, preds, thr = _case(50, 32, 2, 1, seed=1)
    c, t = ops.cosine_probe_batch(torch.from_numpy(store),
                                  torch.from_numpy(preds),
                                  torch.from_numpy(thr), k=500)
    assert t.shape == (2, 50)
    assert torch.all(t[:, 1:] >= t[:, :-1])


def test_launch_shape_spreads_small_buffers_over_the_card():
    """Rows a block come from the rows scanned, the predicate tiles and the
    SM count (132 on an H100): the largest power of two in 32..1024 whose
    grid still holds four blocks a SM. The partials hold each block's
    counts and its min(k, rows) smallest distances; a compound block walks
    every tile itself and leaves one count."""
    from repro_torch.kernels.cosine_topk.kernel import launch_shape

    assert launch_shape(2**20, 3, 1, 1, 132) == (1024, 1024, 1, 1024 * 3 * 2)
    assert launch_shape(414_226, 3, 1, 1, 132)[:2] == (512, 810)
    assert launch_shape(16_384, 1, 1, 1, 132)[:2] == (32, 512)
    assert launch_shape(5_923, 1, 1, 64, 132) == (32, 186, 32, 186 * 33)
    assert launch_shape(16_384, 37, 1, 1, 132)[:2] == (128, 128)
    assert launch_shape(0, 1, 1, 5, 132) == (32, 1, 5, 6)
    assert launch_shape(414_226, 100, 1, 1, 132, compound=True) == \
        (512, 810, 0, 810)

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
    SM count (132 on an H100): for B <= 8 the largest power of two in
    32..1024 whose grid still holds four blocks a SM. The partials hold each
    block's counts and its min(k, rows) smallest distances; a compound block
    walks every tile itself and leaves one count. B > 8 takes the wide
    launch: staged blocks of 32 rows under at most one persistent CTA a SM,
    whatever B; each 8-row quarter of a CTA leaves one partial (k <= 32: its
    k smallest distances) or, for a larger k, each staged block's quarter
    its 8."""
    from repro_torch.kernels.cosine_topk.kernel import launch_shape

    assert launch_shape(2**20, 3, 1, 1, 132) == (1024, 1024, 1, 1024 * 3 * 2)
    assert launch_shape(414_226, 3, 1, 1, 132)[:2] == (512, 810)
    assert launch_shape(16_384, 1, 1, 1, 132)[:2] == (32, 512)
    assert launch_shape(5_923, 1, 1, 64, 132) == (32, 186, 32, 186 * 33)
    assert launch_shape(16_384, 37, 1, 1, 132)[:2] == (32, 4 * 132)
    assert launch_shape(0, 1, 1, 5, 132) == (32, 1, 5, 6)
    assert launch_shape(414_226, 100, 1, 1, 132, compound=True) == \
        (512, 810, 0, 810)
    for n in (2**20, 414_226, 16_384):
        for k in (1, 8, 32):
            grids = set()
            for b in (9, 37, 128, 200):
                rows, nblk, kb, part = launch_shape(n, b, 1, k, 132)
                assert (rows, kb) == (32, k)
                assert part == nblk * b * (1 + kb)
                grids.add(nblk)
            assert grids == {4 * 132}
    for b in (9, 37, 128, 200):     # k past 32: partials a staged block
        assert launch_shape(2**20, b, 4, 128, 132) == \
            (32, 4 * 2**15, 8, 4 * 2**15 * b * (4 + 8))
        assert launch_shape(100, b, 1, 8, 132)[:3] == (32, 4 * 4, 8)
        assert launch_shape(0, b, 1, 64, 132)[1:3] == (4, 8)
        # the 8-wide plan stays for a launch that cannot take the wide one
        assert launch_shape(2**20, b, 1, 1, 132, wide=False)[:2] == \
            (1024, 1024)


@pytest.mark.parametrize("b", [1, 8, 9, 128, 129, 200])
def test_entry_name_follows_the_reference_dispatch(b):
    """A batch counts as the B-tiled entry point exactly where the
    reference's ``cosine_probe_batch`` (``tiled=None``) tiles: B > block_b."""
    import inspect

    from repro_torch.kernels.cosine_topk.kernel import BLOCK_B, entry_name

    block_b = inspect.signature(jax_ops.cosine_probe_batch).parameters[
        "block_b"].default
    assert BLOCK_B == block_b
    for base in ("cosine_probe_batch", "cosine_probe_batch_masked",
                 "cosine_probe_batch_rowmask"):
        want = f"{base}_tiled" if b > block_b else base
        assert entry_name(base, b) == want

"""The port's k-means (``repro_torch.kernels.kmeans.ops``) against the
reference's, whose assignment step is the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.synthetic import make_corpus  # noqa: E402
from repro.kernels.kmeans import ops as jax_kmeans  # noqa: E402
from repro.kernels.kmeans.kernel import assign_blocks  # noqa: E402
from repro_torch.kernels.kmeans import ops  # noqa: E402
from repro_torch.kernels.kmeans.ref import assign_ref  # noqa: E402


def test_assign_step_matches_pallas(rng):
    x = rng.standard_normal((1000, 128)).astype(np.float32)
    cent = x[rng.choice(1000, 16, replace=False)] \
        + 0.1 * rng.standard_normal((16, 128)).astype(np.float32)
    xp = np.pad(x, ((0, 24), (0, 0)))            # a block_n multiple
    ref = np.asarray(assign_blocks(jnp.asarray(xp), jnp.asarray(cent),
                                   block_n=128))[:1000]
    got = ops.assign(torch.from_numpy(x), torch.from_numpy(cent))
    assert got.dtype == torch.int32 and got.shape == (1000,)
    assert (got.numpy() == ref).mean() >= 0.999


def test_assign_picks_the_lowest_index_on_ties():
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    cent = torch.tensor([[0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    assert assign_ref(x, cent).tolist() == [1, 0]


@pytest.fixture(scope="module")
def corpus():
    return make_corpus("wildlife", n_images=900, seed=0)


def test_warm_started_kmeans_gives_the_reference_ids(corpus):
    x = corpus.images
    init = x[np.random.default_rng(5).choice(len(x), 12, replace=False)]
    c_ref, a_ref = jax_kmeans.kmeans(x, 12, iters=4, init_centroids=init)
    c_port, a_port = ops.kmeans(torch.from_numpy(x), 12, iters=4,
                                init_centroids=init)
    assert np.array_equal(a_port.numpy(), a_ref)
    np.testing.assert_allclose(c_port.numpy(), c_ref, rtol=1e-5, atol=1e-6)


def test_medoid_sample_gives_the_reference_ids(corpus):
    x = corpus.images
    ref_ids = jax_kmeans.medoid_sample(x, 32, iters=5, seed=0)
    port_ids = ops.medoid_sample(torch.from_numpy(x), 32, iters=5, seed=0)
    assert np.array_equal(port_ids, ref_ids)


def test_empty_clusters_are_reseeded_from_the_same_draws():
    """Twenty identical rows and 6 clusters: most clusters go empty every
    iteration, so the result hangs on the re-seed draws."""
    x = np.repeat(np.eye(4, 8, dtype=np.float32), 5, axis=0)
    c_ref, a_ref = jax_kmeans.kmeans(x, 6, iters=3, seed=2, impl="xla")
    c_port, a_port = ops.kmeans(torch.from_numpy(x), 6, iters=3, seed=2)
    assert np.array_equal(a_port.numpy(), a_ref)
    np.testing.assert_allclose(c_port.numpy(), c_ref, rtol=1e-6, atol=1e-7)

"""The port's k-means (``repro_torch.kernels.kmeans.ops``) against the
reference's, whose assignment step is the Pallas kernel in interpret mode;
the CUDA kernel's bf16x2 arithmetic, emulated in plain torch, against the
Pallas kernel; and the launcher's choice of path and tile."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.synthetic import make_corpus  # noqa: E402
from repro.kernels.kmeans import ops as jax_kmeans  # noqa: E402
from repro.kernels.kmeans.kernel import assign_blocks  # noqa: E402
from repro_torch.kernels.kmeans import kernel, ops  # noqa: E402
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


def bf16_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a = hi + lo: hi the bfloat16 nearest a (ties to even, as the kernel's
    ``__floats2bfloat162_rn``), lo the bfloat16 nearest a - hi; as float32."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def assign_bf16x2(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """The tensor-core path's arithmetic: each operand split into bfloat16
    hi + lo, hi·hi + hi·lo + lo·hi summed in float32 (every product of two
    bfloat16 values is exact in float32), score c2 - 2·dot, first index on
    ties."""
    (xh, xl), (ch, cl) = bf16_split(x), bf16_split(cent)
    dot = xl @ ch.T + xh @ cl.T + xh @ ch.T
    c2 = torch.sum(cent * cent, dim=1)
    return torch.argmin(c2[None, :] - 2.0 * dot, dim=1).to(torch.int32)


def test_bf16_split_keeps_16_bits():
    x = torch.tensor([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-15),
                      1.0 + 2.0**-17 + 2.0**-20], dtype=torch.float32)
    hi, lo = bf16_split(x)
    assert hi.tolist() == [1.0, 1.0 + 2.0**-6, -1.0, 1.0]    # ties to even
    assert lo.tolist() == [2.0**-8, -(2.0**-8), -(2.0**-15),
                           2.0**-17 + 2.0**-20]
    big = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                           .astype(np.float32))
    hi, lo = bf16_split(big)
    assert float(((hi + lo - big) / big).abs().max()) <= 2.0**-16


@pytest.mark.parametrize("c", [32, 512])
def test_bf16x2_assignment_matches_pallas(c):
    """Seeded rows between two of C unit centres, at 1e-6..1e-1 from the
    midpoint (half with noise), so that many lie near a tie: the emulated
    kernel arithmetic gives the Pallas kernel's ids on >= 99.9% of rows, and
    every difference is a near-tie (float64 score gap < 1e-4), the limits
    chip_smoke.py holds the kernel to. One bfloat16 product (hi·hi alone)
    misses both on this data."""
    rng = np.random.default_rng(c)
    n, d = 4096, 384
    centres = rng.standard_normal((c, d))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    a, b = rng.integers(0, c, n), rng.integers(0, c, n)
    t = 0.5 + np.sign(rng.standard_normal(n)) * 10.0 ** rng.uniform(-6, -1, n)
    x = t[:, None] * centres[a] + (1 - t[:, None]) * centres[b]
    x += (0.3 * rng.standard_normal((n, d)) / np.sqrt(d)
          * (rng.uniform(size=n) < 0.5)[:, None])
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    cent = (centres + 0.05 * rng.standard_normal((c, d)) / np.sqrt(d)
            ).astype(np.float32)
    want = np.asarray(assign_blocks(jnp.asarray(x), jnp.asarray(cent),
                                    block_n=512))
    got = assign_bf16x2(torch.from_numpy(x), torch.from_numpy(cent)).numpy()
    assert (got == want).mean() >= 0.999
    c64 = cent.astype(np.float64)
    s64 = np.sum(c64 * c64, axis=1)[None, :] - 2.0 * (x.astype(np.float64)
                                                      @ c64.T)
    rows = np.arange(n)
    gap = np.abs(s64[rows, got] - s64[rows, want])
    assert gap.max() < 1e-4


def test_tile_holds_every_centroid_count():
    """A tensor-core block covers every centroid (so each row is read
    once), at most 32,768 accumulators, and rows a multiple of 64."""
    assert [kernel.tile(c) for c in (1, 31, 32, 33, 100, 511, 512)] == [
        (256, 32), (256, 32), (256, 32), (256, 64), (256, 128), (64, 512),
        (64, 512)]
    for c in range(1, kernel.MAX_CENTROIDS + 1):
        rows, block_c = kernel.tile(c)
        assert block_c >= c > block_c // 2 or block_c == 32
        assert rows * block_c <= 32_768 and rows % 64 == 0
    for c in (0, kernel.MAX_CENTROIDS + 1):
        with pytest.raises(ValueError):
            kernel.tile(c)


def test_vector_path_takes_rows_on_16_byte_boundaries():
    """The tensor-core path's 16-byte copies need aligned bases and d a
    multiple of 4; any other buffer takes the scalar-load path."""
    cent = torch.zeros((32, 1152))
    assert kernel.vector_path(torch.zeros((100, 1152)), cent)
    assert not kernel.vector_path(torch.zeros((100, 1151)),
                                  torch.zeros((32, 1151)))
    flat = torch.zeros(100 * 1152 + 4)
    assert kernel.vector_path(flat[4:].view(100, 1152), cent)
    assert not kernel.vector_path(flat[1:1 + 100 * 1152].view(100, 1152),
                                  cent)
    assert not kernel.vector_path(torch.zeros((100, 1152)),
                                  torch.zeros(32 * 1152 + 2)[2:].view(32, 1152))

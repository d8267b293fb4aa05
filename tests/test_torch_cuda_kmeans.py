"""The k-means assignment kernel (``repro_torch.kernels.kmeans``) against
its plain version on the card: >= 99.9% of rows assigned alike, every other
a near-tie (float64 score gap < 1e-4), on both paths (tensor cores, scalar
loads), at every tile's centroid counts, ragged rows and ragged d, and the
lowest index on exact ties. Free of JAX, so it runs on a machine with a
card and no JAX; the plain version is held to the reference by
``test_torch_kmeans.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kmeans import kernel, ops  # noqa: E402
from repro_torch.kernels.kmeans.ref import assign_ref  # noqa: E402

CENTROIDS = (1, 31, 32, 33, 100, 511, 512)
ROWS = 5000        # a multiple of no tile's rows (256, 128, 64)
TIE = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the assign kernel has no CPU mode")
    return torch.device("cuda")


def score_gap(x, cent, got, want):
    """Per row, the float64 score gap between the ids got and want."""
    c64, x64 = cent.double(), x.double()
    s = torch.sum(c64 * c64, dim=1)[None, :] - 2.0 * (x64 @ c64.T)
    return (s.gather(1, got.long()[:, None])
            - s.gather(1, want.long()[:, None])).abs()


def held(x, cent, got):
    """got agrees with the plain version on >= 99.9% of rows, and every
    other row is a near-tie."""
    want = assign_ref(x, cent)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0],)
    assert (got == want).float().mean() >= 0.999
    assert float(score_gap(x, cent, got, want).max()) < TIE


@pytest.mark.cuda
def test_assign_kernel_matches_plain_on_the_card(rng, card):
    x = torch.from_numpy(rng.standard_normal((ROWS, 1152)).astype("float32"))
    x = x.to(card)
    for c in CENTROIDS:
        cent = (x[:c] + 0.05).contiguous()
        before = kernel.path_launches["tensor_cores"]
        held(x, cent, ops.assign(x, cent))
        assert kernel.path_launches["tensor_cores"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 512])
def test_assign_scalar_path_takes_unaligned_buffers(rng, card, c):
    """d = 1151 (rows off 16-byte boundaries) and an aligned d whose base is
    one float off: both take the scalar-load path, which is held like the
    other; the tensor-core entry point refuses them."""
    x = torch.from_numpy(rng.standard_normal((ROWS, 1151)).astype("float32"))
    x = x.to(card)
    flat = torch.empty(ROWS * 1152 + 1, device=card)
    xu = flat[1:].view(ROWS, 1152)
    xu.copy_(torch.from_numpy(rng.standard_normal((ROWS, 1152))))
    for xs in (x, xu):
        cent = (xs[:c] + 0.05).contiguous()
        before = kernel.path_launches["scalar"]
        held(xs, cent, ops.assign(xs, cent))
        assert kernel.path_launches["scalar"] == before + 1
        with pytest.raises(ValueError):
            kernel.assign_tensor_cores(xs, cent)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 64, 100, 512])
def test_assign_picks_the_lowest_index_among_duplicated_centroids(rng, card,
                                                                  c):
    """Centroids j and j + c/2 are equal: every row's id is below c/2 on
    both paths, as torch.argmin and jnp.argmin pick the first."""
    x = torch.from_numpy(rng.standard_normal((ROWS, 1152)).astype("float32"))
    x = x.to(card)
    half = x[:c // 2] + 0.05
    cent = torch.cat([half, half]).contiguous()
    best = assign_ref(x, half.contiguous())
    for fn in (kernel.assign_tensor_cores, kernel.assign_scalar):
        got = fn(x, cent)
        assert int(got.max()) < c // 2
        assert float(score_gap(x, cent, got, best).max()) < TIE


@pytest.mark.cuda
@pytest.mark.parametrize("c", [513, 1024, 1100])
def test_assign_past_the_kernels_centroids_takes_slices(rng, card, c):
    """More centroids than the kernel holds (the balanced sharded build's
    K x shards): one launch a slice of at most 512, the slices' winners
    held like one pass (>= 99.9% alike, the rest near-ties)."""
    x = torch.from_numpy(rng.standard_normal((ROWS, 256)).astype("float32"))
    x = x.to(card)
    cent = (x[:c] + 0.05).contiguous()
    before = kernel.launches
    held(x, cent, ops.assign(x, cent))
    assert kernel.launches == before + -(-c // kernel.MAX_CENTROIDS)


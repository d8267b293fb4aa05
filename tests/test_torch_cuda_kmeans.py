"""The k-means assignment kernel (``repro_torch.kernels.kmeans``) against
its plain version on the card: >= 99.9% of rows assigned alike (the rest
near-ties). Free of JAX, so it runs on a machine with a card and no JAX;
the plain version is held to the reference by ``test_torch_kmeans.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kmeans import ops  # noqa: E402
from repro_torch.kernels.kmeans.ref import assign_ref  # noqa: E402


@pytest.mark.cuda
def test_assign_kernel_matches_plain_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the assign kernel has no CPU mode")
    x = torch.from_numpy(rng.standard_normal((5000, 1152)).astype("float32"))
    for c in (1, 32, 100, 512):
        cent = x[:c] + 0.05
        got = ops.assign(x.cuda(), cent.cuda()).cpu()
        want = assign_ref(x.cuda(), cent.cuda()).cpu()
        assert (got == want).float().mean() >= 0.999

"""The Expected-Attention scoring kernel
(``repro_torch.kernels.expected_attention``) against its plain version on
the card, at the reference kernel test's cases in float32 and bfloat16:
scores within rtol 1e-5, and the kept indices equal to a top-keep of the
plain scores wherever it is well posed (keep-th and (keep+1)-th scores
more than 1e-5 apart, relative). Free of JAX, so it runs on a machine
with a card and no JAX; the plain version is held to the reference by
``test_torch_expected_attention.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.expected_attention import kernel, ops, ref  # noqa: E402

CASES = [
    (2, 512, 2, 2, 64, 100),
    (1, 1000, 4, 1, 32, 128),
    (1, 130, 1, 4, 128, 13),
]
TIE = 1e-5


def _inputs(B, S, Hkv, rep, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            (rng.standard_normal((Hkv, rep, D)) * 0.2).astype(np.float32),
            (rng.uniform(size=(Hkv, rep, D)) * 0.1).astype(np.float32))


def keep_gap(scores: np.ndarray, keep: int) -> float:
    """Smallest relative gap between the keep-th and (keep+1)-th score over
    every (batch, kv head) of (B, S, Hkv) scores."""
    s = -np.sort(-scores.astype(np.float64), axis=1)
    return float(np.min((s[:, keep - 1] - s[:, keep]) / s[:, keep - 1]))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scoring kernel has no CPU mode")
    for B, S, Hkv, rep, D, keep in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            k, v, mu, var = (torch.from_numpy(a).cuda()
                             for a in _inputs(B, S, Hkv, rep, D, seed=S))
            k, v = k.to(dtype), v.to(dtype)
            before = kernel.launches
            got = ops.ea_scores(k, v, mu, var)
            assert kernel.launches == before + 1
            want = ref.ea_scores_ref(k, v, mu, var)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
            kc, _, idx = ops.compress(k, v, mu, var, keep=keep)
            if keep_gap(want.cpu().numpy(), keep) > TIE:
                s = torch.topk(want.transpose(1, 2), keep, dim=-1).indices
                assert torch.equal(idx, torch.sort(s, dim=-1).values.transpose(1, 2))

"""The port's Expected-Attention compression
(``repro_torch.kernels.expected_attention.ops``) against the reference's,
at the reference kernel test's cases (``tests/test_kernels.py``): scores
within rtol 1e-5 of the reference's jnp scores, and the kept indices and
gathered caches equal to the Pallas ``compress`` (interpret mode). Top-keep
is compared exactly only where it is well posed: every (batch, kv head)'s
keep-th and (keep+1)-th scores differ by more than 1e-5 relative, which
the test asserts for its seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.expected_attention.ops import compress as jax_compress  # noqa: E402
from repro.serving.compress import expected_attention_scores as jax_scores  # noqa: E402
from repro_torch.kernels.expected_attention import ops  # noqa: E402
from repro_torch.serving.compress import compress_cache  # noqa: E402

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


@pytest.mark.parametrize("B,S,Hkv,rep,D,keep", CASES)
def test_compress_matches_reference(B, S, Hkv, rep, D, keep):
    arrs = _inputs(B, S, Hkv, rep, D, seed=S)
    k, v, mu, var = (torch.from_numpy(a) for a in arrs)
    want_scores = np.asarray(jax_scores(*(jnp.asarray(a) for a in arrs)))
    scores = ops.ea_scores(k, v, mu, var)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=1e-5)
    assert keep_gap(want_scores, keep) > TIE

    jk, jv, jidx = jax_compress(*(jnp.asarray(a) for a in arrs), keep=keep,
                                kc=128)
    kc, vc, idx = ops.compress(k, v, mu, var, keep=keep)
    assert kc.shape == (B, keep, Hkv, D) and idx.shape == (B, keep, Hkv)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(kc.numpy(), np.asarray(jk))
    assert np.array_equal(vc.numpy(), np.asarray(jv))
    # kept indices are time-ordered (cache layout preserved)
    assert (np.diff(idx.numpy(), axis=1) > 0).all()
    # the rate form used by the build keeps the same positions
    kr, _, idxr = compress_cache(k, v, mu, var, rate=1.0 - keep / S)
    assert torch.equal(idxr, idx) and torch.equal(kr, kc)


def test_vector_path_takes_bf16_caches_on_16_byte_boundaries():
    """The vector path's 16-byte loads need bfloat16 caches whose bases and
    strides are multiples of 8 elements; any other cache (float32 among
    them) takes the scalar-load path."""
    from repro_torch.kernels.expected_attention import kernel

    for D in (16, 32, 64, 128):
        k = torch.zeros((2, 10, 4, D), dtype=torch.bfloat16)
        assert kernel.vector_path(k, k)
        assert kernel.vector_path(k[:, :, ::2], k[:, :, 1::2])
        assert not kernel.vector_path(k.float(), k.float())
        wide = torch.zeros((2, 10, 4, D + 4), dtype=torch.bfloat16)[..., :D]
        assert not kernel.vector_path(wide, wide)
        off = torch.zeros(2 * 10 * 4 * D + 1, dtype=torch.bfloat16)[1:]
        assert not kernel.vector_path(k, off.view(2, 10, 4, D))

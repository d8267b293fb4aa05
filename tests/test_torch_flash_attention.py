"""The port's flash attention (``repro_torch.kernels.flash_attention.ops``)
against the reference's Pallas flash kernel in interpret mode, at the
reference kernel test's cases (``tests/test_kernels.py``): 4 shapes x
float32/bfloat16, the same inputs made from a numpy seed. Tolerances are
the ones the Pallas kernel is held to: 2e-5 in float32, 2e-2 in bfloat16
(the two frameworks round bf16 at other places)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

CASES = [
    (1, 640, 2, 2, 64, True, None),
    (2, 512, 1, 3, 128, True, 256),
    (1, 384, 2, 1, 64, False, None),
    (1, 300, 1, 1, 128, True, None),   # ragged seq
]
DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]


def _inputs(B, S, Hkv, rep, D, seed):
    rng = np.random.default_rng(seed)
    H = Hkv * rep
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hkv,rep,D,causal,window", CASES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_matches_pallas(B, S, Hkv, rep, D, causal, window, dtype, tol):
    q, k, v = _inputs(B, S, Hkv, rep, D, seed=S)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                     causal=causal, window=window, q_chunk=256, kv_chunk=128)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)

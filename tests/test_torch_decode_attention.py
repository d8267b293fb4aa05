"""The port's flash-decode (``repro_torch.kernels.decode_attention.ops``)
against the reference's Pallas decode kernel in interpret mode, at the
reference kernel test's cases (``tests/test_kernels.py``), within 2e-5,
plus the float8 e4m3 cache case within 1e-4. Inputs come from a numpy
seed; the fp8 cache is made once and handed to both sides bit for bit.
The CUDA kernel's split-and-merge arithmetic (``ref.decode_attention_split
_ref``: per-range states, empty ranges included, then the merge) is held
to the same reference on the CPU, the one place it is checked without a
card."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels.decode_attention import kernel, ops, ref  # noqa: E402

CASES = [
    (2, 1000, 2, 4, 64, 777),
    (4, 4096, 1, 2, 128, None),
    (1, 300, 4, 1, 32, 5),
    (3, 129, 2, 2, 64, 129),
]


def _inputs(B, L, Hkv, rep, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, Hkv * rep, D)).astype(np.float32),
            rng.standard_normal((B, L, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, L, Hkv, D)).astype(np.float32))


def _fp8_case():
    """q float32, k/v float8 e4m3 as (jax arrays, torch tensors) of the
    same bits, kv_valid 400 of 500."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 1, 4, 64)).astype(np.float32)
    kv = [jnp.asarray(rng.standard_normal((2, 500, 2, 64)).astype(np.float32)
                      * 0.25).astype(jnp.float8_e4m3fn) for _ in range(2)]
    bits = [np.asarray(a).view(np.uint8) for a in kv]
    return (q, kv,
            [torch.from_numpy(b.copy()).view(torch.float8_e4m3fn) for b in bits])


@pytest.mark.parametrize("B,L,Hkv,rep,D,valid", CASES)
def test_decode_matches_pallas(B, L, Hkv, rep, D, valid):
    q, k, v = _inputs(B, L, Hkv, rep, D, seed=L)
    want = jax_decode(*(jnp.asarray(a) for a in (q, k, v)), kv_valid=valid,
                      kv_chunk=256)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               kv_valid=valid)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_decode_fp8_cache_matches_pallas():
    q, (jk, jv), (tk, tv) = _fp8_case()
    want = jax_decode(jnp.asarray(q), jk, jv, kv_valid=400, kv_chunk=128)
    got = ops.decode_attention(torch.from_numpy(q), tk, tv, kv_valid=400)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_per_sequence_valid_lengths():
    """A (B,) kv_valid masks each sequence on its own: row b equals a
    decode of sequence b alone at its length."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 64, 2, 2, 32, seed=3))
    valid = torch.tensor([5, 64, 17], dtype=torch.int32)
    got = ops.decode_attention(q, k, v, kv_valid=valid)
    for b in range(3):
        one = ops.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   kv_valid=int(valid[b]))
        torch.testing.assert_close(got[b:b + 1], one, atol=1e-6, rtol=1e-6)


# per-sequence lengths >= 1: whole ranges past kv_valid for the short ones
# at every split below L, and one sequence at the full length
RAGGED = (4, 300, 2, 4, 64, [1, 150, 300, 37])


@pytest.mark.parametrize("split", [1, 7, 64, RAGGED[1]])   # RAGGED[1] = L
def test_split_merge_matches_pallas(split):
    B, L, Hkv, rep, D, valid = RAGGED
    q, k, v = _inputs(B, L, Hkv, rep, D, seed=split)
    valid = np.asarray(valid, np.int32)
    want = jax_decode(*(jnp.asarray(a) for a in (q, k, v)),
                      kv_valid=jnp.asarray(valid), kv_chunk=128)
    got = ref.decode_attention_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(valid),
        split)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU mode")
    for B, L, Hkv, rep, D, valid in CASES:
        args = [torch.from_numpy(a).cuda()
                for a in _inputs(B, L, Hkv, rep, D, seed=L)]
        before = kernel.launches
        got = ops.decode_attention(*args, kv_valid=valid)
        assert kernel.launches == before + 1
        want = ref.decode_attention_ref(*args, kv_valid=valid)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    B, L, Hkv, rep, D, valid = RAGGED
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        args = [torch.from_numpy(a).to("cuda", dtype)
                for a in _inputs(B, L, Hkv, rep, D, seed=L)]
        lengths = torch.tensor(valid, dtype=torch.int32, device="cuda")
        got = ops.decode_attention(*args, kv_valid=lengths)
        want = ref.decode_attention_ref(*args, kv_valid=lengths)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    q, _, (tk, tv) = _fp8_case()
    got = ops.decode_attention(torch.from_numpy(q).cuda(), tk.cuda(),
                               tv.cuda(), kv_valid=400)
    want = ref.decode_attention_ref(torch.from_numpy(q).cuda(), tk.cuda(),
                                    tv.cuda(), kv_valid=400)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

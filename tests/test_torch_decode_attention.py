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
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402

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


@pytest.mark.parametrize("split", [None, 7, 64])
def test_empty_sequence_is_a_zero_row(split):
    """kv_valid = [0, 5]: the sequence with no valid slot is a zero row —
    on the CPU path (split None) and in the kernel's split-and-merge
    arithmetic (split 7, 64), which is what the card computes — and the
    other row is within 2e-5 of the reference.

    Row 0 is not compared with the reference, on purpose: the reference
    masks with -1e30 over its padded cache, so a sequence with no valid
    slot gets the mean of V over the padded length, a value that depends on
    its chunk size (``repro/kernels/decode_attention/kernel.py:43-48``).
    The port defines the answer as 0 instead."""
    q, k, v = _inputs(2, 300, 2, 2, 32, seed=0)
    valid = np.asarray([0, 5], np.int32)
    want = jax_decode(*(jnp.asarray(a) for a in (q, k, v)),
                      kv_valid=jnp.asarray(valid), kv_chunk=128)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    if split is None:
        got = ops.decode_attention(*args, kv_valid=torch.from_numpy(valid))
    else:
        got = ref.decode_attention_split_ref(*args, torch.from_numpy(valid),
                                             split)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want)[1],
                               atol=2e-5, rtol=2e-5)

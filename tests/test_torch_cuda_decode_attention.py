"""The flash-decode kernel (``repro_torch.kernels.decode_attention``)
against its plain version on the card, at the reference kernel test's
cases (2e-5), ragged per-sequence lengths in float32 (2e-5) and bfloat16
(2e-2), and a float8 e4m3 cache (1e-4). Free of JAX, so it runs on a
machine with a card and no JAX; the plain version is held to the
reference by ``test_torch_decode_attention.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel, ops, ref  # noqa: E402

CASES = [
    (2, 1000, 2, 4, 64, 777),
    (4, 4096, 1, 2, 128, None),
    (1, 300, 4, 1, 32, 5),
    (3, 129, 2, 2, 64, 129),
]
RAGGED = (4, 300, 2, 4, 64, [1, 150, 300, 37])


def _inputs(B, L, Hkv, rep, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, Hkv * rep, D)).astype(np.float32),
            rng.standard_normal((B, L, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, L, Hkv, D)).astype(np.float32))


def _fp8_case():
    """q float32 (2, 1, 4, 64), k/v float8 e4m3 (2, 500, 2, 64), kv_valid
    400 of 500."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 1, 4, 64)).astype(np.float32)
    kv = [torch.from_numpy(rng.standard_normal((2, 500, 2, 64))
                           .astype(np.float32) * 0.25)
          .to(torch.float8_e4m3fn) for _ in range(2)]
    return q, kv


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
    q, (tk, tv) = _fp8_case()
    got = ops.decode_attention(torch.from_numpy(q).cuda(), tk.cuda(),
                               tv.cuda(), kv_valid=400)
    want = ref.decode_attention_ref(torch.from_numpy(q).cuda(), tk.cuda(),
                                    tv.cuda(), kv_valid=400)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# the model zoo's shapes: head dims 20, 72 and 80 (and 200, 256 past the
# tensor-core kernel's 128), GQA ratios 3, 7 and 16 (groups of 8 heads)
ZOO = [
    (2, 300, 1, 3, 20, 250),
    (2, 300, 2, 4, 72, 300),
    (3, 500, 2, 4, 80, 333),
    (1, 700, 2, 7, 128, 650),
    (2, 400, 1, 16, 64, 399),
    (1, 300, 2, 2, 256, 200),
    (1, 200, 1, 5, 200, 150),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZOO, ids=lambda c: f"D{c[4]}-rep{c[3]}")
def test_zoo_shapes_match_plain_on_the_card(case):
    """float32 within 2e-5 and bfloat16 within 2e-2; D 20 with one KV head
    has 40-byte rows, which load as 4-byte copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU mode")
    B, L, Hkv, rep, D, valid = case
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        args = [torch.from_numpy(a).to("cuda", dtype)
                for a in _inputs(B, L, Hkv, rep, D, seed=D + rep)]
        before = kernel.launches
        got = ops.decode_attention(*args, kv_valid=valid)
        assert kernel.launches == before + 1
        want = ref.decode_attention_ref(*args, kv_valid=valid)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rep,D", [(16, 128), (7, 128), (3, 80)])
def test_fp8_cache_at_zoo_ratios(rep, D):
    """A float8 e4m3 cache at rep 16 and 7, D 128 (llama3-405b's and
    llava-next-34b's serve caches) and rep 3, D 80, ragged lengths: within
    1e-4 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU mode")
    rng = np.random.default_rng(rep)
    q = torch.from_numpy(rng.standard_normal((3, 1, 2 * rep, D))
                         .astype(np.float32)).cuda()
    kv = [torch.from_numpy(rng.standard_normal((3, 600, 2, D))
                           .astype(np.float32) * 0.25)
          .to(torch.float8_e4m3fn).cuda() for _ in range(2)]
    lengths = torch.tensor([600, 17, 444], dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, *kv, kv_valid=lengths)
    want = ref.decode_attention_ref(q, *kv, kv_valid=lengths)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

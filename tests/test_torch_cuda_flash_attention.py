"""The flash-attention kernel (``repro_torch.kernels.flash_attention``)
against its plain version on the card, at the reference kernel test's
cases and the bf16 kernel's edges, in float32 (2e-5) and bfloat16 (2e-2).
Free of JAX, so it runs on a machine with a card and no JAX; the plain
version is held to the reference by ``test_torch_flash_attention.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

CASES = [
    (1, 640, 2, 2, 64, True, None),
    (2, 512, 1, 3, 128, True, 256),
    (1, 384, 2, 1, 64, False, None),
    (1, 300, 1, 1, 128, True, None),   # ragged seq
]
DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]
# the bf16 kernel's 128-row tiles: ragged S, a window shorter than a key
# tile, narrow heads
EDGES = [
    (2, 200, 2, 2, 128, True, None),
    (1, 700, 2, 2, 128, True, 50),
    (1, 300, 2, 2, 16, True, None),
    (1, 300, 2, 2, 32, False, None),
]


def _inputs(B, S, Hkv, rep, D, seed):
    rng = np.random.default_rng(seed)
    H = Hkv * rep
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    for B, S, Hkv, rep, D, causal, window in CASES + EDGES:
        for dtype, tol in DTYPES:
            args = [torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                    for a in _inputs(B, S, Hkv, rep, D, seed=S)]
            before = kernel.launches
            got = ops.flash_attention(*args, causal=causal, window=window)
            assert kernel.launches == before + 1
            want = ref.flash_attention_ref(*args, causal=causal, window=window)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
def test_bf16_kernel_launches_from_a_fresh_thread():
    """A thread whose first CUDA call is the bf16 launch (its TMA tensor
    maps are encoded before any kernel runs) gets the main thread's
    output bitwise."""
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    args = [torch.from_numpy(a).to("cuda", torch.bfloat16)
            for a in _inputs(1, 384, 2, 2, 128, seed=3)]
    want = ops.flash_attention(*args, causal=True, window=None)
    torch.cuda.synchronize()
    got = []
    t = threading.Thread(target=lambda: got.append(
        ops.flash_attention(*args, causal=True, window=None)))
    t.start()
    t.join()
    torch.cuda.synchronize()
    assert len(got) == 1 and torch.equal(got[0], want)

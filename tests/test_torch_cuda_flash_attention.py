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


# the model zoo's shapes: head dims 20 (40-byte rows, one KV head: the
# CUDA-core kernel's element loads), 72 and 80 (the wgmma kernel padded to
# 80), GQA ratios 3, 7 and 16, a head dim past the wgmma kernel's 128
ZOO = [
    (1, 300, 1, 3, 20, True, None),
    (2, 257, 2, 2, 72, True, None),
    (1, 300, 2, 4, 80, True, 100),
    (1, 200, 1, 16, 64, True, None),
    (1, 260, 1, 7, 128, False, None),
    (1, 130, 2, 1, 200, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZOO, ids=lambda c: f"D{c[4]}-rep{c[3]}")
def test_zoo_shapes_match_plain_on_the_card(case):
    """Every zoo shape in float32 (2e-5) and bfloat16 (2e-2); bfloat16 at
    D 72 and 80 takes the tensor-core kernel, D 20 (a 40-byte row stride)
    and D 200 the CUDA-core one, none copied to an aligned buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    B, S, Hkv, rep, D, causal, window = case
    for dtype, tol in DTYPES:
        args = [torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                for a in _inputs(B, S, Hkv, rep, D, seed=D + rep)]
        path = "wgmma" if kernel.wgmma_path(*args) else "core"
        assert path == ("wgmma" if dtype == "bfloat16" and D in (64, 72, 80,
                                                                 128)
                        else "core")
        before = dict(kernel.path_launches)
        got = ops.flash_attention(*args, causal=causal, window=window)
        assert kernel.path_launches[path] == before[path] + 1
        want = ref.flash_attention_ref(*args, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
def test_padded_views_take_the_tensor_cores():
    """Views of the first 52 and 36 columns of 64-wide rows (16-byte
    strides, a TMA box wider than the columns, zero-filled past them) take
    the wgmma kernel and agree with the plain version within 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    for D in (52, 36):
        full = [torch.from_numpy(a).to("cuda", torch.bfloat16)
                for a in _inputs(1, 200, 2, 2, 64, seed=D)]
        args = [a[..., :D] for a in full]
        assert kernel.wgmma_path(*args)
        got = ops.flash_attention(*args, causal=True)
        want = ref.flash_attention_ref(*args, causal=True)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)

"""The flash-attention kernel (``repro_torch.kernels.flash_attention``)
against its plain version on the card, at the reference kernel test's
cases and the bf16 kernel's edges, in float32 (2e-5) and bfloat16 (2e-2).
Free of JAX, so it runs on a machine with a card and no JAX; the plain
version is held to the reference by ``test_torch_flash_attention.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward, kernel, ops, ref)

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


# the training forward: the rows' log-sum-exp beside the output
LSE = [
    (1, 640, 2, 2, 64, True, None),
    (1, 300, 2, 4, 80, True, 100),
    (2, 257, 1, 3, 20, True, None),
    (1, 384, 2, 1, 128, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LSE, ids=lambda c: f"D{c[4]}-rep{c[3]}")
def test_lse_matches_plain_on_the_card(case):
    """``return_lse``: the output as without it (bitwise), and the lse
    against the plain version's within 1e-4 in both dtypes: each computes
    it in float32 from the same inputs (the bfloat16 kernel rounds P to
    bfloat16 for O, not for l or m)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    B, S, Hkv, rep, D, causal, window = case
    for dtype in ("float32", "bfloat16"):
        args = [torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                for a in _inputs(B, S, Hkv, rep, D, seed=D)]
        scale = 1.0 / D ** 0.5
        out, lse = kernel.flash_fwd(*args, causal=causal, window=window,
                                    scale=scale, return_lse=True)
        alone = kernel.flash_fwd(*args, causal=causal, window=window,
                                 scale=scale)
        assert lse.shape == (B, Hkv * rep, S) and lse.dtype == torch.float32
        assert torch.equal(out, alone)
        _, want = ref.flash_attention_ref(*args, causal=causal, window=window,
                                          return_lse=True)
        torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grads_on_the_card(dtype):
    """``FlashAttention`` on the card (the kernel's forward with lse, the
    backward kernel): its gradients against autograd through direct
    attention, in float32 within 1e-3 relative Frobenius (5e-2 in
    bfloat16); one forward and one backward launch, the kernel refuses a
    differentiated input outside it, and a shape it does not take (q/k
    and v of different widths) raises rather than run plain."""
    from repro_torch.models import flash_ref, layers

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    tol = 1e-3 if dtype == "float32" else 5e-2
    q, k, v = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
               .requires_grad_() for a in _inputs(1, 1280, 2, 3, 64, seed=9))
    dout = torch.randn(q.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    before = kernel.launches
    out = flash_ref.flash_attention_ref(q, k, v, causal=True, window=700,
                                        q_chunk=512, kv_chunk=256)
    assert kernel.launches == before + 1
    bwd_before = backward.launches
    got = torch.autograd.grad(out, (q, k, v), dout.to(out.dtype))
    assert backward.launches == bwd_before + 1
    assert kernel.launches == before + 1
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref_out = layers.sdpa_reference(qf, kf, vf, causal=True, window=700)
    want = torch.autograd.grad(ref_out, (qf, kf, vf), dout)
    for a, b in zip(got, want):
        assert float((a.float() - b).norm() / b.norm()) <= tol
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.flash_fwd(q, k, v, causal=True, window=None, scale=0.125)
    with pytest.raises(ValueError, match="do not fit"):
        flash_ref.flash_attention_ref(q, k, v[..., :32], causal=True)


# the backward kernel against the plain flash backward: (label, B, Sq, Sk,
# Hkv, rep, D, causal, window); smollm's training microbatch whole and cut
# to S 1024, h2o's D 80 rep 4 with its 4096 window at S 8192 (one
# sequence, two KV heads), D 72 (wgmma at 80), D 96, D 32, D 128, D 24, 48
# and 112 (wgmma with the columns past D zero-filled by TMA at 32, 64 and
# 128), D 256 (the CUDA cores in both dtypes), D 20 (40-byte rows TMA
# cannot take: the CUDA cores' element copies), cross-attention's Sq != Sk
# without a mask, a ragged S of 1000
BWD = [
    ("smollm-full", 4, 4096, 4096, 5, 3, 64, True, None),
    ("smollm", 2, 1024, 1024, 5, 3, 64, True, None),
    ("h2o-window", 1, 8192, 8192, 2, 4, 80, True, 4096),
    ("D72", 2, 257, 257, 2, 2, 72, True, None),
    ("D96", 1, 384, 384, 2, 2, 96, True, None),
    ("D32", 2, 300, 300, 1, 4, 32, True, 100),
    ("D128", 1, 640, 640, 2, 2, 128, True, 300),
    ("D24", 1, 333, 333, 1, 3, 24, True, None),
    ("D48", 2, 517, 517, 2, 2, 48, True, None),
    ("D112", 1, 777, 777, 2, 2, 112, True, None),
    ("D256", 1, 300, 300, 2, 2, 256, True, None),
    ("D20", 1, 300, 300, 1, 3, 20, True, None),
    ("cross", 2, 640, 1280, 2, 2, 64, False, None),
    ("ragged", 1, 1000, 1000, 2, 3, 64, True, None),
]
BWD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}   # relative Frobenius


def _bwd_inputs(B, sq, sk, hkv, rep, D, causal, window, dtype, seed):
    """q, k, v, dout from a seed in ``dtype`` on the card, and the forward's
    out and lse from the plain chunked forward."""
    from repro_torch.models import flash_ref

    rng = np.random.default_rng(seed)
    H = hkv * rep
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to("cuda", dtype) for s in (
        (B, sq, H, D), (B, sk, hkv, D), (B, sk, hkv, D), (B, sq, H, D)))
    out, lse = flash_ref.flash_forward_plain(q, k, v, causal=causal,
                                             window=window, scale=D ** -0.5)
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD, ids=lambda c: c[0])
def test_backward_matches_plain_on_the_card(case):
    """dq, dk and dv of the backward kernel against ``flash_backward`` on
    the same inputs, each within 1e-3 relative Frobenius in float32 (the
    sums run in another order) and 5e-2 in bfloat16 (P and dS are rounded
    to bfloat16 for the tensor cores); one launch a call, on the path the
    inputs pick: wgmma for bfloat16 at 16 <= D <= 128 on 16-byte rows (D a
    multiple of 8), the CUDA cores for float32, D 256 and D 20's 40-byte
    rows."""
    from repro_torch.models import flash_ref

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    _, B, sq, sk, hkv, rep, D, causal, window = case
    for dtype, tol in BWD_TOL.items():
        dt = getattr(torch, dtype)
        q, k, v, out, lse, dout = _bwd_inputs(B, sq, sk, hkv, rep, D, causal,
                                              window, dt, seed=D + sq)
        path = ("wgmma" if dtype == "bfloat16" and D % 8 == 0
                and 16 <= D <= 128 else "core")
        assert backward.wgmma_path(q, k, v, out, dout) == (path == "wgmma")
        before = dict(backward.path_launches)
        got = backward.flash_bwd(q, k, v, out, lse, dout, causal=causal,
                                 window=window, scale=D ** -0.5)
        assert backward.path_launches[path] == before[path] + 1
        want = flash_ref.flash_backward(q, k, v, out, lse, dout,
                                        causal=causal, window=window,
                                        scale=D ** -0.5)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            r = float((a.float() - b.float()).norm() / b.float().norm())
            assert r <= tol, f"{dtype} {name}: relative error {r}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_is_deterministic(dtype):
    """Two calls on the same inputs give bitwise the same dq, dk and dv (no
    atomics): a retried training step is bitwise the first. So does a
    call from a thread whose first CUDA call it is (the wgmma path encodes
    its TMA tensor maps before any kernel runs there)."""
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    args = _bwd_inputs(2, 1000, 1000, 2, 3, 64, True, None,
                       getattr(torch, dtype), seed=4)
    assert backward.wgmma_path(*args[:4], args[5]) == (dtype == "bfloat16")
    first = backward.flash_bwd(*args, causal=True, window=None, scale=0.125)
    again = backward.flash_bwd(*args, causal=True, window=None, scale=0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    torch.cuda.synchronize()
    got = []
    t = threading.Thread(target=lambda: got.append(backward.flash_bwd(
        *args, causal=True, window=None, scale=0.125)))
    t.start()
    t.join()
    torch.cuda.synchronize()
    assert len(got) == 1
    assert all(torch.equal(a, b) for a, b in zip(got[0], first))


@pytest.mark.cuda
def test_backward_reads_views_of_a_fused_projection():
    """q, k and v as strided views of one fused (B, S, (H + 2 Hkv) D)
    projection (the tensor maps' row strides are the fused row's, not D)
    take the wgmma kernels and give what contiguous copies give, bitwise,
    within 5e-2 relative of the plain backward."""
    from repro_torch.models import flash_ref

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    B, S, hkv, rep, D = 2, 640, 2, 3, 64
    H = hkv * rep
    rng = np.random.default_rng(11)
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, (H + 2 * hkv) * D)).astype(np.float32)).to("cuda",
                                                         torch.bfloat16)
    q = fused[..., :H * D].unflatten(-1, (H, D))
    k = fused[..., H * D:(H + hkv) * D].unflatten(-1, (hkv, D))
    v = fused[..., (H + hkv) * D:].unflatten(-1, (hkv, D))
    assert not q.is_contiguous() and q.stride(1) == (H + 2 * hkv) * D
    dout = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    out, lse = flash_ref.flash_forward_plain(q, k, v, causal=True,
                                             window=None, scale=D ** -0.5)
    assert backward.wgmma_path(q, k, v, out, dout)
    before = backward.path_launches["wgmma"]
    got = backward.flash_bwd(q, k, v, out, lse, dout, causal=True,
                             window=None, scale=D ** -0.5)
    assert backward.path_launches["wgmma"] == before + 1
    same = backward.flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                              out, lse, dout, causal=True, window=None,
                              scale=D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    want = flash_ref.flash_backward(q, k, v, out, lse, dout, causal=True,
                                    window=None, scale=D ** -0.5)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).norm() / b.float().norm()) \
            <= BWD_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_backward_takes_unaligned_bf16_rows_on_the_cuda_cores(D):
    """bfloat16 q, k, v, out and dout at D 64 and 128 as views whose rows
    start 8 bytes past a 16-byte boundary (TMA cannot take them) run on
    the CUDA cores, within 5e-2 relative of the plain backward."""
    from repro_torch.models import flash_ref

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    B, S, hkv, rep = 1, 300, 2, 2
    H = hkv * rep
    rng = np.random.default_rng(D)

    def view(h):
        # rows of D + 4 elements: a row stride of 2 D + 8 bytes
        wide = torch.from_numpy(rng.standard_normal((B, S, h, D + 4)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        return wide[..., :D]

    q, k, v, dout = view(H), view(hkv), view(hkv), view(H)
    out, lse = flash_ref.flash_forward_plain(q, k, v, causal=True,
                                             window=None, scale=D ** -0.5)
    out = view(H).copy_(out)
    assert not backward.wgmma_path(q, k, v, out, dout)
    before = backward.path_launches["core"]
    got = backward.flash_bwd(q, k, v, out, lse, dout, causal=True,
                             window=None, scale=D ** -0.5)
    assert backward.path_launches["core"] == before + 1
    want = flash_ref.flash_backward(q, k, v, out, lse, dout, causal=True,
                                    window=None, scale=D ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        r = float((a.float() - b.float()).norm() / b.float().norm())
        assert r <= BWD_TOL["bfloat16"], f"{name}: relative error {r}"


@pytest.mark.cuda
def test_backward_refuses_what_it_does_not_take():
    """A head dim off the kernel's widths, a non-contiguous lse and mixed
    dtypes raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU mode")
    q, k, v, out, lse, dout = _bwd_inputs(1, 64, 64, 1, 2, 64, True, None,
                                          torch.bfloat16, seed=5)
    before = backward.launches
    with pytest.raises(ValueError, match="head_dim"):
        backward.flash_bwd(q[..., :62], k[..., :62], v[..., :62],
                           out[..., :62], lse, dout[..., :62], causal=True,
                           window=None, scale=0.125)
    with pytest.raises(ValueError, match="lse"):
        backward.flash_bwd(q, k, v, out, lse.transpose(1, 2).contiguous()
                           .transpose(1, 2), dout, causal=True, window=None,
                           scale=0.125)
    with pytest.raises(ValueError, match="dtype"):
        backward.flash_bwd(q, k, v, out, lse, dout.float(), causal=True,
                           window=None, scale=0.125)
    assert backward.launches == before

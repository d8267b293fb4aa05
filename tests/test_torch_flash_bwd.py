"""The training attention's backward on the CPU: ``FlashAttention``'s
plain ``flash_backward``, reached through the ``use_kernel`` route a CUDA
tensor takes to the backward kernel, against the reference's
``custom_vjp`` (``repro.models.flash_ref.flash_attention_ref``) at the
shapes the kernel's tests on the card use and ``test_torch_flash_ref.py``
lacks: head dims 72 and 80 at GQA ratio 4, a 300-key window at 1280
queries, and cross-attention's Sq 640 x Sk 1280 without a mask. The same
numpy inputs and output cotangent through both, dq, dk and dv within atol
2e-5, rtol 2e-4 (the reference test's tolerance). On the meta device the
backward is one fused op with the kernel's FLOPs and its boundary bytes;
the launcher refuses CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.flash_ref import (  # noqa: E402
    flash_attention_ref as jax_flash)
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.kernels.flash_attention import backward  # noqa: E402
from repro_torch.models import flash_ref  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-4)
CASES = [  # (D, Hkv, rep, Sq, Sk, causal, window)
    (72, 1, 4, 1280, 1280, True, None),
    (80, 1, 4, 1280, 1280, True, None),
    (64, 2, 3, 1280, 1280, True, 300),
    (64, 2, 2, 640, 1280, False, None),
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(D, hkv, rep, sq, sk, seed=7):
    rng = np.random.default_rng(seed)
    H = hkv * rep
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (1, sq, H, D), (1, sk, hkv, D), (1, sk, hkv, D), (1, sq, H, D))]


@pytest.mark.parametrize(
    "case", CASES, ids=lambda c: f"D{c[0]}-rep{c[2]}-{c[3]}x{c[4]}-"
                                 f"{'causal' if c[5] else 'full'}-w{c[6]}")
def test_backward_matches_the_reference(case):
    D, hkv, rep, sq, sk, causal, window = case
    q, k, v, dout = _inputs(D, hkv, rep, sq, sk)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, window=window,
                                 q_chunk=512, kv_chunk=256) * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_ref.flash_attention_ref(*args, causal=causal, window=window,
                                        q_chunk=512, kv_chunk=256)
    got = torch.autograd.grad(out, args, torch.from_numpy(dout))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("causal, window", [(True, None), (True, 300),
                                            (False, None)])
def test_backward_counts_as_one_fused_op(causal, window):
    """On the meta device the backward is one ``flash_attention_bwd`` op:
    the kernel's 2 B H (4 D + 3 Dv) FLOPs a visible pair in the inputs'
    dtype, and the bytes of q, k, v, out, lse, dout, dq, dk and dv only
    (none of the plain version's float32 chunk tensors)."""
    B, sq, sk, hkv, rep, D = 2, 1280, 1280 if causal else 640, 2, 3, 64
    H = hkv * rep
    q = _meta((B, sq, H, D)).requires_grad_()
    k, v = (_meta((B, sk, hkv, D)).requires_grad_() for _ in range(2))
    out = flash_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    dout = _meta(out.shape)
    with cost.CostMode() as mode:
        torch.autograd.grad(out, (q, k, v), dout)
    c = mode.cost
    pairs = cost.visible_pairs(sq, sk, causal=causal, window=window)
    assert set(c.ops) == {"flash_attention_bwd"}
    op = c.ops["flash_attention_bwd"]
    assert op["count"] == 1
    assert op["flops"] == 2 * B * H * (4 * D + 3 * D) * pairs == c.flops
    assert c.flops_by_dtype["bfloat16"] == c.flops
    q_bytes, kv_bytes = B * sq * H * D * 2, B * sk * hkv * D * 2
    lse_bytes = B * H * sq * 4
    assert op["bytes"] == 4 * q_bytes + 4 * kv_bytes + lse_bytes


def test_plain_route_keeps_the_plain_backward():
    """``use_kernel=False`` (MLA's route) runs the plain backward with no
    fused op: its chunk products count one by one."""
    q = _meta((1, 1280, 2, 64)).requires_grad_()
    k, v = (_meta((1, 1280, 1, 64)).requires_grad_() for _ in range(2))
    out = flash_ref.flash_attention_ref(q, k, v, causal=True,
                                        use_kernel=False)
    with cost.CostMode() as mode:
        torch.autograd.grad(out, (q, k, v), _meta(out.shape))
    assert "flash_attention_bwd" not in mode.cost.ops
    assert mode.cost.flops > 0


def test_launcher_refuses_cpu_tensors():
    """``backward.flash_bwd`` takes CUDA tensors only: a CPU tensor is
    refused before any build or launch (the CPU reaches the plain
    backward through ``FlashAttention``, never the launcher)."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(64, 1, 2, 64, 64))
    lse = torch.zeros((1, 2, 64))
    before = backward.launches
    with pytest.raises(ValueError, match="CUDA"):
        backward.flash_bwd(q, k, v, q, lse, dout, causal=True, window=None,
                           scale=0.125)
    assert backward.launches == before

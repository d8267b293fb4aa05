"""The training route's attention: ``repro_torch.models.flash_ref``'s
``FlashAttention`` against the reference's ``custom_vjp``
(``repro.models.flash_ref.flash_attention_ref``) on the CPU, mirroring
``tests/test_kernels.py::test_flash_ref_backward``: the same numpy inputs
and output cotangent through both, the gradients of q, k and v within
atol 2e-5, rtol 2e-4 (the reference test's tolerance), at q/k and v head
dims (64, 64) and (96, 64), 1280 queries in chunks of 512 queries and 256
keys; a windowed and a GQA rep-3 case; the forward's output against the
reference's and its log-sum-exp against the reference's scores'. Plus the
routes ``layers.sdpa`` takes in training, and the guard that keeps the
flash kernel from being differentiated through."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.flash_ref import flash_attention_ref as jax_flash  # noqa: E402
from repro_torch.models import flash_ref, layers  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-4)
CASES = [  # (Dqk, Dv, rep, window)
    (64, 64, 2, None),
    (96, 64, 2, None),
    (64, 64, 2, 300),
    (64, 64, 3, None),
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(Dqk, Dv, rep, Sq=1280, Hkv=2, seed=3):
    rng = np.random.default_rng(seed)
    H = Hkv * rep
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (1, Sq, H, Dqk), (1, Sq, Hkv, Dqk), (1, Sq, Hkv, Dv), (1, Sq, H, Dv))]


def _jax_lse(q, k, window):
    """The reference forward's lse: m + log l of the scaled, masked
    scores, taken directly."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    s = jnp.einsum("bqhrd,bkhd->bhrqk", q.reshape(B, S, Hkv, H // Hkv, D),
                   k) / math.sqrt(D)
    i = jnp.arange(S)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[None, :] > i[:, None] - window
    s = jnp.where(ok, s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, S)


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"D{c[0]}-{c[1]}-rep{c[2]}-w{c[3]}")
def test_flash_attention_grads_match_the_reference(case):
    Dqk, Dv, rep, window = case
    q, k, v, dout = _inputs(Dqk, Dv, rep)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=True, window=window,
                                 q_chunk=512, kv_chunk=256) * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    want_out = jax_flash(q, k, v, causal=True, window=window, q_chunk=512,
                         kv_chunk=256)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_ref.flash_attention_ref(tq, tk, tv, causal=True,
                                        window=window, q_chunk=512,
                                        kv_chunk=256)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    _, lse = flash_ref.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, scale=1.0 / math.sqrt(Dqk), q_chunk=512,
        kv_chunk=256)
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(q, k, window)),
                               **TOL)


def test_plain_route_agrees_with_direct_attention_at_odd_chunks():
    """Ragged chunks (100 queries, 70 keys a chunk over 250 positions),
    non-causal and causal, against autograd through direct attention."""
    q, k, v, dout = _inputs(32, 32, 2, Sq=250, seed=5)
    for causal in (True, False):
        args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = flash_ref.flash_attention_ref(*args, causal=causal,
                                            q_chunk=100, kv_chunk=70)
        got = torch.autograd.grad(out, args, torch.from_numpy(dout))
        args2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        ref = layers.sdpa_reference(*args2, causal=causal)
        want = torch.autograd.grad(ref, args2, torch.from_numpy(dout))
        torch.testing.assert_close(out, ref, **TOL)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


def test_sdpa_train_routes_on_the_cpu(monkeypatch):
    """In training ``sdpa`` takes direct attention up to 1024 queries and
    ``FlashAttention`` past that, the reference's split; without grad it
    keeps the serve route; MLA's ``sdpa_plain`` past 1024 queries takes
    ``FlashAttention`` with the kernel off."""
    calls = []
    real = flash_ref.FlashAttention.apply
    monkeypatch.setattr(flash_ref.FlashAttention, "apply",
                        lambda *a: calls.append(a[-1]) or real(*a))
    for S, n in ((1024, 0), (1040, 1)):
        q, k, v, _ = _inputs(16, 16, 1, Sq=S, Hkv=1)
        args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        layers.sdpa(*args, causal=True)
        assert len(calls) == n
        with torch.no_grad():
            layers.sdpa(*args, causal=True)
        assert len(calls) == n
    layers.sdpa_plain(*args, causal=True)
    assert calls == [True, False]


def test_flash_kernel_refuses_to_be_differentiated_through():
    """``kernel.flash_fwd`` has no backward: with grad mode on, an input
    that requires grad is refused before any launch (the CPU reaches the
    guard before the launcher's CUDA check), and with grad mode off the
    launcher goes on to its CUDA check."""
    from repro_torch.kernels.flash_attention import kernel

    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    kv = torch.zeros((1, 4, 1, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.flash_fwd(q, kv, kv, causal=True, window=None, scale=0.25)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        kernel.flash_fwd(q, kv, kv, causal=True, window=None, scale=0.25)

"""The Expected-Attention scoring kernel
(``repro_torch.kernels.expected_attention``) against its plain version on
the card: at the reference kernel test's cases in float32 and bfloat16,
scores within rtol 1e-5, and the kept indices equal to a top-keep of the
plain scores wherever it is well posed (keep-th and (keep+1)-th scores
more than 1e-5 apart, relative); every head dim and rep of the vector path;
a strided cache view it takes, and caches it cannot take (a stride or a base
off 16 bytes), which the scalar-load path scores within the same rtol. Free
of JAX, so it runs on a machine with a card and no JAX; the plain version
is held to the reference by ``test_torch_expected_attention.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.expected_attention import kernel, ops, ref  # noqa: E402

CASES = [
    (2, 512, 2, 2, 64, 100),
    (1, 1000, 4, 1, 32, 128),
    (1, 130, 1, 4, 128, 13),
]
TIE = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scoring kernel has no CPU mode")
    return torch.device("cuda")


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


def scored(k, v, mu, var, path):
    """The kernel's scores within rtol 1e-5 of the plain version's, through
    the path the caches pick, which must be ``path``."""
    before = dict(kernel.path_launches)
    got = ops.ea_scores(k, v, mu, var)
    assert kernel.path_launches[path] == before[path] + 1
    want = ref.ea_scores_ref(k, v, mu, var)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    return want


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(card):
    for B, S, Hkv, rep, D, keep in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            k, v, mu, var = (torch.from_numpy(a).to(card)
                             for a in _inputs(B, S, Hkv, rep, D, seed=S))
            k, v = k.to(dtype), v.to(dtype)
            before = kernel.launches
            want = scored(k, v, mu, var, "vector" if dtype == torch.bfloat16
                          else "scalar")
            assert kernel.launches == before + 1
            kc, _, idx = ops.compress(k, v, mu, var, keep=keep)
            if keep_gap(want.cpu().numpy(), keep) > TIE:
                s = torch.topk(want.transpose(1, 2), keep, dim=-1).indices
                assert torch.equal(idx, torch.sort(s, dim=-1).values.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("rep", [1, 3, 8])
def test_vector_path_takes_every_head_dim_and_rep(card, D, rep):
    """B 3, S 37: positions end mid-way through a warp's step."""
    k, v, mu, var = (torch.from_numpy(a).to(card)
                     for a in _inputs(3, 37, 3, rep, D, seed=D + rep))
    scored(k.bfloat16(), v.bfloat16(), mu, var, "vector")


@pytest.mark.cuda
def test_strided_and_unaligned_caches(card):
    """A view of every other head (strides 16-byte multiples, not
    contiguous) takes the vector path; a row stride of D + 4 elements and a
    base one element off take the scalar-load path, which the vector entry
    point refuses."""
    B, S, Hkv, rep, D = 2, 300, 4, 4, 128
    k, v, mu, var = (torch.from_numpy(a).to(card)
                     for a in _inputs(B, S, 2 * Hkv, rep, D, seed=7))
    k, v = k.bfloat16(), v.bfloat16()
    mu, var = mu[:Hkv].contiguous(), var[:Hkv].contiguous()
    ks, vs = k[:, :, ::2], v[:, :, ::2]
    assert not ks.is_contiguous()
    scored(ks, vs, mu, var, "vector")

    wide_k = torch.zeros((B, S, Hkv, D + 4), dtype=torch.bfloat16, device=card)
    wide_v = torch.zeros_like(wide_k)
    wide_k[..., :D], wide_v[..., :D] = ks, vs
    flat_k = torch.zeros(B * S * Hkv * D + 1, dtype=torch.bfloat16, device=card)
    flat_v = torch.zeros_like(flat_k)
    off_k = flat_k[1:].view(B, S, Hkv, D)
    off_v = flat_v[1:].view(B, S, Hkv, D)
    off_k.copy_(ks)
    off_v.copy_(vs)
    for kk, vv in ((wide_k[..., :D], wide_v[..., :D]), (off_k, off_v)):
        assert not kernel.vector_path(kk, vv)
        scored(kk, vv, mu, var, "scalar")
        with pytest.raises(ValueError):
            kernel.ea_scores_vector(kk, vv, mu, var)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [20, 72, 80, 256])
@pytest.mark.parametrize("rep", [3, 7, 16])
def test_zoo_head_dims_and_ratios(card, D, rep):
    """The zoo's head dims and GQA ratios in float32 and bfloat16, scores
    within rtol 1e-5: bfloat16 at D 72, 80 and 256 takes the vector path
    (rep 16 in two passes of 8), D 20 (40-byte rows) the scalar-load
    path."""
    for dtype in (torch.float32, torch.bfloat16):
        k, v, mu, var = (torch.from_numpy(a).to(card)
                         for a in _inputs(2, 45, 2, rep, D, seed=D * rep))
        path = ("vector" if dtype == torch.bfloat16 and D % 8 == 0
                else "scalar")
        scored(k.to(dtype), v.to(dtype), mu, var, path)


@pytest.mark.cuda
def test_fp8_cache_at_rep_16(card):
    """A float8 e4m3 serve cache (llama3-405b's: D 128, 16 query heads a KV
    head) takes the scalar-load path, within rtol 1e-5 of the plain
    scores over the same fp8 values."""
    k, v, mu, var = (torch.from_numpy(a).to(card)
                     for a in _inputs(2, 300, 2, 16, 128, seed=16))
    fp8 = torch.float8_e4m3fn
    scored((k * 0.25).to(fp8), (v * 0.25).to(fp8), mu, var, "scalar")

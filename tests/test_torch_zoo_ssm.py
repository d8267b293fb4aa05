"""The Mamba2 / SSD layer of the port (``repro_torch.models.ssm``), the
two SSM tests of ``tests/test_ssm_and_layers.py`` mirrored: the chunked
scan equals the sequential recurrence, and a prefill then decode continues
the full pass. Each also runs the reference (``repro.models.ssm``) on the
same numpy inputs and parameters, in float32, within 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import nn as jax_nn  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import nn, ssm  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_ssd_chunked_equals_sequential():
    """S 130 over chunks of 32 (a ragged last chunk), 4 heads in 2 groups:
    the chunked scan equals the one-token recurrence within 1e-4, and both
    equal the reference's within 1e-4."""
    rng = np.random.default_rng(0)
    B, S, H, P, G, N, Lc = 2, 130, 4, 8, 2, 16, 32
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((H,)) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    y, hT = ssm.ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), Lc)
    h = torch.zeros((B, H, P, N))
    ys = []
    for s in range(S):
        yt, h = ssm.ssd_decode_step(t(x[:, s]), t(dt[:, s]), t(A),
                                    t(Bm[:, s]), t(Cm[:, s]), h)
        ys.append(yt)
    torch.testing.assert_close(y, torch.stack(ys, 1), atol=TOL, rtol=TOL)
    torch.testing.assert_close(hT, h, atol=TOL, rtol=TOL)
    jy, jh = jax_ssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              Lc)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)


def test_mamba_prefill_then_decode_continues():
    """mamba2's smoke layer in float32: a prefill of 24 then 4 decode
    steps equal the full pass of 28 (the reference test's 2e-2, met here
    within 1e-4), and every output equals the reference's within 1e-4."""
    jcfg = dataclasses.replace(jax_get_config("mamba2-130m", smoke=True),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    jp = jax_nn.init_params(jax.random.PRNGKey(1), jax_ssm.mamba_specs(jcfg))
    # the reference initialises dt_bias and conv_b to zeros and A_log, D to
    # ones: draw them so that every parameter matters
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    for name in ("conv_b", "dt_bias", "A_log", "D"):
        tree[name] = (tree[name] + 0.3 * rng.standard_normal(
            tree[name].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    p = nn.tree_map(lambda s, a: torch.from_numpy(a.copy()).to(s.dtype),
                    ssm.mamba_specs(cfg), tree)
    B, S = 2, 24
    x = (rng.standard_normal((B, S + 4, cfg.d_model)) * 0.3).astype(
        np.float32)

    y_full, _ = ssm.mamba_apply(p, t(x), cfg=cfg, mode="prefill")
    jy_full, _ = jax_ssm.mamba_apply(jp, jnp.asarray(x), cfg=jcfg,
                                     mode="train")
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy_full), atol=TOL,
                               rtol=TOL)
    cache = nn.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                        ssm.make_ssm_cache_specs(cfg, B))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jax_ssm.make_ssm_cache_specs(jcfg, B),
                          is_leaf=jax_nn.is_spec)
    y_pre, cache = ssm.mamba_apply(p, t(x[:, :S]), cfg=cfg, cache=cache,
                                   mode="prefill")
    _, jcache = jax_ssm.mamba_apply(jp, jnp.asarray(x[:, :S]), cfg=jcfg,
                                    cache=jcache, mode="prefill")
    torch.testing.assert_close(y_pre, y_full[:, :S], atol=TOL, rtol=TOL)
    for name in ("conv", "state"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL,
                                   rtol=TOL)
    jdecode = jax.jit(functools.partial(jax_ssm.mamba_apply, cfg=jcfg,
                                        mode="decode"))
    for s in range(S, S + 4):
        y_t, cache = ssm.mamba_apply(p, t(x[:, s:s + 1]), cfg=cfg,
                                     cache=cache, mode="decode")
        jy_t, jcache = jdecode(jp, jnp.asarray(x[:, s:s + 1]), cache=jcache)
        torch.testing.assert_close(y_t[:, 0], y_full[:, s], atol=TOL,
                                   rtol=TOL, msg=f"decode step {s}")
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=TOL,
                                   rtol=TOL)

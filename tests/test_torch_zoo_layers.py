"""Layer-level numerics of the port's zoo modules
(``repro_torch.models.layers``), the five layer tests of
``tests/test_ssm_and_layers.py`` mirrored: MoE outputs finite and gates
normalised, the capacity drop, the SWA ring decode against the full pass,
MLA's absorbed decode against the expanded prefill, and RoPE's relative
property. Each also runs the reference on the same numpy inputs and
parameters, in float32, within 1e-4; MoE routing is compared where no
gate is a near-tie (the test asserts every token's k-th and (k+1)-th gate
probabilities differ by more than 1e-4)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import nn as jax_nn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import layers, nn  # noqa: E402

TOL, TIE = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_configs(arch):
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                param_dtype=jnp.float32,
                                compute_dtype=jnp.float32),
            dataclasses.replace(get_config(arch, smoke=True),
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32))


def both_params(jspecs, specs, seed):
    """The reference's params (jax arrays) and the same as torch tensors."""
    jp = jax_nn.init_params(jax.random.PRNGKey(seed), jspecs)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jp)
    return jp, nn.tree_map(lambda s, a: torch.from_numpy(a).to(s.dtype),
                           specs, tree)


def zeros(specs):
    return nn.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), specs)


def jzeros(specs):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), specs,
                        is_leaf=jax_nn.is_spec)


def routing_gap(x, router, k):
    """Smallest gap between a token's k-th and (k+1)-th gate probability."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).double()
                          @ router.double(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


def moe_case(jcfg, cfg, B, S, seed):
    jp, p = both_params(jl.moe_specs(jcfg), layers.moe_specs(cfg), seed)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    assert routing_gap(torch.from_numpy(x), p["router"],
                       cfg.moe.top_k) > TIE
    y, aux = layers.moe_apply(p, torch.from_numpy(x), cfg=cfg)
    jy, jaux = jax.jit(functools.partial(jl.moe_apply, cfg=jcfg))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)
    return y, aux


def test_moe_outputs_finite_and_gates_normalized():
    """qwen3-moe's smoke layer (8 experts, top 2): finite, load-balance
    loss >= 1, drop share below 0.8; with a shared expert
    (deepseek-v2-lite's smoke layer) too."""
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
        jcfg, cfg = f32_configs(arch)
        y, aux = moe_case(jcfg, cfg, 2, 16, seed=2)
        assert torch.isfinite(y).all()
        assert float(aux["moe_lb_loss"]) >= 1.0 - 1e-3
        assert 0.0 <= float(aux["moe_drop_frac"]) < 0.8


def test_moe_capacity_drops_overflow():
    """Capacity factor 0.25: a quarter of the slots, so assignments drop
    (more than 0.2 of them), exactly as the reference drops them."""
    kw = dict(name="t", family="moe", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
              mlp_pattern=("moe",))
    moe = dict(num_experts=4, top_k=2, d_expert=16, capacity_factor=0.25)
    jcfg = JaxModelConfig(**kw, moe=JaxMoEConfig(**moe),
                          param_dtype=jnp.float32, compute_dtype=jnp.float32)
    cfg = ModelConfig(**kw, moe=MoEConfig(**moe), param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    _, aux = moe_case(jcfg, cfg, 1, 32, seed=3)
    assert float(aux["moe_drop_frac"]) > 0.2


def test_swa_ring_buffer_decode_matches_full():
    """h2o-danube's smoke layer (window 16): a prefill of 24 (> 16: the
    ring rolls by 8), then 16 decode steps that wrap the ring, each equal
    to the full pass at its position within 1e-4 (the reference test's
    2e-3), and the ring's contents and each output equal to the
    reference's within 1e-4."""
    jcfg, cfg = f32_configs("h2o-danube-1.8b")
    assert cfg.window == 16
    jp, p = both_params(jl.attention_specs(jcfg), layers.attention_specs(cfg),
                        4)
    B, S = 1, 40
    x = (np.random.default_rng(4).standard_normal((B, S, cfg.d_model))
         * 0.5).astype(np.float32)
    y_full, _ = layers.attention_apply(p, torch.from_numpy(x), cfg=cfg,
                                       positions=torch.arange(S),
                                       mode="prefill")
    jy_full, _ = jl.attention_apply(jp, jnp.asarray(x), cfg=jcfg,
                                    positions=jnp.arange(S), mode="train")
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy_full), atol=TOL,
                               rtol=TOL)
    cache = zeros(layers.make_attn_cache_specs(cfg, B, S))
    jcache = jzeros(jl.make_attn_cache_specs(jcfg, B, S))
    assert cache["k"].shape[1] == 16
    _, cache = layers.attention_apply(p, torch.from_numpy(x[:, :24]),
                                      cfg=cfg, positions=torch.arange(24),
                                      cache=cache, mode="prefill")
    _, jcache = jl.attention_apply(jp, jnp.asarray(x[:, :24]), cfg=jcfg,
                                   positions=jnp.arange(24), cache=jcache,
                                   mode="prefill")
    jdecode = jax.jit(functools.partial(jl.attention_apply, cfg=jcfg,
                                        mode="decode"))
    for t in range(24, S):
        y_t, cache = layers.attention_apply(
            p, torch.from_numpy(x[:, t:t + 1]), cfg=cfg,
            positions=torch.tensor([t]), cache=cache, cache_index=t,
            mode="decode")
        jy_t, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]),
                               positions=jnp.asarray(t), cache=jcache,
                               cache_index=jnp.asarray(t))
        torch.testing.assert_close(y_t[:, 0], y_full[:, t], atol=TOL,
                                   rtol=TOL, msg=f"SWA decode step {t}")
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=TOL,
                                   rtol=TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n].numpy(),
                                       np.asarray(jcache[n]), atol=TOL,
                                       rtol=TOL)


def test_mla_absorbed_decode_matches_expanded():
    """deepseek-v2-lite's smoke layer: a prefill of 8 then 4 absorbed
    decode steps equal the expanded full pass within 1e-4 (the reference
    test's 3e-3), and each output and the latent caches equal the
    reference's within 1e-4; every call took the plain route."""
    jcfg, cfg = f32_configs("deepseek-v2-lite-16b")
    jp, p = both_params(jl.mla_specs(jcfg), layers.mla_specs(cfg), 5)
    B, S = 2, 12
    x = (np.random.default_rng(5).standard_normal((B, S, cfg.d_model))
         * 0.5).astype(np.float32)
    before = layers.plain_attention_calls
    y_full, _ = layers.mla_apply(p, torch.from_numpy(x), cfg=cfg,
                                 positions=torch.arange(S), mode="prefill")
    jy_full, _ = jl.mla_apply(jp, jnp.asarray(x), cfg=jcfg,
                              positions=jnp.arange(S), mode="train")
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy_full), atol=TOL,
                               rtol=TOL)
    cache = zeros(layers.make_mla_cache_specs(cfg, B, S))
    jcache = jzeros(jl.make_mla_cache_specs(jcfg, B, S))
    _, cache = layers.mla_apply(p, torch.from_numpy(x[:, :8]), cfg=cfg,
                                positions=torch.arange(8), cache=cache,
                                mode="prefill")
    _, jcache = jl.mla_apply(jp, jnp.asarray(x[:, :8]), cfg=jcfg,
                             positions=jnp.arange(8), cache=jcache,
                             mode="prefill")
    jdecode = jax.jit(functools.partial(jl.mla_apply, cfg=jcfg,
                                        mode="decode"))
    for t in range(8, S):
        y_t, cache = layers.mla_apply(
            p, torch.from_numpy(x[:, t:t + 1]), cfg=cfg,
            positions=torch.tensor([t]), cache=cache, cache_index=t,
            mode="decode")
        jy_t, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]),
                               positions=jnp.asarray(t), cache=jcache,
                               cache_index=jnp.asarray(t))
        torch.testing.assert_close(y_t[:, 0], y_full[:, t], atol=TOL,
                                   rtol=TOL, msg=f"MLA decode step {t}")
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), atol=TOL,
                                   rtol=TOL)
    for n in ("ckv", "krope"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=TOL, rtol=TOL)
    assert layers.plain_attention_calls == before + 2 + 4


def test_rope_relative_property():
    """<q_m, k_n> depends only on m - n, and the port's rotation equals
    the reference's within 1e-4."""
    rng = np.random.default_rng(6)
    D = 32
    q = rng.standard_normal((1, 1, 1, D)).astype(np.float32)
    k = rng.standard_normal((1, 1, 1, D)).astype(np.float32)

    def dot_at(m, n):
        qm = layers.apply_rope(torch.from_numpy(q), torch.tensor([m]), 1e4)
        kn = layers.apply_rope(torch.from_numpy(k), torch.tensor([n]), 1e4)
        np.testing.assert_allclose(
            qm.numpy(), np.asarray(jl.apply_rope(jnp.asarray(q),
                                                 jnp.asarray([m]), 1e4)),
            atol=TOL, rtol=TOL)
        return float((qm * kn).sum())

    assert dot_at(5, 3) == pytest.approx(dot_at(105, 103), abs=1e-3)
    assert dot_at(0, 0) == pytest.approx(dot_at(50, 50), abs=1e-3)

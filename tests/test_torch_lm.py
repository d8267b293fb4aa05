"""The port's LM (``repro_torch.models``) against the reference's on
the ``llava-next-8b`` smoke config, with the reference's parameters carried
across by ``params_from_numpy``: prefill last-token logits, the prefill KV
cache, and the logits of 3 decode steps against that cache. Both sides run
in float32 (``dataclasses.replace`` of the dtypes) within 1e-4; one
bfloat16 case, on the config as registered, within 2e-2. And
``params_from_numpy`` on the stacks that are not one uniform block:
leading unstacked layers, a period of 8, an encoder-decoder."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import nn as jax_nn  # noqa: E402
from repro.models import steps as jax_steps  # noqa: E402
from repro.models.lm import stack_layout as jax_stack_layout  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import nn, steps  # noqa: E402

B, DECODE_STEPS = 3, 3


def _configs(dtype):
    jcfg = jax_get_config("llava-next-8b", smoke=True)
    cfg = get_config("llava-next-8b", smoke=True)
    assert cfg.name == jcfg.name and cfg.d_model == jcfg.d_model
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    return jcfg, cfg


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def jax_layer(cache, li):
    """Layer ``li``'s {"k", "v"} of a reference cache (all layers stacked
    in one block), as float32 numpy."""
    return {n: np.asarray(cache["blocks"][0][n][li], np.float32)
            for n in ("k", "v")}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_and_decode_match_the_reference(dtype, tol):
    jcfg, cfg = _configs(dtype)
    # the reference stacks every layer in one block: the layout the port
    # hard-codes
    assert jax_stack_layout(jcfg) == (0, 1, cfg.num_layers)
    jparams = jax_nn.init_params(jax.random.PRNGKey(0),
                                 jax_steps.model_specs(jcfg))
    params = nn.params_from_numpy(_to_numpy(jparams), cfg)
    assert params["embed"].dtype == cfg.param_dtype

    rng = np.random.default_rng(0)
    S = cfg.vlm.num_patch_tokens
    patches = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1))
    max_len = S + DECODE_STEPS

    jprefill = jax.jit(jax_steps.make_prefill_step(jcfg, batch=B,
                                                   max_len=max_len))
    jlogits, jcache = jprefill(jparams, {"patch_embeds": jnp.asarray(
        patches, jcfg.compute_dtype)})
    prefill = steps.make_prefill_step(cfg, batch=B, max_len=max_len)
    logits, cache = prefill(params, {"patch_embeds": torch.from_numpy(
        patches).to(cfg.compute_dtype)})
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(jlogits, np.float32), atol=tol,
                               rtol=tol)
    for li in range(cfg.num_layers):
        want = jax_layer(jcache, li)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[li][n].float().numpy(), want[n],
                                       atol=tol, rtol=tol)

    jdecode = jax.jit(jax_steps.make_decode_step(jcfg))
    decode = steps.make_decode_step(cfg)
    for t in range(DECODE_STEPS):
        jlogits, jcache = jdecode(jparams, jcache,
                                  {"tokens": jnp.asarray(toks[t], jnp.int32)},
                                  jnp.asarray(S + t, jnp.int32))
        logits, cache = decode(params, cache,
                               {"tokens": torch.from_numpy(toks[t])}, S + t)
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(jlogits, np.float32), atol=tol,
                                   rtol=tol)


def test_init_params_draws_the_reference_distribution():
    """Seeded init: as many parameters as the reference's specs, deterministic
    for a seed, truncated normal at ±2 std with fan-in scaling, embed
    normal, norms ones."""
    cfg = get_config("llava-next-8b", smoke=True)
    specs = steps.model_specs(cfg)
    a = nn.init_params(specs, torch.Generator().manual_seed(0))
    b = nn.init_params(specs, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(nn.tree_leaves(a),
                                                 nn.tree_leaves(b)))
    jspecs = jax_steps.model_specs(jax_get_config("llava-next-8b", smoke=True))
    assert jax_nn.count_params(jspecs) == sum(
        x.numel() for x in nn.tree_leaves(a))
    wq = a["layers"][0]["mixer"]["wq"].float()
    std = 1.0 / np.sqrt(np.prod(wq.shape[:-1]))   # fan-in: all but the last dim
    assert float(wq.abs().max()) <= 2.0 * std * (1 + 2 ** -7)
    assert abs(float(wq.std()) / std - 0.88) < 0.05   # trunc-normal(±2) std
    assert torch.equal(a["layers"][1]["ln1"]["scale"],
                       torch.ones(cfg.d_model))
    assert abs(float(a["embed"].float().std()) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_params_from_numpy_unstacks_every_layer(arch):
    """The reference's stacked tree as one dict per layer in global order:
    deepseek's unstacked first layer (dense MLP) before its MoE layers,
    jamba's period of 8 (Mamba and attention, dense and MoE MLPs) over its
    repeats, seamless's encoder and decoder stacks. Every port leaf is its
    reference leaf (as float32), and the layers' kinds follow the
    reference's ``layer_kinds``."""
    from repro.models.lm import layer_kinds as jax_layer_kinds
    from repro_torch.models import lm

    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    tree = _to_numpy(jax_nn.init_params(jax.random.PRNGKey(0),
                                        jax_steps.model_specs(jcfg)))
    params = nn.params_from_numpy(tree, cfg)
    leaves = nn.tree_leaves(params)
    assert sum(x.numel() for x in leaves) == jax_nn.count_params(
        jax_steps.model_specs(jcfg))

    def same(port, ref):
        nn.tree_map(lambda t, a: np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(a, np.float32).astype(
                t.dtype == torch.bfloat16 and jnp.bfloat16 or np.float32)
            .astype(np.float32)), port, ref)

    if cfg.encdec:
        for name, stack in (("enc_layers", "enc_blocks"),
                            ("dec_layers", "dec_blocks")):
            assert len(params[name]) == len(jax.tree.leaves(
                tree[stack])[0])
            for r, p in enumerate(params[name]):
                same(p, jax.tree.map(lambda a: a[r], tree[stack]))
        return
    first_k, P, R = jax_stack_layout(jcfg)
    assert len(params["layers"]) == cfg.num_layers == first_k + P * R
    kinds = lm.stack_kinds(cfg)
    for i, p in enumerate(params["layers"]):
        if i < first_k:
            want = tree["first"][i]
            assert kinds[i] == jax_layer_kinds(jcfg, i, global_idx=i)
        else:
            r, j = divmod(i - first_k, P)
            want = jax.tree.map(lambda a: a[r], tree["blocks"][j])
            assert kinds[i] == jax_layer_kinds(jcfg, j, global_idx=first_k + j)
        same(p, want)
    assert ("head" in params) == (not cfg.tie_embeddings)

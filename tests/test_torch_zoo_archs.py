"""Every registered architecture's whole forward, the port against the
reference on the CPU: the ten ``ASSIGNED`` archs and the paper stack's
``siglip-text-so400m`` and ``qwen25-vl-7b``, on their smoke configs, with
the reference's parameters carried across by ``params_from_numpy`` and the
same numpy inputs (tokens; patch embeddings for a VLM; frame embeddings
for the encoder-decoder). A prefill of 24 positions, then 2 decode steps:
the last-token logits of each within 1e-4 in float32
(``dataclasses.replace`` of the dtypes; the bfloat16 cases, the configs as
registered, are in ``test_torch_zoo_archs_bf16.py``), and the summed MoE
aux losses within 1e-4 in float32.
Plus the reference's teacher-forced check on ``h2o-danube-1.8b`` (window
16) with a prefill of 20, longer than the window, so the ring rolls."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED as JAX_ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import nn as jax_nn  # noqa: E402
from repro.models import steps as jax_steps  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config, list_archs  # noqa: E402
from repro_torch.models import lm, nn, steps  # noqa: E402

ARCHS = ASSIGNED + ("siglip-text-so400m", "qwen25-vl-7b")
B, S, DECODE = 2, 24, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    return jcfg, cfg


def inputs(cfg, seed):
    """numpy prefill inputs and decode tokens, as the reference's pipeline
    shapes them (``synth_lm_batch``)."""
    rng = np.random.default_rng(seed)
    out = {}
    n_tok = S
    if cfg.encdec:
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    elif cfg.vlm is not None:
        p = cfg.vlm.num_patch_tokens
        out["patch_embeds"] = rng.standard_normal((B, p, cfg.d_model)).astype(
            np.float32)
        n_tok = S - p
    out["tokens"] = rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32)
    return out, rng.integers(0, cfg.vocab_size, (DECODE, B, 1)).astype(np.int32)


def run_both(arch, dtype, seed=0):
    """(reference logits list, port logits list, reference params tree,
    port params): the prefill's last-token logits, then each decode
    step's."""
    jcfg, cfg = configs(arch, dtype)
    jparams = jax_nn.init_params(jax.random.PRNGKey(seed),
                                 jax_steps.model_specs(jcfg))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    params = nn.params_from_numpy(tree, cfg)
    batch, toks = inputs(cfg, seed)
    max_len = S + DECODE
    enc_len = S if cfg.encdec else 0

    # eager: at the smoke sizes compiling the whole step costs more than
    # running it op by op
    jprefill = jax_steps.make_prefill_step(jcfg, batch=B, max_len=max_len,
                                           enc_len=enc_len)
    jl, jc = jprefill(jparams, {k: jnp.asarray(v, jcfg.compute_dtype)
                                if v.dtype == np.float32 else jnp.asarray(v)
                                for k, v in batch.items()})
    prefill = steps.make_prefill_step(cfg, batch=B, max_len=max_len,
                                      enc_len=enc_len)
    tl, tc = prefill(params, {k: torch.from_numpy(v).to(cfg.compute_dtype)
                              if v.dtype == np.float32
                              else torch.from_numpy(v).long()
                              for k, v in batch.items()})
    want, got = [np.asarray(jl, np.float32)], [tl.float().numpy()]
    jdecode = jax_steps.make_decode_step(jcfg)
    decode = steps.make_decode_step(cfg)
    pos = S if not cfg.encdec else batch["tokens"].shape[1]
    for t in range(DECODE):
        jl, jc = jdecode(jparams, jc, {"tokens": jnp.asarray(toks[t])},
                         jnp.asarray(pos + t, jnp.int32))
        tl, tc = decode(params, tc, {"tokens": torch.from_numpy(
            toks[t]).long()}, pos + t)
        want.append(np.asarray(jl, np.float32))
        got.append(tl.float().numpy())
    return want, got, jparams, params


def test_registry_matches_the_reference():
    assert ASSIGNED == JAX_ASSIGNED
    assert list_archs() == jax_list_archs()
    for arch in list_archs():
        for smoke in (False, True):
            c, j = get_config(arch, smoke), jax_get_config(arch, smoke)
            assert (c.name, c.family, c.num_layers, c.d_model, c.num_heads,
                    c.num_kv_heads, c.head_dim, c.d_ff, c.vocab_size,
                    c.attn_kind, c.window, c.layer_pattern, c.mlp_pattern,
                    c.first_k_dense, c.tie_embeddings, c.encdec,
                    c.num_enc_layers) == (
                j.name, j.family, j.num_layers, j.d_model, j.num_heads,
                j.num_kv_heads, j.head_dim, j.d_ff, j.vocab_size, j.attn_kind,
                j.window, j.layer_pattern, j.mlp_pattern, j.first_k_dense,
                j.tie_embeddings, j.encdec, j.num_enc_layers)
            for sub in ("moe", "mla", "ssm", "vlm", "audio"):
                a, b = getattr(c, sub), getattr(j, sub)
                assert (a is None) == (b is None)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (c.serve_cache_dtype is None) == (j.serve_cache_dtype is None)


def check_prefill_then_decode(arch, dtype, tol):
    want, got, _, _ = run_both(arch, dtype)
    for t, (w, g) in enumerate(zip(want, got)):
        assert g.shape == (B, get_config(arch, smoke=True).vocab_size)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"{arch} {dtype} step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch):
    """float32 within 1e-4 (the bfloat16 cases are in
    ``test_torch_zoo_archs_bf16.py``)."""
    check_prefill_then_decode(arch, "float32", 1e-4)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_config(a, smoke=True).moe])
def test_moe_aux_losses_match(arch):
    """The summed aux losses of a float32 forward over the same params."""
    jcfg, cfg = configs(arch, "float32")
    jparams = jax_nn.init_params(jax.random.PRNGKey(0),
                                 jax_steps.model_specs(jcfg))
    params = nn.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    _, _, jaux = jax_lm.lm_apply(jparams, jcfg, tokens=jnp.asarray(toks),
                                 positions=jnp.arange(S), mode="train")
    _, _, aux = lm.lm_apply(params, cfg, tokens=torch.from_numpy(toks),
                            positions=torch.arange(S), mode="prefill")
    for k in lm.AUX_KEYS:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_decode_matches_full_forward():
    """Teacher-forced decode reproduces the full forward's logits on
    h2o-danube's smoke config (window 16) after a prefill of 20 > 16:
    the ring rolls by 20 % 16, then 4 decode steps wrap it. bfloat16 as
    registered, the reference test's 0.15 tolerance."""
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    assert cfg.attn_kind == "swa" and cfg.window == 16
    params = nn.init_params(steps.model_specs(cfg),
                            torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (B, 24),
                         generator=torch.Generator().manual_seed(3))
    full, _, _ = lm.lm_apply(params, cfg, tokens=toks,
                             positions=torch.arange(24), mode="prefill")
    prefill = steps.make_prefill_step(cfg, batch=B, max_len=40)
    last, cache = prefill(params, {"tokens": toks[:, :20]})
    assert cache[0]["k"].shape[1] == 16
    torch.testing.assert_close(last.float(), full[:, 19].float(), atol=0.15,
                               rtol=0.15)
    decode = steps.make_decode_step(cfg)
    for t in range(20, 24):
        lg, cache = decode(params, cache, {"tokens": toks[:, t:t + 1]}, t)
        torch.testing.assert_close(lg.float(), full[:, t].float(), atol=0.15,
                                   rtol=0.15, msg=f"decode step {t}")

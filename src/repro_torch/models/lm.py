"""Decoder-only LM family covering dense / MoE / SSM / hybrid /
VLM-backbone, as ``repro/models/lm.py``.

A stack is ``first_k_dense`` leading layers (DeepSeek pattern) plus
repeats of a ``P``-layer period (Jamba pattern: P = 8, 1 attention + 7
Mamba). The reference stacks the params of each period position over the
repeats and ``lax.scan``s them; here every layer is one dict of
``params["layers"]`` in global order (``stack_kinds`` gives each layer's
mixer and MLP kinds), run by a Python loop, and the caches are one dict
per layer: ``{"k", "v"}`` (attention), ``{"ckv", "krope"}`` (MLA) or
``{"conv", "state"}`` (Mamba). Prefill fills those caches in place and
decode writes one slot (or state) of each in place.

Modes: ``train`` (logits, or the final hidden states and the head for the
chunked loss, with the MoE aux losses; no cache), ``prefill`` (logits +
filled caches) and ``decode`` (one token against the caches). VLM
backbones take precomputed patch embeddings (the modality frontend is a
stub, as in the reference). A tied head is the embedding's transpose over
sqrt(d_model), as there.

Training rematerialises as the reference's ``cfg.remat`` says
(``repro/models/lm.py:280-304``): each repeat of the period (the
reference's scan body) under ``torch.utils.checkpoint`` ("full": only its
input is kept; "dots": the outputs of its un-batched matrix products are
kept too, the reference's ``dots_with_no_batch_dims_saveable``; "none":
everything), and with ``remat_group`` g > 1 the two-level grouping: every
g repeats are one more checkpoint, so only one activation a group is kept
and a group's repeats are recomputed in its backward. The leading
``first_k_dense`` layers are not rematerialised, as there. Remat runs
each layer's forward again in the backward, flash kernel launch included.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import nn
from repro_torch.models.layers import (
    attention_apply,
    attention_specs,
    make_attn_cache_specs,
    make_mla_cache_specs,
    mla_apply,
    mla_specs,
    mlp_apply,
    mlp_specs,
    moe_apply,
    moe_specs,
    rmsnorm,
    rmsnorm_specs,
)
from repro_torch.models.ssm import make_ssm_cache_specs, mamba_apply, mamba_specs

f32 = torch.float32

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def layer_kinds(cfg, j: int, global_idx: int | None = None) -> tuple[str, str]:
    """(mixer_kind, mlp_kind) for period position j."""
    mixer = cfg.layer_pattern[j % len(cfg.layer_pattern)]
    mlp = cfg.mlp_pattern[j % len(cfg.mlp_pattern)]
    if global_idx is not None and global_idx < cfg.first_k_dense:
        mlp = "dense"
    if mixer == "attn" and cfg.mla is not None:
        mixer = "mla"
    return mixer, mlp


def stack_layout(cfg) -> tuple[int, int, int]:
    """(first_k, period, repeats)."""
    P = len(cfg.layer_pattern)
    first_k = cfg.first_k_dense
    n = cfg.num_layers - first_k
    assert n % P == 0, (cfg.name, cfg.num_layers, first_k, P)
    return first_k, P, n // P


def stack_kinds(cfg) -> list[tuple[str, str]]:
    """Every layer's (mixer_kind, mlp_kind), in global order: the leading
    layers, then the period's positions repeat by repeat (the order of the
    reference's scan)."""
    first_k, P, R = stack_layout(cfg)
    return ([layer_kinds(cfg, j, global_idx=j) for j in range(first_k)]
            + [layer_kinds(cfg, j, global_idx=first_k + j)
               for _ in range(R) for j in range(P)])


def _mixer_specs(cfg, kind: str) -> dict:
    if kind == "mla":
        return mla_specs(cfg)
    if kind == "mamba":
        return mamba_specs(cfg)
    return attention_specs(cfg)


def _mlp_specs(cfg, kind: str) -> dict | None:
    if kind == "moe":
        return moe_specs(cfg)
    if kind == "none":
        return None
    return mlp_specs(cfg)


def block_specs(cfg, mixer_kind: str, mlp_kind: str) -> dict:
    s = {"ln1": rmsnorm_specs(cfg.d_model),
         "mixer": _mixer_specs(cfg, mixer_kind)}
    mlp = _mlp_specs(cfg, mlp_kind)
    if mlp is not None:
        s["ln2"] = rmsnorm_specs(cfg.d_model)
        s["mlp"] = mlp
    return s


def block_cache_specs(cfg, mixer_kind: str, batch: int, max_len: int) -> dict:
    if mixer_kind == "mamba":
        return make_ssm_cache_specs(cfg, batch)
    if mixer_kind == "mla":
        return make_mla_cache_specs(cfg, batch, max_len)
    return make_attn_cache_specs(cfg, batch, max_len)


def zero_aux(device=None) -> dict:
    return {k: torch.zeros((), dtype=f32, device=device) for k in AUX_KEYS}


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of un-batched matrix products, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, policy: str):
    """``fn`` under ``torch.utils.checkpoint`` by the config's remat policy
    ("full", "dots" or "none")."""
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def block_apply(
    p: dict,
    x: torch.Tensor,
    *,
    cfg,
    mixer_kind: str,
    mlp_kind: str,
    positions: torch.Tensor,
    cache: dict | None,
    cache_index: int | None,
    mode: str,
) -> tuple[torch.Tensor, dict | None, dict]:
    """One layer: (x, its cache, the MoE aux losses (zeros elsewhere))."""
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    apply = {"attn": attention_apply, "mla": mla_apply,
             "mamba": mamba_apply}[mixer_kind]
    mix, cache = apply(p["mixer"], h, cfg=cfg, positions=positions,
                       cache=cache, cache_index=cache_index, mode=mode)
    x = x + mix
    aux = zero_aux(x.device)
    if mlp_kind == "moe":
        y, moe_aux = moe_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps),
                               cfg=cfg)
        aux.update(moe_aux)
        x = x + y
    elif mlp_kind == "dense":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps))
    return x, cache, aux


# ---------------------------------------------------------------------------
# Full stack
# ---------------------------------------------------------------------------


def lm_specs(cfg) -> dict:
    specs = {
        "embed": nn.embedding((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), cfg.param_dtype),
        "final_norm": rmsnorm_specs(cfg.d_model),
        "layers": [block_specs(cfg, *kinds) for kinds in stack_kinds(cfg)],
    }
    if not cfg.tie_embeddings:
        specs["head"] = nn.dense((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), cfg.param_dtype)
    return specs


def lm_cache_specs(cfg, batch: int, max_len: int) -> list:
    return [block_cache_specs(cfg, mixer, batch, max_len)
            for mixer, _ in stack_kinds(cfg)]


def lm_apply(
    params: dict,
    cfg,
    *,
    tokens: torch.Tensor | None = None,        # (B, S) int
    input_embeds: torch.Tensor | None = None,  # (B, P, d) prepended (VLM stub)
    positions: torch.Tensor,                   # (S_total,) absolute positions
    mode: str = "prefill",
    cache: list | None = None,
    cache_index: int | None = None,
    logits_slice_last: bool = False,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, list | None, dict]:
    """Returns (logits, cache, aux); ``cache`` is the list handed in,
    updated, and ``aux`` the MoE losses summed over the layers. With
    ``return_hidden``, ((final hidden states, head), cache, aux): the
    chunked loss's inputs (``steps.chunked_softmax_xent``)."""
    parts = []
    if input_embeds is not None:
        parts.append(input_embeds.to(cfg.compute_dtype))
    if tokens is not None:
        parts.append(params["embed"][tokens].to(cfg.compute_dtype))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    x = nn.logical_constraint(x, ("batch", "seq", None))

    kinds = stack_kinds(cfg)
    sp = cfg.seq_sharding and mode == "train"

    def layers(idx):
        """The layers ``idx`` in order: x -> (x, their summed aux)."""
        def run(x):
            aux_tot = zero_aux(x.device)
            for li in idx:
                x, _, aux = block_apply(
                    params["layers"][li], x, cfg=cfg, mixer_kind=kinds[li][0],
                    mlp_kind=kinds[li][1], positions=positions,
                    cache=None if cache is None else cache[li],
                    cache_index=cache_index, mode=mode)
                aux_tot = {k: aux_tot[k] + aux[k] for k in AUX_KEYS}
            return x, aux_tot
        return run

    def repeat(idx):
        """One repeat of the period; with sequence sharding its carried
        residual is placed seq-sharded over "model" (Megatron-SP)."""
        run = layers(idx)
        if not sp:
            return run

        def body(x):
            x, aux = run(x)
            return nn.logical_constraint(x, ("batch", "seq_sp", None)), aux
        return body

    if mode == "train":
        first_k, P, R = stack_layout(cfg)
        units = [layers([li]) for li in range(first_k)]
        repeats = [remat(repeat(range(first_k + r * P, first_k + (r + 1) * P)),
                         cfg.remat) for r in range(R)]
        g = cfg.remat_group
        if g > 1 and R % g == 0:
            def group(reps):
                def run(x):
                    aux_tot = zero_aux(x.device)
                    for rep in reps:
                        x, aux = rep(x)
                        aux_tot = {k: aux_tot[k] + aux[k] for k in AUX_KEYS}
                    return x, aux_tot
                return remat(run, "none" if cfg.remat == "none" else "full")
            repeats = [group(repeats[i:i + g]) for i in range(0, R, g)]
        units += repeats
    else:
        units = [layers(range(len(kinds)))]
    aux_tot = zero_aux(x.device)
    for unit in units:
        x, aux = unit(x)
        aux_tot = {k: aux_tot[k] + aux[k] for k in AUX_KEYS}

    if logits_slice_last:
        x = x[:, -1:, :]
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    head = params.get("head")
    if head is None:   # tied: logits O(1) at init (the T5 convention)
        head = params["embed"].T / math.sqrt(cfg.d_model)
    if return_hidden:
        return (x, head), cache, aux_tot
    logits = nn.logical_constraint(x @ head.to(x.dtype),
                                   ("batch", "seq", "vocab"))
    return logits, cache, aux_tot

"""Decoder-only LM for the dense / VLM-backbone family: every layer is
causal GQA attention and a SwiGLU MLP, as in ``llava-next-8b``.

The reference (``repro/models/lm.py``) stacks the layers' params and
``lax.scan``s them; here the stack is a Python loop over
``params["layers"]``, one dict per layer, and the caches are one
``{"k", "v"}`` dict of tensors per layer. Prefill fills those caches in
place and decode writes one slot of each in place (``layers.attention_apply``).

Modes: ``prefill`` (logits + filled KV caches) and ``decode`` (one token
against the caches). VLM backbones take precomputed patch embeddings (the
modality frontend is a stub, as in the reference).
"""

from __future__ import annotations

import torch

from repro_torch.models import nn
from repro_torch.models.layers import (
    attention_apply,
    attention_specs,
    make_attn_cache_specs,
    mlp_apply,
    mlp_specs,
    rmsnorm,
    rmsnorm_specs,
)


def check_ported(cfg) -> None:
    """Raise on a config the dense stack cannot run (ROADMAP item 14)."""
    for kind, used in (("MLA", cfg.mla is not None),
                       ("encoder-decoder", cfg.encdec)):
        if used:
            raise NotImplementedError(
                f"{kind} models are not ported (ROADMAP §1 item 14, model zoo)")


def block_specs(cfg) -> dict:
    return {"ln1": rmsnorm_specs(cfg.d_model), "mixer": attention_specs(cfg),
            "ln2": rmsnorm_specs(cfg.d_model), "mlp": mlp_specs(cfg)}


def block_apply(
    p: dict,
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,
    cache: dict | None,
    cache_index: int | None,
    mode: str,
) -> tuple[torch.Tensor, dict | None]:
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    mix, cache = attention_apply(p["mixer"], h, cfg=cfg, positions=positions,
                                 cache=cache, cache_index=cache_index,
                                 mode=mode)
    x = x + mix
    h = rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + mlp_apply(p["mlp"], h), cache


# ---------------------------------------------------------------------------
# Full stack
# ---------------------------------------------------------------------------


def lm_specs(cfg) -> dict:
    check_ported(cfg)
    return {
        "embed": nn.embedding((cfg.vocab_size, cfg.d_model), cfg.param_dtype),
        "final_norm": rmsnorm_specs(cfg.d_model),
        "layers": [block_specs(cfg) for _ in range(cfg.num_layers)],
        "head": nn.dense((cfg.d_model, cfg.vocab_size), cfg.param_dtype),
    }


def lm_cache_specs(cfg, batch: int, max_len: int) -> list:
    check_ported(cfg)
    return [make_attn_cache_specs(cfg, batch, max_len)
            for _ in range(cfg.num_layers)]


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
) -> tuple[torch.Tensor, list | None]:
    """Returns (logits, cache); ``cache`` is the list handed in, updated."""
    check_ported(cfg)
    parts = []
    if input_embeds is not None:
        parts.append(input_embeds.to(cfg.compute_dtype))
    if tokens is not None:
        parts.append(params["embed"][tokens].to(cfg.compute_dtype))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    for li, p in enumerate(params["layers"]):
        x, _ = block_apply(
            p, x, cfg=cfg, positions=positions,
            cache=None if cache is None else cache[li],
            cache_index=cache_index, mode=mode)

    if logits_slice_last:
        x = x[:, -1:, :]
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return x @ params["head"].to(x.dtype), cache

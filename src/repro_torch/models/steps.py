"""Step factories for the forward passes the KV-batch path runs: prefill and
decode (``repro/models/steps.py``). Forward only; no train step, and an
encoder-decoder config raises (``lm.check_ported``, ROADMAP item 14)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import nn
from repro_torch.models.lm import lm_apply, lm_cache_specs, lm_specs


def model_specs(cfg) -> dict:
    return lm_specs(cfg)


def cache_specs(cfg, batch: int, max_len: int) -> list:
    return lm_cache_specs(cfg, batch, max_len)


def _forward(params, cfg, batch: dict, *, mode, cache=None, cache_index=None,
             logits_slice_last=False):
    tokens = batch.get("tokens")
    embeds = batch.get("patch_embeds")
    dev = params["embed"].device
    if mode == "decode":
        positions = torch.arange(cache_index, cache_index + 1, device=dev)
    else:
        seq = (0 if tokens is None else tokens.shape[1]) + (
            0 if embeds is None else embeds.shape[1])
        positions = torch.arange(seq, device=dev)
    return lm_apply(params, cfg, tokens=tokens, input_embeds=embeds,
                    positions=positions, mode=mode, cache=cache,
                    cache_index=cache_index,
                    logits_slice_last=logits_slice_last)


def make_prefill_step(cfg, *, batch: int, max_len: int) -> Callable:
    """prefill(params, inputs) -> (last_token_logits (B, V), cache)."""

    def prefill_step(params, inputs):
        dev = params["embed"].device
        cache = nn.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
            cache_specs(cfg, batch, max_len))
        logits, cache = _forward(params, cfg, inputs, mode="prefill",
                                 cache=cache, logits_slice_last=True)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg) -> Callable:
    """decode(params, cache, inputs, cache_index) -> (logits (B, V), cache).

    Writes slot ``cache_index`` of every layer's cache in place and returns
    the same cache list."""

    def decode_step(params, cache, inputs, cache_index: int):
        logits, cache = _forward(params, cfg, inputs, mode="decode",
                                 cache=cache, cache_index=int(cache_index))
        return logits[:, -1], cache

    return decode_step

"""Step factories for the forward passes: prefill and decode for every
family (``repro/models/steps.py``), with the reference's input stubs: a
VLM takes precomputed ``patch_embeds`` (B, P, d) before its tokens, an
encoder-decoder precomputed ``frames`` (B, S_enc, d). Forward only: the
training step is not ported."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import nn
from repro_torch.models.encdec import (encdec_apply, encdec_cache_specs,
                                       encdec_specs)
from repro_torch.models.lm import lm_apply, lm_cache_specs, lm_specs


def model_specs(cfg) -> dict:
    return encdec_specs(cfg) if cfg.encdec else lm_specs(cfg)


def cache_specs(cfg, batch: int, max_len: int, enc_len: int = 0) -> list:
    if cfg.encdec:
        return encdec_cache_specs(cfg, batch, max_len, enc_len or max_len)
    return lm_cache_specs(cfg, batch, max_len)


def _device(params) -> torch.device:
    return (params["dec_embed"] if "dec_embed" in params
            else params["embed"]).device


def _forward(params, cfg, batch: dict, *, mode, cache=None, cache_index=None,
             logits_slice_last=False):
    dev = _device(params)
    positions = None
    if mode == "decode":
        positions = torch.arange(cache_index, cache_index + 1, device=dev)
    if cfg.encdec:
        return encdec_apply(params, cfg, frames=batch.get("frames"),
                            tokens=batch.get("tokens"), mode=mode,
                            cache=cache, cache_index=cache_index,
                            positions=positions)
    tokens = batch.get("tokens")
    embeds = batch.get("patch_embeds")
    if mode != "decode":
        seq = (0 if tokens is None else tokens.shape[1]) + (
            0 if embeds is None else embeds.shape[1])
        positions = torch.arange(seq, device=dev)
    return lm_apply(params, cfg, tokens=tokens, input_embeds=embeds,
                    positions=positions, mode=mode, cache=cache,
                    cache_index=cache_index,
                    logits_slice_last=logits_slice_last)


def make_prefill_step(cfg, *, batch: int, max_len: int,
                      enc_len: int = 0) -> Callable:
    """prefill(params, inputs) -> (last_token_logits (B, V), cache)."""

    def prefill_step(params, inputs):
        dev = _device(params)
        cache = nn.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
            cache_specs(cfg, batch, max_len, enc_len))
        logits, cache, _ = _forward(params, cfg, inputs, mode="prefill",
                                    cache=cache, logits_slice_last=True)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg) -> Callable:
    """decode(params, cache, inputs, cache_index) -> (logits (B, V), cache).

    Writes slot ``cache_index`` of every layer's cache (its ring slot, its
    SSM state) in place and returns the same cache list."""

    def decode_step(params, cache, inputs, cache_index: int):
        logits, cache, _ = _forward(params, cfg, inputs, mode="decode",
                                    cache=cache, cache_index=int(cache_index))
        return logits[:, -1], cache

    return decode_step


def stub_inputs(cfg, batch: int, seq: int, gen: torch.Generator) -> dict:
    """A prefill's inputs for any family, drawn on ``gen``'s device, with
    the reference's modality stubs (``repro/data/pipeline.py``
    ``synth_lm_batch``): an encoder-decoder takes ``seq`` frame embeddings
    and ``dec_len_ratio`` x ``seq`` tokens, a VLM ``num_patch_tokens``
    patch embeddings and ``seq - num_patch_tokens`` tokens (the projector's
    output; no vision tower), any other model ``seq`` tokens."""
    dev, dt, d = gen.device, cfg.compute_dtype, cfg.d_model

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                             device=dev)

    def embeds(n):
        return torch.randn((batch, n, d), generator=gen, device=dev).to(dt)

    if cfg.encdec:
        ratio = cfg.audio.dec_len_ratio if cfg.audio else 1.0
        return {"frames": embeds(seq), "tokens": tokens(max(1, int(seq * ratio)))}
    if cfg.vlm is not None:
        p = cfg.vlm.num_patch_tokens
        return {"patch_embeds": embeds(p), "tokens": tokens(seq - p)}
    return {"tokens": tokens(seq)}

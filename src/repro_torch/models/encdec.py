"""Encoder-decoder family (the seamless-m4t-large-v2 backbone), as
``repro/models/encdec.py``.

The speech frontend is a STUB: the encoder takes precomputed frame
embeddings (B, S_enc, d) and runs bidirectional self-attention (the flash
kernel without the causal mask). The decoder is causal self-attention
(with a KV cache) and cross-attention whose K and V are computed once from
the encoder output and cached for decode, where the one new token attends
to every cached encoder position through the decode kernel (no
``kv_valid``). Params are one dict per layer (``enc_layers``,
``dec_layers``); the reference stacks them and scans. Training (``mode=
"train"``, no caches) rematerialises every encoder and decoder layer by
``cfg.remat`` (``lm.remat``), as the reference checkpoints its scan
bodies.
"""

from __future__ import annotations

import torch

from repro_torch.models import nn
from repro_torch.models.layers import (
    apply_rope,
    attention_apply,
    attention_specs,
    make_attn_cache_specs,
    mlp_apply,
    mlp_specs,
    out_project,
    project,
    rmsnorm,
    rmsnorm_specs,
    sdpa,
)
from repro_torch.models.lm import remat, zero_aux


def cross_attn_specs(cfg) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    dt = cfg.param_dtype
    return {
        "wq": nn.dense((d, H, Dh), (emb, "heads", "head_dim"), dt),
        "wk": nn.dense((d, Hkv, Dh), (emb, "kv_heads", "head_dim"), dt),
        "wv": nn.dense((d, Hkv, Dh), (emb, "kv_heads", "head_dim"), dt),
        "wo": nn.dense((H, Dh, d), ("heads", "head_dim", emb), dt),
    }


def cross_attn_apply(p: dict, x: torch.Tensor, *, enc_out: torch.Tensor | None,
                     cache: dict | None) -> tuple[torch.Tensor, dict | None]:
    """Prefill (``enc_out`` given) computes the encoder's K and V and, with
    a cache, writes them into it; decode (``enc_out`` None) reads them
    back."""
    q = project(x, p["wq"])
    if cache is not None and enc_out is None:    # decode: the cached K/V
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    else:
        k, v = project(enc_out, p["wk"]), project(enc_out, p["wv"])
        if cache is not None:  # prefill fills the cross cache
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    out = sdpa(q, k, v, causal=False)
    return out_project(out, p["wo"]), cache


def enc_block_specs(cfg) -> dict:
    return {"ln1": rmsnorm_specs(cfg.d_model), "attn": attention_specs(cfg),
            "ln2": rmsnorm_specs(cfg.d_model), "mlp": mlp_specs(cfg)}


def dec_block_specs(cfg) -> dict:
    return {"ln1": rmsnorm_specs(cfg.d_model),
            "self_attn": attention_specs(cfg),
            "lnx": rmsnorm_specs(cfg.d_model),
            "cross_attn": cross_attn_specs(cfg),
            "ln2": rmsnorm_specs(cfg.d_model), "mlp": mlp_specs(cfg)}


def encdec_specs(cfg) -> dict:
    n_enc = cfg.num_enc_layers or cfg.num_layers
    return {
        "enc_layers": [enc_block_specs(cfg) for _ in range(n_enc)],
        "enc_norm": rmsnorm_specs(cfg.d_model),
        "dec_embed": nn.embedding((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), cfg.param_dtype),
        "dec_layers": [dec_block_specs(cfg) for _ in range(cfg.num_layers)],
        "final_norm": rmsnorm_specs(cfg.d_model),
        "head": nn.dense((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                         cfg.param_dtype),
    }


def encdec_cache_specs(cfg, batch: int, max_len: int, enc_len: int) -> list:
    """Per decoder layer: its self-attention cache and the cross cache of
    the encoder's K and V (enc_len positions, the compute dtype)."""
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", None, "kv_heads", "head_dim")
    return [{"self": make_attn_cache_specs(cfg, batch, max_len),
             "cross": {"k": nn.zeros(shape, axes, cfg.compute_dtype),
                       "v": nn.zeros(shape, axes, cfg.compute_dtype)}}
            for _ in range(cfg.num_layers)]


def encoder_apply(params, cfg, frames: torch.Tensor,
                  mode: str = "prefill") -> torch.Tensor:
    x = nn.logical_constraint(frames.to(cfg.compute_dtype),
                              ("batch", "seq", None))
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(p):
        def run(x):
            h = rmsnorm(p["ln1"], x, cfg.rms_eps)
            a = p["attn"]
            q = apply_rope(project(h, a["wq"]), positions, cfg.rope_theta)
            k = apply_rope(project(h, a["wk"]), positions, cfg.rope_theta)
            v = project(h, a["wv"])
            x = x + out_project(sdpa(q, k, v, causal=False), a["wo"])
            return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps))
        return remat(run, cfg.remat) if mode == "train" else run

    for p in params["enc_layers"]:
        x = layer(p)(x)
    return rmsnorm(params["enc_norm"], x, cfg.rms_eps)


def decoder_apply(params, cfg, tokens: torch.Tensor, *,
                  enc_out: torch.Tensor | None, mode: str = "prefill",
                  cache: list | None = None, cache_index: int | None = None,
                  positions: torch.Tensor | None = None,
                  logits_slice_last: bool = False,
                  return_hidden: bool = False):
    """(logits, cache), or ((final hidden states, head), cache) with
    ``return_hidden`` (the chunked loss's inputs)."""
    x = params["dec_embed"][tokens].to(cfg.compute_dtype)
    x = nn.logical_constraint(x, ("batch", "seq", None))
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)

    def layer(p, c):
        def run(x, enc_out):
            h = rmsnorm(p["ln1"], x, cfg.rms_eps)
            a, _ = attention_apply(p["self_attn"], h, cfg=cfg,
                                   positions=positions,
                                   cache=None if c is None else c["self"],
                                   cache_index=cache_index, mode=mode)
            x = x + a
            h = rmsnorm(p["lnx"], x, cfg.rms_eps)
            ca, _ = cross_attn_apply(p["cross_attn"], h, enc_out=enc_out,
                                     cache=None if c is None else c["cross"])
            x = x + ca
            return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps))
        return remat(run, cfg.remat) if mode == "train" else run

    for li, p in enumerate(params["dec_layers"]):
        x = layer(p, None if cache is None else cache[li])(x, enc_out)
    if logits_slice_last:
        x = x[:, -1:, :]
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if return_hidden:
        return (x, params["head"]), cache
    logits = x @ params["head"].to(x.dtype)
    return nn.logical_constraint(logits, ("batch", "seq", "vocab")), cache


def encdec_apply(params, cfg, *, frames: torch.Tensor | None = None,
                 tokens: torch.Tensor | None = None, mode: str = "prefill",
                 cache: list | None = None, cache_index: int | None = None,
                 positions: torch.Tensor | None = None):
    """Returns (logits, cache, aux): train and prefill encode ``frames``
    and run the decoder over ``tokens`` (prefill: last-token logits);
    decode runs one token against the caches. aux is zeros (no MoE)."""
    if mode == "decode":
        logits, cache = decoder_apply(params, cfg, tokens, enc_out=None,
                                      mode=mode, cache=cache,
                                      cache_index=cache_index,
                                      positions=positions)
    else:
        enc_out = encoder_apply(params, cfg, frames, mode=mode)
        logits, cache = decoder_apply(params, cfg, tokens, enc_out=enc_out,
                                      mode=mode, cache=cache,
                                      cache_index=cache_index,
                                      positions=positions,
                                      logits_slice_last=mode == "prefill")
    return logits, cache, zero_aux(logits.device)

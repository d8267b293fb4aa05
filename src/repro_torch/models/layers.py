"""Transformer building blocks of the dense stack: RMSNorm, RoPE, causal GQA
attention and the SwiGLU MLP, at the reference's (B, S, H, D) layout.

As in ``repro/models/layers.py``:
  * ``*_specs(cfg) -> dict[str, ParamSpec]``
  * ``*_apply(params, x, ...) -> y``.

There is no ``impl`` switch: ``sdpa`` lets the tensor's device decide. A
CUDA tensor goes to the hand-written flash kernel (Sq > 1) or the decode
kernel (Sq == 1); a CPU tensor goes to the plain version,
``sdpa_reference``, which both kernels are held against. The sliding window
lives only in the flash kernel and its plain version, which the reference
kernel test drives; no ported config uses it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import nn

f32 = torch.float32
MLP_CHUNK = 16384      # tokens per MLP pass: bounds the (tokens, d_ff) transients

# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> dict:
    return {"scale": nn.ones((d,), f32)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.to(f32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Angles in
    float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].to(f32) * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Scaled dot-product attention
# ---------------------------------------------------------------------------


def _causal_mask_bias(q_pos, k_pos, window: int | None) -> torch.Tensor:
    """(Q, K) additive bias in float32. window=None -> plain causal."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, -math.inf).to(f32)


def sdpa_reference(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,            # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    kv_valid=None,              # int or (B,) number of valid kv positions
    scale: float | None = None,
) -> torch.Tensor:
    """Direct attention: the plain version of both attention kernels. The
    queries sit at positions 0 .. Sq-1 (a prefill; decode is not causal).
    A sequence whose ``kv_valid`` is 0 gets a zero output row."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    qf = (q * scale).to(f32).reshape(B, Sq, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.to(f32))
    Sk = k.shape[1]
    k_pos = torch.arange(Sk, device=q.device)
    q_pos = torch.arange(Sq, device=q.device)
    if causal:
        logits = logits + _causal_mask_bias(q_pos, k_pos, window)
    if kv_valid is not None:
        valid = torch.as_tensor(kv_valid, device=q.device).reshape(-1, 1)
        live = k_pos[None, :] < valid                         # (B|1, Sk)
        bias = torch.where(live, 0.0, -math.inf).to(f32)
        logits = logits + bias[:, None, None, None, :]        # (B|1, .., Sk)
    probs = torch.softmax(logits, dim=-1)
    if kv_valid is not None:
        # a sequence with no valid slot attends to nothing: a zero row (the
        # decode kernel's answer), not the NaN of a softmax over all -inf
        probs = torch.where(live.any(dim=1)[:, None, None, None, None],
                            probs, 0.0)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.to(f32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def sdpa(q, k, v, *, kv_valid=None):
    """Dispatch by shape; the tensor's device picks kernel or plain version
    inside the ops (``repro/models/layers.py`` ``sdpa`` with impl=pallas).
    A multi-token ``q`` is a prefill: causal, from position 0. A single
    token attends to the first ``kv_valid`` cache slots."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    if q.shape[1] > 1:
        if kv_valid is not None:
            raise ValueError("kv_valid is a decode (Sq == 1) argument")
        return fa.flash_attention(q, k, v, causal=True)
    return da.decode_attention(q, k, v, kv_valid=kv_valid)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def attention_specs(cfg) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {
        "wq": nn.dense((d, H, Dh), dt),
        "wk": nn.dense((d, Hkv, Dh), dt),
        "wv": nn.dense((d, Hkv, Dh), dt),
        "wo": nn.dense((H, Dh, d), dt),
    }


def make_attn_cache_specs(cfg, batch: int, max_len: int) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": nn.zeros(shape, cfg.compute_dtype),
            "v": nn.zeros(shape, cfg.compute_dtype)}


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).reshape(
        B, S, *w.shape[1:])


def attention_apply(
    p: dict,
    x: torch.Tensor,               # (B, S, d)
    *,
    cfg,
    positions: torch.Tensor,       # (S,) absolute positions
    cache: dict | None = None,
    cache_index: int | None = None,  # decode: #tokens already in cache
    mode: str,                     # prefill | decode
) -> tuple[torch.Tensor, dict | None]:
    """Prefill writes the layer's cache in place; decode writes one slot of
    it in place, then attends over the slots written so far. The reference
    returns new arrays instead; the port's caller keeps no other reference
    to the cache it hands in."""
    B, S, d = x.shape
    q = apply_rope(project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(project(x, p["wk"]), positions, cfg.rope_theta)
    v = project(x, p["wv"])

    if mode == "decode":
        assert cache is not None and S == 1
        Lc = cache["k"].shape[1]
        if not 0 <= cache_index < Lc:
            raise ValueError(f"decode slot {cache_index} outside a cache of {Lc}")
        # slot keep+t is written before kv_valid = keep+t+1 reads it
        cache["k"][:, cache_index] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, cache_index] = v[:, 0].to(cache["v"].dtype)
        out = sdpa(q, cache["k"], cache["v"], kv_valid=cache_index + 1)
    else:
        if cache is not None:  # prefill writes the cache
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        out = sdpa(q, k, v)
    wo = p["wo"]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]).to(x.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wi_gate": nn.dense((d, ff), dt),
        "wi_up": nn.dense((d, ff), dt),
        "wo": nn.dense((ff, d), dt),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, row-wise: taken over ``MLP_CHUNK`` tokens at a time so a
    92k-token prefill never holds its (tokens, d_ff) gate and up at once."""
    flat = x.reshape(-1, x.shape[-1])
    wg = p["wi_gate"].to(x.dtype)
    wu = p["wi_up"].to(x.dtype)
    wo = p["wo"].to(x.dtype)
    out = torch.empty_like(flat)
    for i in range(0, flat.shape[0], MLP_CHUNK):
        xc = flat[i:i + MLP_CHUNK]
        h = F.silu((xc @ wg).to(f32)).to(x.dtype) * (xc @ wu)
        out[i:i + MLP_CHUNK] = h @ wo
    return out.reshape(x.shape)

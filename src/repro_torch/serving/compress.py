"""Expected-Attention KV-cache compression (Devoto et al. 2025, as used by
the paper §3.2).

Scores each cached KV position by the attention mass *future* queries are
expected to pay it, using per-layer query statistics (mean mu, diagonal var):

    score(k) = sum_heads ||v|| * exp( mu_h.k / sqrt(D) + var_h.k^2 / (2 D) )

and keeps the top ``ceil((1 - rate) * S)`` positions per (batch, kv head).
``expected_attention_scores`` is the plain version; ``compress_cache`` goes
through ``kernels/expected_attention``, whose scores come from the CUDA
kernel for a CUDA tensor and from this plain version for a CPU one.
"""

from __future__ import annotations

import dataclasses
import math

import torch

f32 = torch.float32


def expected_attention_scores(
    k: torch.Tensor,          # (B, S, Hkv, D)
    v: torch.Tensor,          # (B, S, Hkv, D)
    q_mu: torch.Tensor,       # (Hkv, rep, D)  rope'd query mean per head
    q_var: torch.Tensor,      # (Hkv, rep, D)  diagonal query variance
) -> torch.Tensor:
    """-> (B, S, Hkv) float32 scores."""
    D = k.shape[-1]
    kf = k.to(f32)
    lin = torch.einsum("bshd,hrd->bshr", kf, q_mu.to(kf.device, f32)) / math.sqrt(D)
    quad = torch.einsum("bshd,hrd->bshr", kf * kf,
                        q_var.to(kf.device, f32)) / (2.0 * D)
    per_head = torch.exp(torch.clamp(lin + quad, -30.0, 30.0)).sum(dim=-1)
    vnorm = torch.linalg.vector_norm(v.to(f32), dim=-1)        # (B,S,Hkv)
    return per_head * vnorm


def compress_cache(
    k: torch.Tensor, v: torch.Tensor, q_mu: torch.Tensor, q_var: torch.Tensor,
    *, rate: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (k_c, v_c, kept_idx): (B, keep, Hkv, D) x2, (B, keep, Hkv)."""
    from repro_torch.kernels.expected_attention import ops as ea

    S = k.shape[1]
    keep = max(1, int(math.ceil(S * (1.0 - rate))))
    return ea.compress(k, v, q_mu, q_var, keep=keep)


@dataclasses.dataclass
class QueryStats:
    """Per-layer rope'd query statistics from a calibration pass."""

    mu: list   # [(Hkv, rep, D) float32] per layer
    var: list


def calibration_q_stats(params: dict, cfg, tokens: torch.Tensor) -> QueryStats:
    """Forward over the layers collecting the query mean/var per layer.

    Runs at calibration scale (a few short generic prompts); its attention
    goes through ``sdpa`` like the prefill's."""
    from repro_torch.models.layers import apply_rope, project, rmsnorm
    from repro_torch.models.lm import block_apply

    x = params["embed"][tokens].to(cfg.compute_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)
    Hkv = cfg.num_kv_heads
    rep = cfg.num_heads // Hkv
    mus, vars_ = [], []
    for p in params["layers"]:
        h = rmsnorm(p["ln1"], x, cfg.rms_eps)
        q = apply_rope(project(h, p["mixer"]["wq"]), positions, cfg.rope_theta)
        qr = q.reshape(B, S, Hkv, rep, q.shape[-1]).to(f32)
        mus.append(qr.mean(dim=(0, 1)))
        vars_.append(qr.var(dim=(0, 1), correction=0))
        x, _, _ = block_apply(p, x, cfg=cfg, mixer_kind="attn",
                              mlp_kind="dense", positions=positions,
                              cache=None, cache_index=None, mode="prefill")
    return QueryStats(mu=mus, var=vars_)

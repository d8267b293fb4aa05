"""Expected-Attention compression: the score kernel, then top-keep
selection, a sort back into time order and the gather.

The scores come from the CUDA kernel for a CUDA tensor and from the plain
version in ``ref`` for a CPU or meta one (no fallback; any other device
raises). Selection, sort and gather
are ``torch.topk``, ``torch.sort`` and ``torch.gather``, as the reference
does them in jnp (``repro/kernels/expected_attention/ops.py:33-39``); the
kernel reads the cache where it lies, so nothing is padded or moved.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import cost
from repro_torch.kernels.expected_attention import kernel
from repro_torch.kernels.expected_attention.ref import ea_scores_ref

f32 = torch.float32


def ea_scores(k, v, q_mu, q_var) -> torch.Tensor:
    """(B, S, Hkv) float32 scores of every cached position."""
    if k.device.type in ("cpu", "meta"):
        return cost.fused("expected_attention", ea_scores_ref, k, v, q_mu,
                          q_var)
    return kernel.ea_scores(k, v, q_mu.to(device=k.device, dtype=f32).contiguous(),
                            q_var.to(device=k.device, dtype=f32).contiguous())


def compress(k: torch.Tensor, v: torch.Tensor, q_mu: torch.Tensor,
             q_var: torch.Tensor, *, keep: int,
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the ``keep`` highest-scoring positions per (batch, kv head), in
    time order. Returns (k_c, v_c, idx): (B, keep, Hkv, D) x2 and
    (B, keep, Hkv) int64."""
    B, S, Hkv, D = k.shape
    scores = ea_scores(k, v, q_mu, q_var)                       # (B,S,Hkv)
    idx = torch.topk(scores.transpose(1, 2), min(keep, S), dim=-1).indices
    idx = torch.sort(idx, dim=-1).values.transpose(1, 2)        # (B,keep,Hkv)
    gidx = idx[..., None].expand(-1, -1, -1, D)
    return torch.gather(k, 1, gidx), torch.gather(v, 1, gidx), idx

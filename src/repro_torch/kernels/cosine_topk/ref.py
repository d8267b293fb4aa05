"""Plain-torch versions of the fused semantic-histogram probe (scalar +
batched): the CPU path of ``ops`` and the oracle the CUDA kernel is held to."""

from __future__ import annotations

import torch

f32 = torch.float32


def cosine_probe_ref(store: torch.Tensor, pred: torch.Tensor,
                     thresholds: torch.Tensor, k: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """store (N, d); pred (d,); thresholds (T,). Returns
    (counts (T,) int32, k smallest cosine distances (k,) f32 ascending)."""
    counts, top = cosine_probe_batch_ref(store, pred[None], thresholds[None], k)
    return counts[0], top[0]


def cosine_probe_batch_ref(store: torch.Tensor, preds: torch.Tensor,
                           thresholds: torch.Tensor, k: int,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """store (N, d); preds (B, d); thresholds (B, T). Returns
    (counts (B, T) int32, k smallest distances (B, k) f32 ascending)."""
    sims = preds.to(f32) @ store.to(f32).T                  # (B, N)
    dists = 1.0 - sims
    thr = thresholds.to(f32)
    counts = (dists[:, None, :] <= thr[:, :, None]).sum(
        dim=-1, dtype=torch.int32)                          # (B, T)
    top = torch.topk(dists, k, dim=1, largest=False, sorted=True).values
    return counts, top

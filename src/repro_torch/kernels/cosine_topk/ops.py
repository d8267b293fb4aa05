"""Probe entry points: clamp k, launch, sum the counts, merge the top-k.

``cosine_probe`` is the one-predicate probe and ``cosine_probe_batch`` the
batched one; on the card both go through the one CUDA kernel
(``kernel.probe_blocks``, the scalar probe as B = 1), so a predicate's
results are bitwise the same alone and inside any batch. A tensor on the CPU
goes to the plain version in ``ref``; a CUDA tensor goes to the kernel, or
the call raises — there is no fallback.

Nothing is padded: the kernel masks the ragged last slab and the ragged
predicate tile itself, so the store is never copied. The per-slab partials
are merged here, as ``repro/kernels/cosine_topk/ops.py:136-139`` merges the
Pallas blocks: counts summed, top-k re-selected with ``torch.topk``, which
keeps every k <= N exact.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cosine_topk import kernel
from repro_torch.kernels.cosine_topk.ref import (
    cosine_probe_batch_ref,
    cosine_probe_ref,
)

f32 = torch.float32


def cosine_probe(store: torch.Tensor, pred: torch.Tensor,
                 thresholds: torch.Tensor, *, k: int = 128,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused probe: (counts (T,) int32, k smallest distances (k,) ascending)."""
    k = max(1, min(k, store.shape[0]))
    if store.device.type == "cpu":
        return cosine_probe_ref(store, pred, thresholds, k)
    counts, top = cosine_probe_batch(store, pred[None], thresholds[None], k=k)
    return counts[0], top[0]


def cosine_probe_batch(store: torch.Tensor, preds: torch.Tensor,
                       thresholds: torch.Tensor, *, k: int = 128,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fused probe — one store pass per tile of 8 predicates.

    Returns (counts (B, T) int32, k smallest distances (B, k) ascending)."""
    n = store.shape[0]
    b = preds.shape[0]
    k = max(1, min(k, n))
    if store.device.type == "cpu":
        return cosine_probe_batch_ref(store, preds, thresholds, k)
    if store.device.type != "cuda":
        raise ValueError(f"no probe for a store on {store.device}")
    kk = min(k, kernel.SLAB)
    counts_b, topk_b = kernel.probe_blocks(
        store, preds.to(device=store.device, dtype=f32).contiguous(),
        thresholds.to(device=store.device, dtype=f32).contiguous(),
        kk=kk, n_valid=n)
    counts = counts_b.sum(dim=0, dtype=torch.int32)          # (B, T)
    # (nslab, B, kk) -> (B, nslab*kk) -> per-predicate global top-k
    flat = topk_b.permute(1, 0, 2).reshape(b, -1)
    merged = torch.topk(flat, k, dim=1, largest=False, sorted=True).values
    return counts, merged

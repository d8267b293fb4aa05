"""Probe entry points: clamp k, launch, sum the counts, merge the top-k.

The reference's entry points, each with its own name here:

  ``cosine_probe`` / ``cosine_probe_batch``                   full scan
  ``cosine_probe_masked`` / ``cosine_probe_batch_masked``     rows < n_valid
  ``cosine_probe_rowmask`` / ``cosine_probe_batch_rowmask``   rows mask != 0
  ``cosine_compound_count``   one conjunction / disjunction's match count

On the card all of them go through the one CUDA kernel
(``kernel.probe_blocks``; a scalar probe is B = 1, a batch of more than one
predicate tile is the reference's B-tiled variant), whose per-row distance
does not depend on B, on the buffer or on where the row sits: a predicate's
results are bitwise the same alone and inside any batch, and a masked or
gathered buffer gives each live row its full-scan distance. A tensor on the
CPU goes to the plain version in ``ref``, which is row-local too; a CUDA
tensor goes to the kernel, or the call raises — there is no fallback.

Nothing is padded: the kernel masks the ragged last slab, the dead rows and
the ragged predicate tile itself, so the store is never copied. The per-slab
partials are merged here, as ``repro/kernels/cosine_topk/ops.py:136-139``
merges the Pallas blocks: counts summed, top-k re-selected with
``torch.topk``, which keeps every k <= N exact; past the live rows the top-k
comes back +inf.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cosine_topk import kernel, ref

f32 = torch.float32


def _device(store: torch.Tensor) -> str:
    if store.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe for a store on {store.device}")
    return store.device.type


def _probe(store, preds, thresholds, k, *, n_valid, mask, entry):
    """(counts (B, T) int32, k smallest distances (B, k)) over the live rows:
    the kernel on the card, the plain version on the CPU."""
    k = max(1, min(k, store.shape[0]))
    if _device(store) == "cpu":
        if mask is not None:
            return ref.cosine_probe_batch_rowmask_ref(store, mask, preds,
                                                      thresholds, k)
        if n_valid < store.shape[0]:
            return ref.cosine_probe_batch_masked_ref(store, n_valid, preds,
                                                     thresholds, k)
        return ref.cosine_probe_batch_ref(store, preds, thresholds, k)
    b = preds.shape[0]
    if mask is not None:
        mask = mask.to(device=store.device, dtype=torch.int32).contiguous()
    counts_b, topk_b = kernel.probe_blocks(
        store, preds.to(device=store.device, dtype=f32).contiguous(),
        thresholds.to(device=store.device, dtype=f32).contiguous(),
        kk=min(k, kernel.SLAB), n_valid=n_valid, mask=mask,
        entry=kernel.entry_name(entry, b))
    counts = counts_b.sum(dim=0, dtype=torch.int32)          # (B, T)
    # (nslab, B, kk) -> (B, nslab*kk) -> per-predicate global top-k
    flat = topk_b.permute(1, 0, 2).reshape(b, -1)
    merged = torch.topk(flat, k, dim=1, largest=False, sorted=True).values
    return counts, merged


def _one(pair):
    counts, top = pair
    return counts[0], top[0]


def cosine_probe(store: torch.Tensor, pred: torch.Tensor,
                 thresholds: torch.Tensor, *, k: int = 128,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused probe: (counts (T,) int32, k smallest distances (k,) ascending)."""
    return _one(_probe(store, pred[None], thresholds[None], k,
                       n_valid=store.shape[0], mask=None,
                       entry="cosine_probe"))


def cosine_probe_batch(store: torch.Tensor, preds: torch.Tensor,
                       thresholds: torch.Tensor, *, k: int = 128,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fused probe — one store pass per tile of 8 predicates.

    Returns (counts (B, T) int32, k smallest distances (B, k) ascending)."""
    return _probe(store, preds, thresholds, k, n_valid=store.shape[0],
                  mask=None, entry="cosine_probe_batch")


def cosine_probe_masked(store: torch.Tensor, n_valid: int,
                        pred: torch.Tensor, thresholds: torch.Tensor, *,
                        k: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Scalar probe over the first ``n_valid`` rows of ``store``."""
    return _one(_probe(store, pred[None], thresholds[None], k,
                       n_valid=int(n_valid), mask=None,
                       entry="cosine_probe_masked"))


def cosine_probe_batch_masked(store: torch.Tensor, n_valid: int,
                              preds: torch.Tensor, thresholds: torch.Tensor,
                              *, k: int = 128,
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched probe over the first ``n_valid`` rows of ``store``: the
    cluster-pruned index's scan of its gathered boundary rows."""
    return _probe(store, preds, thresholds, k, n_valid=int(n_valid),
                  mask=None, entry="cosine_probe_batch_masked")


def cosine_probe_rowmask(store: torch.Tensor, mask: torch.Tensor,
                         pred: torch.Tensor, thresholds: torch.Tensor, *,
                         k: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Scalar probe over the live (``mask`` != 0) rows of ``store``."""
    return _one(_probe(store, pred[None], thresholds[None], k,
                       n_valid=store.shape[0], mask=mask,
                       entry="cosine_probe_rowmask"))


def cosine_probe_batch_rowmask(store: torch.Tensor, mask: torch.Tensor,
                               preds: torch.Tensor, thresholds: torch.Tensor,
                               *, k: int = 128,
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched probe over the live (``mask`` != 0) rows of ``store``: the
    mutable store's hot tail, whose live rows are not a prefix."""
    return _probe(store, preds, thresholds, k, n_valid=store.shape[0],
                  mask=mask, entry="cosine_probe_batch_rowmask")


def cosine_compound_count(store: torch.Tensor, preds: torch.Tensor,
                          thresholds: torch.Tensor, *, mode: str,
                          n_valid: int | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Match count (0-d int32) of one compound predicate over the live rows
    (below ``n_valid``, ``mask`` != 0): rows within every (``mode="and"``)
    or any (``"or"``) conjunct's threshold. preds (B, d) are its B conjuncts,
    thresholds (B,); on the card B <= 8, one predicate tile."""
    if mode not in kernel.MODES:
        raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
    n = store.shape[0]
    nv = n if n_valid is None else int(n_valid)
    if _device(store) == "cpu":
        return ref.cosine_compound_count_ref(store, preds, thresholds,
                                             mode=mode, n_valid=nv, mask=mask)
    if mask is not None:
        mask = mask.to(device=store.device, dtype=torch.int32).contiguous()
    counts, _ = kernel.probe_blocks(
        store, preds.to(device=store.device, dtype=f32).contiguous(),
        thresholds.to(device=store.device, dtype=f32).reshape(-1, 1)
        .contiguous(), kk=1, n_valid=nv, mask=mask, mode=mode,
        entry="cosine_compound")
    return counts.sum(dtype=torch.int32)

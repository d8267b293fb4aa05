"""Probe entry points: clamp k, then the kernel on the card or the plain
version on the CPU.

The reference's entry points, each with its own name here:

  ``cosine_probe`` / ``cosine_probe_batch``                   full scan
  ``cosine_probe_masked`` / ``cosine_probe_batch_masked``     rows < n_valid
  ``cosine_probe_rowmask`` / ``cosine_probe_batch_rowmask``   rows mask != 0
  ``cosine_compound_count``   one conjunction / disjunction's match count

On the card all of them go through the one CUDA kernel (``kernel.probe``;
a scalar probe is B = 1, a batch past the reference's block_b of 128 is
its B-tiled variant). A batch of more than 8 reads each live store row
once, whatever B. The kernel's per-row distance does not depend on B, on
the buffer, on the block size or on where the row sits: a predicate's
results are bitwise the same alone and inside any batch, and a masked or
gathered buffer gives each live row its full-scan distance. A tensor on
the CPU goes to the plain version in ``ref``, which is row-local too; a
CUDA tensor goes to the kernel, or the call raises — there is no
fallback.

Nothing is padded: the kernel masks the ragged last block, the dead rows
and the ragged predicate tile itself, so the store is never copied. The
per-block partials are merged on the card by the kernel's own merge launch
(``repro/kernels/cosine_topk/ops.py:136-139`` merges the Pallas blocks with
a sum and a top-k): counts summed, the top-k selected exactly, so every
k <= N is exact; past the live rows the top-k comes back +inf.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cosine_topk import kernel, ref

f32 = torch.float32


def _device(store: torch.Tensor) -> str:
    if store.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe for a store on {store.device}")
    return store.device.type


def _on(t: torch.Tensor, device, dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype`` on ``device`` (itself if it
    is one already)."""
    if t.device == device and t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(device=device, dtype=dtype).contiguous()


def _probe(store, preds, thresholds, k, *, n_valid, mask, entry,
           one=False):
    """(counts (B, T) int32, k smallest distances (B, k)) over the live rows:
    the kernel on the card, the plain version on the CPU. ``one``: a single
    predicate, preds (d,) and thresholds (T,), answered as (T,) and (k,)."""
    k = max(1, min(k, store.shape[0]))
    if _device(store) == "cpu":
        if one:
            preds, thresholds = preds[None], thresholds[None]
        if mask is not None:
            res = ref.cosine_probe_batch_rowmask_ref(store, mask, preds,
                                                     thresholds, k)
        elif n_valid < store.shape[0]:
            res = ref.cosine_probe_batch_masked_ref(store, n_valid, preds,
                                                    thresholds, k)
        else:
            res = ref.cosine_probe_batch_ref(store, preds, thresholds, k)
        return (res[0][0], res[1][0]) if one else res
    dev = store.device
    return kernel.probe(
        store, _on(preds, dev, f32), _on(thresholds, dev, f32), k=k,
        n_valid=n_valid, mask=None if mask is None else
        _on(mask, dev, torch.int32), one=one,
        entry=entry if one else kernel.entry_name(entry, preds.shape[0]))


def cosine_probe(store: torch.Tensor, pred: torch.Tensor,
                 thresholds: torch.Tensor, *, k: int = 128,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused probe: (counts (T,) int32, k smallest distances (k,) ascending)."""
    return _probe(store, pred, thresholds, k, n_valid=store.shape[0],
                  mask=None, entry="cosine_probe", one=True)


def cosine_probe_batch(store: torch.Tensor, preds: torch.Tensor,
                       thresholds: torch.Tensor, *, k: int = 128,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fused probe — one pass over the store for any B.

    Returns (counts (B, T) int32, k smallest distances (B, k) ascending)."""
    return _probe(store, preds, thresholds, k, n_valid=store.shape[0],
                  mask=None, entry="cosine_probe_batch")


def cosine_probe_masked(store: torch.Tensor, n_valid: int,
                        pred: torch.Tensor, thresholds: torch.Tensor, *,
                        k: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Scalar probe over the first ``n_valid`` rows of ``store``."""
    return _probe(store, pred, thresholds, k, n_valid=int(n_valid),
                  mask=None, entry="cosine_probe_masked", one=True)


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
    return _probe(store, pred, thresholds, k, n_valid=store.shape[0],
                  mask=mask, entry="cosine_probe_rowmask", one=True)


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
    thresholds (B,), any B: on the card one launch walks every conjunct
    over each block's rows, so each row is decided with its full-scan
    distance and the count is the AND/OR of full scans."""
    if mode not in kernel.MODES:
        raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
    n = store.shape[0]
    nv = n if n_valid is None else int(n_valid)
    if _device(store) == "cpu":
        return ref.cosine_compound_count_ref(store, preds, thresholds,
                                             mode=mode, n_valid=nv, mask=mask)
    dev = store.device
    count, _ = kernel.probe(
        store, _on(preds, dev, f32), _on(thresholds, dev, f32).reshape(-1, 1),
        k=1, n_valid=nv, mask=None if mask is None else
        _on(mask, dev, torch.int32), mode=mode, entry="cosine_compound")
    return count

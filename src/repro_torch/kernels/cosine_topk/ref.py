"""Plain-torch versions of the fused semantic-histogram probe: the CPU path
of ``ops`` and the oracle the CUDA kernel is held to.

Every version scores rows with ``cosine_distances``, which is row-local: a
row's distance ``1 - <row, pred>`` is an elementwise product summed over d,
so it depends only on the row and the predicate — not on N, on where the row
sits, on B or on which rows are scored beside it. A matrix product would not
be: its rounding follows the shape of the whole product. That is what keeps
a pruned, gathered, masked or mutable scan bitwise equal to the full scan on
the CPU, as the kernel's fixed-order reduction does on the card.
"""

from __future__ import annotations

import torch

f32 = torch.float32
# the largest (B, rows, d) product held at once: on the CPU one that stays
# in cache (a product that spills to memory makes the scan many times
# slower), on the card few enough launches per scan
CHUNK_BYTES = {"cpu": 4 << 20, "cuda": 256 << 20}


def cosine_distances(store: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """store (N, d); preds (B, d). Returns (B, N) f32 distances, row-local."""
    store, preds = store.to(f32), preds.to(f32)
    n, d = store.shape
    b = preds.shape[0]
    rows = max(1, CHUNK_BYTES.get(store.device.type, 256 << 20)
               // (4 * max(1, b * d)))
    out = torch.empty((b, n), dtype=f32, device=store.device)
    for i in range(0, n, rows):
        chunk = store[i:i + rows]
        out[:, i:i + rows] = 1.0 - (chunk[None] * preds[:, None]).sum(-1)
    return out


def _counts_topk(dists: torch.Tensor, thresholds: torch.Tensor, k: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    thr = thresholds.to(device=dists.device, dtype=f32)
    counts = (dists[:, None, :] <= thr[:, :, None]).sum(
        dim=-1, dtype=torch.int32)                          # (B, T)
    top = torch.topk(dists, k, dim=1, largest=False, sorted=True).values
    return counts, top


def _dead(dists: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    return torch.where(live[None, :], dists,
                       torch.full((), torch.inf, device=dists.device))


def cosine_probe_batch_ref(store: torch.Tensor, preds: torch.Tensor,
                           thresholds: torch.Tensor, k: int,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """store (N, d); preds (B, d); thresholds (B, T). Returns
    (counts (B, T) int32, k smallest distances (B, k) f32 ascending)."""
    return _counts_topk(cosine_distances(store, preds), thresholds, k)


def _live_rows(store: torch.Tensor, n_valid: int | None,
               mask: torch.Tensor | None) -> torch.Tensor:
    live = torch.arange(store.shape[0], device=store.device) < (
        store.shape[0] if n_valid is None else int(n_valid))
    if mask is not None:
        live &= mask.to(store.device) != 0
    return live


def cosine_probe_batch_masked_ref(store: torch.Tensor, n_valid: int,
                                  preds: torch.Tensor,
                                  thresholds: torch.Tensor, k: int,
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The masked prefix probe: rows >= n_valid are +inf."""
    dists = _dead(cosine_distances(store, preds),
                  _live_rows(store, n_valid, None))
    return _counts_topk(dists, thresholds, k)


def cosine_probe_batch_rowmask_ref(store: torch.Tensor, mask: torch.Tensor,
                                   preds: torch.Tensor,
                                   thresholds: torch.Tensor, k: int,
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-row-mask probe: rows with mask == 0 are +inf (tombstones and
    dead hot-tail slots; live rows are not a prefix)."""
    dists = _dead(cosine_distances(store, preds),
                  _live_rows(store, None, mask))
    return _counts_topk(dists, thresholds, k)


def cosine_compound_count_ref(store: torch.Tensor, preds: torch.Tensor,
                              thresholds: torch.Tensor, *, mode: str,
                              n_valid: int | None = None,
                              mask: torch.Tensor | None = None,
                              ) -> torch.Tensor:
    """Rows among the live ones (below ``n_valid``, ``mask`` != 0) whose
    distance to every (``mode="and"``) or any (``"or"``) of the B conjuncts
    is <= that conjunct's threshold; thresholds (B,). A 0-d int32 count."""
    thr = thresholds.to(device=store.device, dtype=f32).reshape(-1)
    match = cosine_distances(store, preds) <= thr[:, None]      # (B, N)
    hit = match.all(dim=0) if mode == "and" else match.any(dim=0)
    return (hit & _live_rows(store, n_valid, mask)).sum(dtype=torch.int32)

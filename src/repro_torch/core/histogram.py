"""The Semantic Histogram: an embedding store + threshold-probe (paper §2).

No buckets — the paper keeps *all* embeddings (§2.1); the store is one
(N, d) float32 tensor on the device. The probe primitives are:

  * ``count_within(pred, thr)``        -> selectivity (§2.2 step 5)
  * ``kth_smallest_distance(pred, k)`` -> threshold calibration (§3.2)
  * ``probe_batch / selectivity_batch / kth_smallest_batch`` — the same two
    primitives for B predicates in **one** pass over the store.

Every probe is one fused pass (``kernels/cosine_topk``): on the card the
CUDA kernel, whose per-row distance does not depend on B or on where the
row sits, so a scalar probe and the same predicate inside a batch agree
bitwise; a store on the CPU goes through the kernel's plain version.

Serving: ``probe_batch`` is cache-aware — construct with ``cache=`` (any
object with a ``key``/``get``/``put`` surface; duck-typed) and repeated
predicates skip the store scan: hits are filled from the cache, only the
miss subset is probed, and the exact outputs are cached so a later hit is
bitwise the fresh probe.

Not ported yet (``NotImplementedError``): the sharded probe (``mesh=``,
ROADMAP §1 item 11), the cluster-pruned and mutable indexes (``index=``,
items 8 and 9) and the compound probe that needs them (``count_compound``,
item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.cosine_topk import ops as ct

f32 = torch.float32


@dataclasses.dataclass
class SemanticHistogram:
    embeddings: torch.Tensor     # (N, d) unit vectors, on the probe device
    cache: object | None = None  # PredicateCache-like (duck-typed)
    mesh: object | None = None   # sharded probes: not ported yet
    index: object | None = None  # pruned / mutable index: not ported yet

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded probes (mesh=) are ROADMAP §1 item 11 of the port")
        if self.index is not None:
            raise NotImplementedError(
                "the cluster-pruned and mutable indexes (index=) are ROADMAP "
                "§1 items 8 and 9 of the port")
        if not isinstance(self.embeddings, torch.Tensor):
            raise TypeError("embeddings must be a torch.Tensor on the probe "
                            "device")
        self._n_static = self.embeddings.shape[0]

    @property
    def n(self) -> int:
        """Row count the probe results are over (selectivity denominator
        and k clamp)."""
        return self._n_static

    @property
    def version(self) -> int:
        """Monotonic mutation counter, folded into predicate-cache keys;
        0 for this immutable store."""
        return 0

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -------------------- core fused probe --------------------

    def _probe(self, pred: torch.Tensor, thresholds: torch.Tensor, *, k: int):
        return ct.cosine_probe(self.embeddings, pred, thresholds, k=k)

    def _probe_batched(self, preds: torch.Tensor, thresholds: torch.Tensor,
                       *, k: int):
        return ct.cosine_probe_batch(self.embeddings, preds, thresholds, k=k)

    # -------------------- public API (scalar) --------------------

    def count_within(self, pred: np.ndarray, threshold: float) -> int:
        # the threshold is cast to f32 before comparing, as the reference
        counts, _ = self._probe(self._tensor(pred), self._tensor([threshold]),
                                k=1)
        return int(counts[0])

    def selectivity(self, pred: np.ndarray, threshold: float) -> float:
        return self.count_within(pred, threshold) / self.n

    def count_compound(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       mode: str = "and") -> int:
        raise NotImplementedError(
            "the compound probe is ROADMAP §1 item 8 of the port")

    def kth_smallest_distance(self, pred: np.ndarray, k: int) -> float:
        k = max(1, min(k, self.n))
        _, smallest = self._probe(self._tensor(pred), self._tensor([0.0]),
                                  k=int(k))
        return float(smallest[k - 1])

    # -------------------- public API (batched) --------------------

    def probe_batch(self, preds: np.ndarray, thresholds: np.ndarray, *,
                    k: int = 1, use_cache: bool = True,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused pass for B predicates. preds (B, d); thresholds (B,)
        or (B, T). Returns (counts (B, T) int32, top-k distances (B, k)),
        on the store's device.

        With a ``cache`` attached (and ``use_cache``), each predicate is
        looked up by its (embedding, thresholds, k) key first; only the
        misses are probed, and their exact outputs are cached."""
        thr = np.asarray(thresholds, np.float32)
        if thr.ndim == 1:
            thr = thr[:, None]
        k = max(1, min(int(k), self.n))
        if self.cache is None or not use_cache:
            return self._probe_batched(self._tensor(preds), self._tensor(thr),
                                       k=k)
        return self._probe_batched_cached(np.asarray(preds, np.float32), thr,
                                          k=k)

    def _probe_batched_cached(self, preds: np.ndarray, thr: np.ndarray, *,
                              k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Fill hits from the cache, probe only the misses, cache the rest.

        The miss subset is padded (repeating its last row) to a power-of-two
        bucket <= B, as the reference does to bound its compiled shapes."""
        b, t = thr.shape
        ver = self.version
        keys = [self.cache.key(preds[j], thr[j], k, version=ver)
                for j in range(b)]
        hits = [self.cache.get(key) for key in keys]
        miss = [j for j, h in enumerate(hits) if h is None]
        counts = np.empty((b, t), np.int32)
        topk = np.empty((b, k), np.float32)
        for j, h in enumerate(hits):
            if h is not None:
                counts[j], topk[j] = h
        if miss:
            bucket = min(b, 1 << (len(miss) - 1).bit_length())
            rows = miss + [miss[-1]] * (bucket - len(miss))
            mc, mt = self._probe_batched(self._tensor(preds[rows]),
                                         self._tensor(thr[rows]), k=k)
            mc, mt = mc.cpu().numpy(), mt.cpu().numpy()
            for i, j in enumerate(miss):
                counts[j], topk[j] = mc[i], mt[i]
                self.cache.put(keys[j], (mc[i].copy(), mt[i].copy()))
        return (torch.from_numpy(counts).to(self.device),
                torch.from_numpy(topk).to(self.device))

    def selectivity_batch(self, preds: np.ndarray,
                          thresholds: np.ndarray) -> np.ndarray:
        """Selectivity of B (predicate, threshold) pairs via one store pass —
        one device round-trip for the whole batch."""
        counts, _ = self.probe_batch(preds, thresholds, k=1)
        return counts[:, 0].cpu().numpy() / self.n

    def selectivity_bounds(self, preds: np.ndarray, thresholds: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Certified selectivity interval per predicate — zero rows read.

        Without a cluster index the only certified interval is [0, 1]."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32).reshape(-1)
        if preds.ndim != 2 or preds.shape[0] != thr.shape[0]:
            raise ValueError(f"preds {preds.shape} vs thresholds "
                             f"{thr.shape}")
        b = preds.shape[0]
        return np.zeros(b, np.float64), np.ones(b, np.float64)

    def kth_smallest_batch(self, preds: np.ndarray, k: int) -> np.ndarray:
        """k-th smallest distance per predicate, (B,) float — batched
        threshold calibration."""
        k = max(1, min(int(k), self.n))
        b = np.asarray(preds).shape[0]
        _, smallest = self.probe_batch(preds, np.zeros((b,), np.float32), k=k)
        return smallest[:, k - 1].cpu().numpy()

    def distances(self, pred: np.ndarray) -> np.ndarray:
        """Full distance vector — test/debug only (not the serving path)."""
        sims = self.embeddings.to(f32) @ self._tensor(pred)
        return (1.0 - sims).cpu().numpy()

"""The Semantic Histogram: an embedding store + threshold-probe (paper §2).

No buckets — the paper keeps *all* embeddings (§2.1); the store is one
(N, d) float32 tensor on the device. The probe primitives are:

  * ``count_within(pred, thr)``        -> selectivity (§2.2 step 5)
  * ``kth_smallest_distance(pred, k)`` -> threshold calibration (§3.2)
  * ``probe_batch / selectivity_batch / kth_smallest_batch`` — the same two
    primitives for B predicates in **one** pass over the store.

Every probe is one fused pass (``kernels/cosine_topk``): on the card the
CUDA kernel, on the CPU its plain version. Both give a row a distance that
depends only on the row and the predicate — not on B or on where the row
sits — so a scalar probe and the same predicate inside a batch agree
bitwise, and so do a pruned, masked or mutable scan and the full scan.

Indexes: construct with ``index=`` a ``repro_torch.index.ClusteredStore``
built from the same embeddings and every count/top-k probe goes through the
pruned path (clusters whose exact distance bounds put them entirely inside
or outside the threshold are counted or skipped without reading a row;
only boundary clusters are scanned); ``kth_smallest_distance`` scans
clusters in bound order and stops early. With a
``repro_torch.index.MutableClusteredStore`` the histogram routes to its
``probe`` and follows its live row count (``n``) and ``version``.

Serving: ``probe_batch`` is cache-aware — construct with ``cache=`` (any
object with a ``key``/``get``/``put`` surface; duck-typed) and repeated
predicates skip the store scan: hits are filled from the cache, only the
miss subset is probed, and the exact outputs are cached, so a later hit is
bitwise the fresh probe.

Not ported yet (``NotImplementedError``): the sharded probe (``mesh=``,
ROADMAP M4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.cosine_topk import ops as ct
from repro_torch.kernels.cosine_topk.ref import cosine_distances


@dataclasses.dataclass
class SemanticHistogram:
    embeddings: torch.Tensor     # (N, d) unit vectors, on the probe device
    cache: object | None = None  # PredicateCache-like (duck-typed)
    mesh: object | None = None   # sharded probes: not ported yet
    index: object | None = None  # ClusteredStore or MutableClusteredStore

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded probes (mesh=) are ROADMAP M4 of the port")
        if not isinstance(self.embeddings, torch.Tensor):
            raise TypeError("embeddings must be a torch.Tensor on the probe "
                            "device")
        self._n_static = self.embeddings.shape[0]
        self._mutable = getattr(self.index, "is_mutable", False)
        if self._mutable:
            # the mutable store owns its rows; check only the wiring
            if self.index.d != self.embeddings.shape[1]:
                raise ValueError(
                    f"index dim {self.index.d} != store dim "
                    f"{self.embeddings.shape[1]}")
        elif self.index is not None:
            if self.index.n != self.n:
                raise ValueError(
                    f"index holds {self.index.n} rows, store has {self.n} — "
                    f"build the ClusteredStore from the same embeddings")
            # a stale index over same-shaped but other embeddings would
            # silently break exactness
            for i in ([0, self.n // 2, self.n - 1] if self.n else []):
                if not torch.equal(
                        self.index.embeddings[i].cpu(),
                        self.embeddings[int(self.index.perm[i])].cpu()):
                    raise ValueError(
                        "index embeddings disagree with the store — build "
                        "the ClusteredStore from the same embeddings")

    @property
    def n(self) -> int:
        """Row count the probe results are over (selectivity denominator
        and k clamp): the live count for a mutable index."""
        if self._mutable:
            return self.index.n_live
        return self._n_static

    @property
    def version(self) -> int:
        """Monotonic mutation counter, folded into predicate-cache keys;
        0 for an immutable store."""
        if self._mutable:
            return self.index.version
        return 0

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -------------------- core fused probe --------------------

    def _probe(self, pred: np.ndarray, thresholds: np.ndarray, *, k: int,
               need_topk: bool = True):
        """One predicate: (counts (T,), top-k (k,)) on the store's device."""
        if self.index is None:
            return ct.cosine_probe(self.embeddings, self._tensor(pred),
                                   self._tensor(thresholds), k=k)
        counts, topk = self._probe_batched(
            np.asarray(pred, np.float32)[None],
            np.asarray(thresholds, np.float32)[None], k=k,
            need_topk=need_topk)
        return counts[0], topk[0]

    def _probe_batched(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       k: int, need_topk: bool = True):
        """(counts (B, T) int32, top-k (B, k)) on the store's device; with an
        index, ``need_topk=False`` lets a fully resolved probe skip the
        launch (the top-k is then unspecified)."""
        if self._mutable:
            counts, topk = self.index.probe(preds, thresholds, k=k,
                                            need_topk=need_topk)
        elif self.index is not None:
            counts, topk, _ = self.index.probe_pruned(
                preds, thresholds, k=k, need_topk=need_topk)
        else:
            return ct.cosine_probe_batch(self.embeddings, self._tensor(preds),
                                         self._tensor(thresholds), k=k)
        return (torch.from_numpy(counts).to(self.device),
                torch.from_numpy(topk).to(self.device))

    # -------------------- public API (scalar) --------------------

    def count_within(self, pred: np.ndarray, threshold: float) -> int:
        # the threshold is cast to f32 before comparing, as the reference
        counts, _ = self._probe(pred, np.asarray([threshold], np.float32),
                                k=1, need_topk=False)
        return int(counts[0])

    def selectivity(self, pred: np.ndarray, threshold: float) -> float:
        return self.count_within(pred, threshold) / self.n

    def count_compound(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       mode: str = "and") -> int:
        """Exact match count of a conjunction ("and") / disjunction ("or")
        of per-predicate threshold filters, in one pass: preds (B, d) are
        the B conjuncts of ONE compound predicate, thresholds (B,) theirs.
        With an index the joint cluster bounds resolve most clusters and
        one compound launch scores the rest; every row is decided with its
        full-scan distance, so the count is the AND/OR of full scans."""
        if mode not in ("and", "or"):
            raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
        preds_np = np.asarray(preds, np.float32)
        thr_np = np.asarray(thresholds, np.float32).reshape(-1)
        if self.index is not None:
            count, _ = self.index.probe_compound(preds_np, thr_np, mode=mode)
            return int(count)
        return int(ct.cosine_compound_count(
            self.embeddings, self._tensor(preds_np), self._tensor(thr_np),
            mode=mode))

    def selectivity_compound(self, preds: np.ndarray,
                             thresholds: np.ndarray, *,
                             mode: str = "and") -> float:
        """Compound selectivity: ``count_compound / n`` over live rows."""
        return self.count_compound(preds, thresholds, mode=mode) \
            / max(self.n, 1)

    def kth_smallest_distance(self, pred: np.ndarray, k: int) -> float:
        k = max(1, min(k, self.n))
        if self.index is not None:
            # bound-ordered cluster scan, early-terminated (the mutable
            # store: its base's pruned probe plus the tail)
            return self.index.kth_smallest(pred, int(k))
        _, smallest = self._probe(pred, np.zeros((1,), np.float32), k=int(k))
        return float(smallest[k - 1])

    # -------------------- public API (batched) --------------------

    def probe_batch(self, preds: np.ndarray, thresholds: np.ndarray, *,
                    k: int = 1, use_cache: bool = True,
                    need_topk: bool = True,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused pass for B predicates. preds (B, d); thresholds (B,)
        or (B, T). Returns (counts (B, T) int32, top-k distances (B, k)),
        on the store's device.

        With a ``cache`` attached (and ``use_cache``), each predicate is
        looked up by its (embedding, thresholds, k) key first; only the
        misses are probed, and their exact outputs are cached.
        ``need_topk=False`` (count-only callers) lets an index skip its
        top-k cover; the top-k is then unspecified. The cached path ignores
        it: a cached value must stay exact for every later caller."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32)
        if thr.ndim == 1:
            thr = thr[:, None]
        k = max(1, min(int(k), self.n))
        if self.cache is None or not use_cache:
            return self._probe_batched(preds, thr, k=k, need_topk=need_topk)
        return self._probe_batched_cached(preds, thr, k=k)

    def _probe_batched_cached(self, preds: np.ndarray, thr: np.ndarray, *,
                              k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Fill hits from the cache, probe exactly the misses, cache them.

        The reference pads the misses to a power-of-two bucket to bound its
        jitted shapes; the kernel compiles nothing per shape, and a row's
        bits do not depend on B, so nothing is padded here."""
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
            mc, mt = self._probe_batched(preds[miss], thr[miss], k=k)
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
        counts, _ = self.probe_batch(preds, thresholds, k=1, need_topk=False)
        return counts[:, 0].cpu().numpy() / self.n

    def selectivity_bounds(self, preds: np.ndarray, thresholds: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Certified selectivity interval per predicate — zero rows read:
        (lo, hi), each (B,) float64, from the index's exact count bounds;
        without an index the only certified interval is [0, 1]."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32).reshape(-1)
        if preds.ndim != 2 or preds.shape[0] != thr.shape[0]:
            raise ValueError(f"preds {preds.shape} vs thresholds "
                             f"{thr.shape}")
        if self.index is not None:
            lo, hi = self.index.count_bounds(preds, thr)
            return lo[:, 0] / self.n, hi[:, 0] / self.n
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
        """Full distance vector — test/debug only (not the serving path);
        for a mutable index, the distances of the live rows."""
        if self._mutable:
            return self.index.distances(pred)
        return cosine_distances(self.embeddings,
                                self._tensor(pred)[None])[0].cpu().numpy()

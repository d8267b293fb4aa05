"""Cluster-pruned probe index: sublinear *exact* selectivity (paper §2 + §3.2).

A semantic filter is a range query on the embedding sphere — cosine distance
to the predicate under a threshold — so an IVF-style centroid partition
gives *exact* per-cluster count bounds and lets a probe skip most of a
low-selectivity store:

  partition   k-means (``repro_torch.kernels.kmeans``) splits the store into
              K clusters; the store is reordered cluster-contiguous on the
              device, with ``offsets`` (K+1,), the centroids and per-cluster
              radii ``r_c = max ||x - mu_c||`` (float64, computed on the
              device in row chunks).

  bounds      for predicate p the kernel's distance is 1 - p.x, and by
              Cauchy-Schwarz on x - mu_c every row of cluster c has
              dist(p, x) in [d_c - ||p|| r_c, d_c + ||p|| r_c], d_c = 1 - p.mu_c.

  classify    against threshold tau each cluster is all-in (ub <= tau - eps:
              count its size, scan nothing), all-out (lb > tau + eps: skip)
              or boundary (scan). eps (default 1e-4) absorbs the gap between
              this float64 host arithmetic and the kernel's f32 distances.

  scan        the boundary rows of the whole batch are gathered with one
              ``index_select`` of exactly those m rows and scored by ONE
              masked probe launch with n_valid = m; when every cluster is
              selected the store itself is scanned, with no copy.

Every probe is exactly the full scan's answer, bitwise: the probe's
distance of a row depends only on the row and the predicate (the kernel's
fixed-order reduction on the card, the row-local plain version on the CPU),
so a gathered subset gives each row its full-scan distance. The top-k stays
exact too: ``probe_pruned`` also scans every cluster whose lower bound could
reach the k-th smallest distance, and ``kth_smallest`` scans clusters in
ascending-lower-bound order and stops as soon as the k-th candidate is below
every unscanned cluster — the paper's threshold calibration (§3.2) without
the full pass.

``stats()`` accumulates rows scanned against the rows a full scan would
have read; with a telemetry hub attached (``obs``, a
``repro_torch.obs.ObsHub``, duck-typed: the index never imports it) every
probe also reports through ``obs.index_scan``.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cosine_topk import ops as ct
from repro_torch.kernels.kmeans.ops import kmeans

f32 = torch.float32
f64 = torch.float64
DIST_CHUNK = 32768     # rows per float64 chunk of the radius pass

__all__ = ["ClusteredStore", "ScanPlan", "build_clustered_store",
           "store_from_fragments"]


def store_tensor(embeddings, device=None) -> torch.Tensor:
    """(N, d) contiguous float32 on the device: a tensor stays where it is
    unless ``device`` says otherwise; an array goes to ``device`` (the card
    by default)."""
    if isinstance(embeddings, torch.Tensor) and device is None:
        dev = embeddings.device
    else:
        dev = resolve_device(device)
    return torch.as_tensor(embeddings, dtype=f32).to(dev).contiguous()


def center_dists(xs: torch.Tensor, cent64: np.ndarray,
                 cluster_of: np.ndarray) -> torch.Tensor:
    """(N,) float64 distance of every row of ``xs`` to its cluster's
    centroid, on the device, ``DIST_CHUNK`` rows at a time (a float64 copy
    of a whole 2^20 x 1152 store would take 9.7 GB)."""
    dev = xs.device
    cent = torch.as_tensor(np.asarray(cent64, np.float64), device=dev)
    cl = torch.as_tensor(np.asarray(cluster_of, np.int64), device=dev)
    out = torch.empty((xs.shape[0],), dtype=f64, device=dev)
    for i in range(0, xs.shape[0], DIST_CHUNK):
        diff = xs[i:i + DIST_CHUNK].to(f64) - cent[cl[i:i + DIST_CHUNK]]
        out[i:i + DIST_CHUNK] = torch.sqrt((diff * diff).sum(dim=1))
    return out


def _max_row_norm(xs: torch.Tensor) -> float:
    best = 0.0
    for i in range(0, xs.shape[0], DIST_CHUNK):
        c = xs[i:i + DIST_CHUNK].to(f64)
        best = max(best, float(torch.sqrt((c * c).sum(dim=1)).max()))
    return best


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Host-side classification of one (batched) probe against the clusters:
    the clusters the kernel must scan (``scan_ids`` — boundary clusters,
    plus the top-k cover when the caller needs top-k), the rows they hold
    (``m``), and the counts resolved by bounds alone (``extra`` — all-in
    sizes of clusters outside the scan union)."""

    scan_ids: np.ndarray        # cluster ids the kernel must scan (union)
    m: int                      # rows those clusters hold
    extra: np.ndarray           # (B, T) int64 — bound-resolved counts
    boundary_clusters: int      # boundary classifications across the batch


@dataclasses.dataclass
class ClusteredStore:
    """K-cluster partition of an embedding store with exact probe pruning.

    Attach to a ``SemanticHistogram(index=...)`` to route its probes through
    the pruned path, or call ``probe_pruned`` / ``kth_smallest`` directly.
    ``embeddings`` is the *reordered* (cluster-contiguous) store on the
    probe device; ``perm`` maps reordered row -> original row id. Counts and
    top-k distances do not depend on the row order, so results are
    interchangeable with a full scan of the original store.
    """

    embeddings: torch.Tensor   # (N, d) f32, cluster-contiguous, on device
    offsets: np.ndarray        # (K+1,) int64 segment boundaries
    sizes: np.ndarray          # (K,) int64 cluster sizes
    centroids: np.ndarray      # (K, d) float64
    radii: np.ndarray          # (K,) float64, max ||x - mu_c|| per cluster
    perm: np.ndarray           # (N,) original row ids in cluster order
    eps: float = 1e-4          # bound slack covering f32-vs-f64 roundoff
    chunk_rows: int = 4096     # kth_smallest: min rows per incremental scan
    max_row_norm: float = 1.0  # max ||x|| over the store (global dist floor)

    def __post_init__(self):
        self.n = int(self.embeddings.shape[0])
        self.k_clusters = int(self.sizes.shape[0])
        self._lock = threading.Lock()
        self._cum = {"probes": 0, "launches": 0, "rows_scanned": 0,
                     "rows_full_equiv": 0}
        # telemetry hub, attached by the serve layer
        self.obs = None

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------- bounds

    def cluster_bounds(self, preds: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Exact per-cluster distance bounds (lb, ub), each (B, K) float64;
        lb is floored at 1 - ||p|| max||x||, which holds for every row."""
        p64 = np.asarray(preds, np.float64)
        d_mu = 1.0 - p64 @ self.centroids.T                 # (B, K)
        pnorm = np.linalg.norm(p64, axis=1, keepdims=True)
        rad = pnorm * self.radii[None, :]
        return np.maximum(d_mu - rad, 1.0 - pnorm * self.max_row_norm), \
            d_mu + rad

    def live_cluster_sizes(self, live: np.ndarray) -> np.ndarray:
        """(K,) int64 live-row count per cluster for a (N,) bool mask over
        the stored (cluster-contiguous) row order."""
        cl = np.repeat(np.arange(self.k_clusters), self.sizes)
        return np.bincount(cl[np.asarray(live, bool)],
                           minlength=self.k_clusters).astype(np.int64)

    def count_bounds(self, preds: np.ndarray, thresholds: np.ndarray, *,
                     live_sizes: np.ndarray | None = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Exact count interval per (predicate, threshold), zero rows read:
        (lo, hi), each (B, T) int64, lo the all-in sizes, hi every cluster
        that is not all-out. ``live_sizes`` (K,) stands for the built sizes
        under tombstones: live rows stay members of their build-time
        cluster, so the bounds still hold."""
        preds = np.asarray(preds, np.float32)       # match the probe path
        thr64 = np.asarray(thresholds, np.float64)
        if thr64.ndim == 1:
            thr64 = thr64[:, None]
        lb, ub = self.cluster_bounds(preds)                      # (B, K)
        allin = ub[:, :, None] <= thr64[:, None, :] - self.eps   # (B, K, T)
        allout = lb[:, :, None] > thr64[:, None, :] + self.eps
        sz = self.sizes if live_sizes is None else \
            np.asarray(live_sizes, np.int64)
        sizes = sz[None, :, None]
        lo = (allin.astype(np.int64) * sizes).sum(axis=1)
        hi = ((~allout).astype(np.int64) * sizes).sum(axis=1)
        return lo, hi

    def _topk_cover(self, lb: np.ndarray, ub: np.ndarray, k: int,
                    sizes: np.ndarray | None = None) -> np.ndarray:
        """(B, K) mask of clusters that could hold a top-k distance: every
        cluster whose lb <= tau_k + eps, tau_k the k-th smallest of the
        size-weighted upper bounds (an upper bound on the k-th distance)."""
        if sizes is None:
            sizes = self.sizes
        nonempty = sizes > 0
        ne_ids = np.flatnonzero(nonempty)
        cover = np.zeros(lb.shape, bool)
        if not len(ne_ids):
            return cover
        for b in range(lb.shape[0]):
            order = ne_ids[np.argsort(ub[b, ne_ids], kind="stable")]
            csum = np.cumsum(sizes[order])
            pos = min(int(np.searchsorted(csum, k)), len(order) - 1)
            tau_k = ub[b, order[pos]]
            cover[b] = nonempty & (lb[b] <= tau_k + self.eps)
        return cover

    # ------------------------------------------------------------ planning

    def plan_scan(self, preds: np.ndarray, thr: np.ndarray, *, k: int = 1,
                  need_topk: bool = True,
                  live_sizes: np.ndarray | None = None) -> ScanPlan:
        """Classify every cluster for a batched probe; preds (B, d), thr
        (B, T). The scan union is the boundary clusters across the batch
        (plus the top-k cover when ``need_topk``); a union of >= 90% of the
        live rows is promoted to the whole store, so the gather degenerates
        to the contiguous store. ``live_sizes`` as in ``count_bounds``."""
        sizes = self.sizes if live_sizes is None else \
            np.asarray(live_sizes, np.int64)
        n_live = int(sizes.sum())
        lb, ub = self.cluster_bounds(preds)                  # (B, K) f64
        thr64 = np.asarray(thr, np.float64)
        allin = ub[:, :, None] <= thr64[:, None, :] - self.eps   # (B, K, T)
        allout = lb[:, :, None] > thr64[:, None, :] + self.eps
        nonempty = sizes > 0
        boundary = (~(allin | allout)).any(axis=2) & nonempty[None, :]
        scan_bk = boundary.copy()                            # (B, K)
        if need_topk:
            scan_bk |= self._topk_cover(
                lb, ub, max(1, min(int(k), max(n_live, 1))), sizes)
        in_union = scan_bk.any(axis=0) & nonempty            # (K,)
        scan_ids = np.flatnonzero(in_union)
        if int(sizes[scan_ids].sum()) >= 0.9 * n_live:
            in_union = nonempty.copy()
            scan_ids = np.flatnonzero(in_union)
        # the scan scores every predicate on every union row, so only the
        # clusters outside the union add their all-in sizes
        resolved = nonempty[None, :] & ~in_union[None, :]    # (B, K)
        extra = ((allin & resolved[:, :, None]).astype(np.int64)
                 * sizes[None, :, None]).sum(axis=1)         # (B, T)
        return ScanPlan(scan_ids=scan_ids,
                        m=int(sizes[scan_ids].sum()), extra=extra,
                        boundary_clusters=int(boundary.sum()))

    def scan_rows(self, cluster_ids: np.ndarray,
                  live: np.ndarray | None = None) -> np.ndarray:
        """Stored row indices of the given clusters' segments, in cluster
        order; ``live`` (N,) bool drops tombstoned rows."""
        if not len(cluster_ids):
            return np.empty(0, np.int64)
        rows = np.concatenate(
            [np.arange(self.offsets[c], self.offsets[c + 1])
             for c in cluster_ids])
        if live is not None:
            rows = rows[np.asarray(live, bool)[rows]]
        return rows

    # -------------------------------------------------------------- scans

    def _gather(self, cluster_ids: np.ndarray,
                live: np.ndarray | None = None) -> tuple[torch.Tensor, int]:
        """(buffer (m, d), m): exactly the rows of the given clusters (live
        ones only under tombstones), gathered on the device. When every row
        is selected the store itself is the answer — no copy."""
        if live is None and int(self.sizes[cluster_ids].sum()) == self.n:
            return self.embeddings, self.n
        rows = self.scan_rows(cluster_ids, live)
        idx = torch.as_tensor(rows, device=self.device)
        return self.embeddings.index_select(0, idx), len(rows)

    @staticmethod
    def _masked_probe(buf, m, preds, thr, *, k):
        """The masked probe over the first m rows: the scalar entry point
        for one predicate, the batched one (B-tiled past 8) otherwise. The
        kernel gives a row the same distance in both."""
        if preds.shape[0] == 1:
            counts, topk = ct.cosine_probe_masked(buf, m, preds[0], thr[0],
                                                  k=k)
            return counts[None], topk[None]
        return ct.cosine_probe_batch_masked(buf, m, preds, thr, k=k)

    # -------------------------------------------------------------- probe

    def probe_pruned(self, preds: np.ndarray, thresholds: np.ndarray, *,
                     k: int = 1, need_topk: bool = True,
                     live: np.ndarray | None = None,
                     live_sizes: np.ndarray | None = None,
                     ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Pruned batched probe, bitwise the full scan's counts and top-k.

        preds (B, d); thresholds (B,) or (B, T). All-in clusters add their
        size with zero rows read, all-out add nothing, and the union of the
        boundary (+ top-k cover) segments across the batch is scored by at
        most ONE masked launch. Returns (counts (B, T) int32, top-k (B, k)
        float32, per-call stats). ``need_topk=False`` (count-only callers)
        skips the top-k cover; the top-k is then unspecified (+inf where
        nothing was scanned). ``live``/``live_sizes``: the mutable store's
        tombstones — dead rows are never gathered and all-in clusters add
        their live counts, so results equal a fresh scan of the live rows.
        """
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32)
        if thr.ndim == 1:
            thr = thr[:, None]
        b, t = thr.shape
        if live is not None and live_sizes is None:
            live_sizes = self.live_cluster_sizes(live)
        n_eff = self.n if live_sizes is None \
            else int(np.asarray(live_sizes).sum())
        k = max(1, min(int(k), max(n_eff, 1)))
        plan = self.plan_scan(preds, thr, k=k, need_topk=need_topk,
                              live_sizes=live_sizes)

        topk = np.full((b, k), np.inf, np.float32)
        m = 0
        counts_s = np.zeros((b, t), np.int64)
        if len(plan.scan_ids) and plan.m:
            buf, m = self._gather(plan.scan_ids, live)
            c, tp = self._masked_probe(buf, m, self._tensor(preds),
                                       self._tensor(thr), k=k)
            counts_s = c.cpu().numpy().astype(np.int64)
            tp = tp.cpu().numpy()
            topk[:, :tp.shape[1]] = tp       # k > m only when not need_topk
        counts = (counts_s + plan.extra).astype(np.int32)

        stats = {
            "launches": 1 if m else 0,
            "rows_scanned": m,
            "rows_full_equiv": n_eff,
            "scan_fraction": m / max(1, n_eff),
            "scanned_clusters": int(len(plan.scan_ids)),
            "boundary_clusters": plan.boundary_clusters,
            "clusters": self.k_clusters,
            "batch": b,
        }
        self._record(stats, probes=1)
        return counts, topk, stats

    # ----------------------------------------------------------- compound

    @staticmethod
    def _compound_classes(allin_pk: np.ndarray, allout_pk: np.ndarray,
                          mode: str) -> tuple[np.ndarray, np.ndarray]:
        """Joint (K,) all-in / all-out masks from per-conjunct (B, K) ones:
        AND is all-out once any conjunct is and all-in only when every one
        is; OR is the De Morgan dual. So a conjunction prunes harder than
        its conjuncts probed one by one."""
        if mode == "and":
            return allin_pk.all(axis=0), allout_pk.any(axis=0)
        return allin_pk.any(axis=0), allout_pk.all(axis=0)

    def plan_compound(self, preds: np.ndarray, thr: np.ndarray, *,
                      mode: str = "and",
                      live_sizes: np.ndarray | None = None) -> ScanPlan:
        """Classify every cluster against a whole conjunction/disjunction:
        preds (B, d) are the B conjuncts of ONE compound predicate, thr (B,)
        their thresholds; the per-conjunct classes are combined before any
        scan. ``extra`` is (1, 1): the bound-resolved matches."""
        if mode not in ("and", "or"):
            raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
        sizes = self.sizes if live_sizes is None else \
            np.asarray(live_sizes, np.int64)
        n_live = int(sizes.sum())
        lb, ub = self.cluster_bounds(preds)                  # (B, K) f64
        thr64 = np.asarray(thr, np.float64).reshape(-1, 1)   # (B, 1)
        allin, allout = self._compound_classes(
            ub <= thr64 - self.eps, lb > thr64 + self.eps, mode)
        nonempty = sizes > 0
        boundary = ~(allin | allout) & nonempty              # (K,)
        in_union = boundary.copy()
        scan_ids = np.flatnonzero(in_union)
        if int(sizes[scan_ids].sum()) >= 0.9 * n_live:
            in_union = nonempty.copy()
            scan_ids = np.flatnonzero(in_union)
        resolved = nonempty & ~in_union
        extra = np.array([[int(sizes[allin & resolved].sum())]], np.int64)
        return ScanPlan(scan_ids=scan_ids,
                        m=int(sizes[scan_ids].sum()), extra=extra,
                        boundary_clusters=int(boundary.sum()))

    def compound_count_bounds(self, preds: np.ndarray,
                              thresholds: np.ndarray, *, mode: str = "and",
                              live_sizes: np.ndarray | None = None,
                              ) -> tuple[int, int]:
        """Certified (lo, hi) on the compound match count, zero rows read."""
        if mode not in ("and", "or"):
            raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
        preds = np.asarray(preds, np.float32)
        lb, ub = self.cluster_bounds(preds)
        thr64 = np.asarray(thresholds, np.float64).reshape(-1, 1)
        allin, allout = self._compound_classes(
            ub <= thr64 - self.eps, lb > thr64 + self.eps, mode)
        sizes = self.sizes if live_sizes is None else \
            np.asarray(live_sizes, np.int64)
        return int(sizes[allin].sum()), int(sizes[~allout & (sizes > 0)].sum())

    def probe_compound(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       mode: str = "and", live: np.ndarray | None = None,
                       live_sizes: np.ndarray | None = None,
                       ) -> tuple[int, dict]:
        """Exact compound match count in ONE compound launch over the joint
        boundary union: each surviving row is decided with its full-scan
        distance for every conjunct, so the count is bitwise the AND/OR of
        full scans. Returns (count, stats) with ``probe_pruned``'s keys."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32).reshape(-1)
        if preds.ndim != 2 or preds.shape[0] != thr.shape[0]:
            raise ValueError(
                f"preds {preds.shape} and thresholds {thr.shape} must agree "
                f"on the number of conjuncts")
        if live is not None and live_sizes is None:
            live_sizes = self.live_cluster_sizes(live)
        n_eff = self.n if live_sizes is None \
            else int(np.asarray(live_sizes).sum())
        plan = self.plan_compound(preds, thr, mode=mode,
                                  live_sizes=live_sizes)
        m, scanned = 0, 0
        if len(plan.scan_ids) and plan.m:
            buf, m = self._gather(plan.scan_ids, live)
            scanned = int(ct.cosine_compound_count(
                buf, self._tensor(preds), self._tensor(thr), mode=mode,
                n_valid=m))
        count = scanned + int(plan.extra[0, 0])
        stats = {
            "launches": 1 if m else 0,
            "rows_scanned": m,
            "rows_full_equiv": n_eff,
            "scan_fraction": m / max(1, n_eff),
            "scanned_clusters": int(len(plan.scan_ids)),
            "boundary_clusters": plan.boundary_clusters,
            "clusters": self.k_clusters,
            "batch": int(preds.shape[0]),
        }
        self._record(stats, probes=1)
        return count, stats

    def kth_smallest(self, pred: np.ndarray, k: int, *,
                     live: np.ndarray | None = None,
                     live_sizes: np.ndarray | None = None) -> float:
        """Exact k-th smallest distance via bound-ordered cluster scanning:
        clusters in ascending lower-bound order, ``chunk_rows`` rows a
        launch, stopping once the running k-th candidate is <= the next
        cluster's lower bound - eps. Bitwise the full scan's value."""
        pred = np.asarray(pred, np.float32)
        if live is not None and live_sizes is None:
            live_sizes = self.live_cluster_sizes(live)
        sizes = self.sizes if live_sizes is None \
            else np.asarray(live_sizes, np.int64)
        n_eff = int(sizes.sum())
        k = max(1, min(int(k), max(n_eff, 1)))
        lb, _ = self.cluster_bounds(pred[None])
        lb = lb[0]
        ne = np.flatnonzero(sizes > 0)
        order = ne[np.argsort(lb[ne], kind="stable")]
        pred_t = self._tensor(pred)
        thr_t = torch.zeros((1,), dtype=f32, device=self.device)
        best = np.empty(0, np.float32)
        i, launches, rows_scanned = 0, 0, 0
        # enough rows a launch to amortize it without defeating the early
        # stop on small stores
        target = max(k, min(self.chunk_rows, max(1, n_eff // 8)))
        while i < len(order):
            if best.size >= k and best[k - 1] <= lb[order[i]] - self.eps:
                break
            j, nrows = i, 0
            while j < len(order) and (j == i or nrows < target):
                nrows += int(sizes[order[j]])
                j += 1
            buf, m = self._gather(order[i:j], live)
            _, topk = ct.cosine_probe_masked(buf, m, pred_t, thr_t,
                                             k=min(k, m))
            got = topk.cpu().numpy()
            best = np.sort(np.concatenate([best, got[np.isfinite(got)]]),
                           kind="stable")[:k]
            launches += 1
            rows_scanned += m
            i = j
        self._record({"launches": launches, "rows_scanned": rows_scanned,
                      "rows_full_equiv": n_eff}, probes=1)
        return float(best[k - 1])

    # -------------------------------------------------------------- stats

    def _record(self, stats: dict, *, probes: int) -> None:
        with self._lock:
            self._cum["probes"] += probes
            self._cum["launches"] += stats["launches"]
            self._cum["rows_scanned"] += stats["rows_scanned"]
            self._cum["rows_full_equiv"] += stats["rows_full_equiv"]
            frac = (self._cum["rows_scanned"]
                    / max(1, self._cum["rows_full_equiv"]))
        obs = self.obs
        if obs is not None:
            obs.index_scan(stats, probes=probes, fraction=frac)

    def stats(self) -> dict:
        """Cumulative scan accounting; ``scan_fraction`` is rows actually
        scanned over rows a full-scan probe would have scanned."""
        with self._lock:
            d = dict(self._cum)
        d["scan_fraction"] = (d["rows_scanned"]
                              / max(1, d["rows_full_equiv"]))
        return d

    def reset_stats(self) -> None:
        with self._lock:
            for key in self._cum:
                self._cum[key] = 0


def _assemble_store(x: torch.Tensor, cent64: np.ndarray, assign, *,
                    eps: float, chunk_rows: int,
                    perm_base: np.ndarray | None = None) -> ClusteredStore:
    """Reorder ``x`` cluster-contiguous on its device for a given
    (centroids, assignment) and compute the exact float64 per-cluster radii
    on the device (inflated by one part in 1e9: the bounds must never
    under-cover). ``perm_base`` relabels rows of ``x`` to external row ids
    (default ``arange(n)``)."""
    n = x.shape[0]
    k = len(cent64)
    assign = np.asarray(assign.cpu() if isinstance(assign, torch.Tensor)
                        else assign).astype(np.int64)
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=k).astype(np.int64)
    offsets = np.zeros(k + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    xs = x.index_select(0, torch.as_tensor(order, device=x.device))
    cluster_of = assign[order]
    rnorm = center_dists(xs, cent64, cluster_of)
    radii = torch.zeros((k,), dtype=f64, device=x.device).scatter_reduce_(
        0, torch.as_tensor(cluster_of, device=x.device), rnorm, "amax")
    radii = radii.cpu().numpy() * (1.0 + 1e-9) + 1e-12
    row_norm = _max_row_norm(xs) if n else 1.0
    perm = order if perm_base is None else np.asarray(perm_base)[order]
    return ClusteredStore(
        embeddings=xs, offsets=offsets, sizes=sizes,
        centroids=np.asarray(cent64, np.float64), radii=radii,
        perm=perm.astype(np.int64), eps=eps, chunk_rows=chunk_rows,
        max_row_norm=float(row_norm) * (1.0 + 1e-9) + 1e-12)


def _split_round_2means(x64: np.ndarray, members: list[np.ndarray],
                        iters: int) -> list[np.ndarray | None]:
    """One vectorized 2-means pass over a batch of candidate clusters.

    Pads every candidate's members to a common (C, M, d) stack and runs all
    C local Lloyd loops at once with masked updates. Seeds are farthest-point
    picks (the member farthest from the mean, then the member farthest from
    that), so duplicates degenerate to an empty side at once. Returns, per
    candidate, the members that move to the new cluster, or None when the
    split is degenerate."""
    c_n = len(members)
    m_max = max(len(m) for m in members)
    d = x64.shape[1]
    pts = np.zeros((c_n, m_max, d))
    mask = np.zeros((c_n, m_max), bool)
    for i, m in enumerate(members):
        pts[i, :len(m)] = x64[m]
        mask[i, :len(m)] = True
    counts = mask.sum(axis=1)                                    # (C,)
    mean = pts.sum(axis=1) / counts[:, None]
    d_mean = np.where(mask, np.linalg.norm(pts - mean[:, None], axis=2),
                      -np.inf)
    s0 = d_mean.argmax(axis=1)
    c0 = pts[np.arange(c_n), s0]                                 # (C, d)
    d_c0 = np.where(mask, np.linalg.norm(pts - c0[:, None], axis=2),
                    -np.inf)
    c1 = pts[np.arange(c_n), d_c0.argmax(axis=1)]
    for _ in range(iters):
        d0 = np.linalg.norm(pts - c0[:, None], axis=2)           # (C, M)
        d1 = np.linalg.norm(pts - c1[:, None], axis=2)
        side1 = (d1 < d0) & mask
        side0 = ~side1 & mask
        n0 = side0.sum(axis=1)
        n1 = side1.sum(axis=1)
        ok = (n0 > 0) & (n1 > 0)
        c0 = np.where(ok[:, None],
                      (pts * side0[:, :, None]).sum(axis=1)
                      / np.maximum(n0, 1)[:, None], c0)
        c1 = np.where(ok[:, None],
                      (pts * side1[:, :, None]).sum(axis=1)
                      / np.maximum(n1, 1)[:, None], c1)
    d0 = np.linalg.norm(pts - c0[:, None], axis=2)
    d1 = np.linalg.norm(pts - c1[:, None], axis=2)
    side1 = (d1 < d0) & mask
    out: list[np.ndarray | None] = []
    for i, m in enumerate(members):
        s1 = side1[i, :len(m)]
        out.append(m[s1] if 0 < s1.sum() < len(m) else None)
    return out


def _split_fat_clusters(x: np.ndarray, cent64: np.ndarray,
                        assign: np.ndarray, *, split_radius: float,
                        max_clusters: int, iters: int = 6,
                        ) -> tuple[np.ndarray, np.ndarray]:
    """2-means-split every cluster wider than ``split_radius``, a round at a
    time (host numpy; runs only when a build sets ``split_radius``).

    Each round takes every cluster with radius > ``split_radius`` and >= 2
    members (widest first when ``max_clusters`` caps the splits), splits the
    batch in one ``_split_round_2means``, and queues still-fat children for
    the next round. A degenerate split marks the cluster unsplittable, so
    the loop ends. Only the assignment changes; the radii are recomputed
    from the members downstream, so the bounds stay exact."""
    x64 = x.astype(np.float64)
    cents = [c for c in np.asarray(cent64, np.float64)]
    assign = np.asarray(assign).copy()
    unsplittable: set[int] = set()
    # (radius, members) per cluster — only split children change per round
    info: dict[int, tuple[float, np.ndarray]] = {}

    def refresh(c: int) -> None:
        m = np.flatnonzero(assign == c)
        r = float(np.linalg.norm(x64[m] - cents[c], axis=1).max()) \
            if len(m) else 0.0
        info[c] = (r, m)

    for c in range(len(cents)):
        refresh(c)
    while len(cents) < max_clusters:
        cand = sorted(
            ((r, c, m) for c, (r, m) in info.items()
             if r > split_radius and len(m) >= 2 and c not in unsplittable),
            key=lambda e: -e[0])[:max_clusters - len(cents)]
        if not cand:
            break
        moves = _split_round_2means(x64, [m for _, _, m in cand], iters)
        progressed = False
        for (_, c, m), mv in zip(cand, moves):
            if mv is None:
                unsplittable.add(c)
                continue
            new_id = len(cents)
            cents.append(cents[c].copy())
            assign[mv] = new_id
            keep = np.setdiff1d(m, mv, assume_unique=True)
            cents[c] = x64[keep].mean(axis=0)
            cents[new_id] = x64[mv].mean(axis=0)
            refresh(c)
            refresh(new_id)
            progressed = True
            if len(cents) >= max_clusters:
                break
        if not progressed:
            break
    return np.asarray(cents), assign


def build_clustered_store(
    embeddings, k_clusters: int, *, iters: int = 8, seed: int = 0,
    eps: float = 1e-4, chunk_rows: int = 4096,
    split_radius: float | None = None, max_clusters: int | None = None,
    init_centroids: np.ndarray | None = None, device=None,
) -> ClusteredStore:
    """Partition (N, d) embeddings into K clusters for pruned probing.

    Lloyd's k-means through the port's assignment kernel (which takes
    K <= 512 on the card), then the cluster-contiguous reorder and the
    float64 radii on the device. ``embeddings``: a tensor (it stays on its
    device) or an array (it goes to ``device``, the card by default). K is
    clamped to N; empty clusters get zero-width segments.

    ``split_radius``: after Lloyd's, split every cluster wider than this
    until all fit, turn out unsplittable, or the total reaches
    ``max_clusters`` (default ``4 * K``, clamped to N); probes stay bitwise
    the full scan's. ``init_centroids`` warm-starts Lloyd's from a previous
    build's centroids (the mutable store's incremental rebuild).
    """
    x = store_tensor(embeddings, device)
    n = x.shape[0]
    k = max(1, min(int(k_clusters), n))
    centroids, assign = kmeans(x, k, iters=iters, seed=seed,
                               init_centroids=init_centroids)
    cent64 = centroids.to(f64).cpu().numpy()
    assign = assign.cpu().numpy()
    if split_radius is not None and split_radius > 0:
        cap = min(n, 4 * k if max_clusters is None else int(max_clusters))
        cent64, assign = _split_fat_clusters(
            x.cpu().numpy(), cent64, assign, split_radius=float(split_radius),
            max_clusters=max(k, cap))
    return _assemble_store(x, cent64, assign, eps=eps, chunk_rows=chunk_rows)


def store_from_fragments(
    embeddings, fragments: list[tuple[np.ndarray, np.ndarray]], *,
    eps: float = 1e-4, chunk_rows: int = 4096, device=None,
) -> ClusteredStore:
    """A ``ClusteredStore`` whose clusters are exactly the given
    ``(row_ids, centroid)`` fragments — no k-means run. ``row_ids`` index
    ``embeddings`` and are disjoint; ``perm`` carries them through. The
    radii are recomputed over each fragment's members, so bounds stay
    exact."""
    x = store_tensor(embeddings, device)
    rows = np.concatenate([np.asarray(r, np.int64) for r, _ in fragments]) \
        if fragments else np.empty(0, np.int64)
    assign = np.concatenate(
        [np.full(len(r), i, np.int64) for i, (r, _) in enumerate(fragments)]
    ) if fragments else np.empty(0, np.int64)
    cent64 = np.asarray([c for _, c in fragments], np.float64) \
        if fragments else np.empty((0, x.shape[1]), np.float64)
    return _assemble_store(
        x.index_select(0, torch.as_tensor(rows, device=x.device)), cent64,
        assign, eps=eps, chunk_rows=chunk_rows, perm_base=rows)

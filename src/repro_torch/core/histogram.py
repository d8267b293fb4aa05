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

Sharding: construct with ``mesh=`` a ``repro_torch.launch.mesh.ProbeMesh``
and every probe runs once per shard — shard s scans the s-th contiguous row
block of the store on its device, a view of the store on a single card —
then the shards' answers are combined: counts summed as int32, top-k lists
concatenated and re-sorted (``make_sharded_probe``). With a
``repro_torch.index.ShardedClusteredStore`` as ``index=`` each shard scans
only its boundary rows (``make_sharded_pruned_probe``). One process drives
every shard, as the reference's ``shard_map`` does; the combine moves
O(B·k) values, whatever N. A row's distance does not depend on its shard,
so every sharded probe is bitwise the unsharded one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.cosine_topk import ops as ct
from repro_torch.kernels.cosine_topk.ref import cosine_distances
from repro_torch.launch.mesh import data_axes


@dataclasses.dataclass
class SemanticHistogram:
    embeddings: torch.Tensor     # (N, d) unit vectors, on the probe device
    cache: object | None = None  # PredicateCache-like (duck-typed)
    mesh: object | None = None   # ProbeMesh: sharded probes when set
    index: object | None = None  # ClusteredStore, ShardedClusteredStore
    #                              (with mesh=) or MutableClusteredStore

    def __post_init__(self):
        if not isinstance(self.embeddings, torch.Tensor):
            raise TypeError("embeddings must be a torch.Tensor on the probe "
                            "device")
        self._n_static = self.embeddings.shape[0]
        self._sharded_probes = {}    # (batched, k) -> probe
        self._blocks = None          # the store's shard blocks, placed once
        self._mutable = getattr(self.index, "is_mutable", False)
        if self._mutable:
            # the mutable store owns its rows, its mesh and its probe
            # dispatch; check only the wiring
            if self.index.mesh is not self.mesh:
                raise ValueError(
                    "a MutableClusteredStore carries its own mesh; pass "
                    "the same mesh (or None) to SemanticHistogram")
            if self.index.d != self.embeddings.shape[1]:
                raise ValueError(
                    f"index dim {self.index.d} != store dim "
                    f"{self.embeddings.shape[1]}")
            return
        if self.mesh is not None:
            self._n_shards = mesh_shards(self.mesh)
            if self.n % self._n_shards:
                raise ValueError(
                    f"store rows ({self.n}) must divide the mesh's "
                    f"{self._n_shards} data shards evenly")
        if self.index is not None:
            sharded_index = hasattr(self.index, "shards")
            if sharded_index and self.mesh is None:
                raise ValueError(
                    "a ShardedClusteredStore index needs mesh=... (use "
                    "build_clustered_store for single-device probing)")
            if self.mesh is not None and not sharded_index:
                raise ValueError(
                    "mesh=... needs a ShardedClusteredStore index (use "
                    "build_sharded_clustered_store, one sub-index per "
                    "shard)")
            if sharded_index and self.index.n_shards != self._n_shards:
                raise ValueError(
                    f"index has {self.index.n_shards} shards, mesh has "
                    f"{self._n_shards} — rebuild the index for this mesh")
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

    # -------------------- sharded routing --------------------

    def _sharded_probe(self, *, k: int, batched: bool):
        """Build-and-cache one sharded probe per (batched, k): the full scan
        of every shard block, or with a ``ShardedClusteredStore`` the
        pruned scan of each shard's boundary rows; either way bitwise the
        unsharded probe."""
        key = (batched, k)
        probe = self._sharded_probes.get(key)
        if probe is None:
            if self.index is not None:
                if self._blocks is None:
                    self._blocks = shard_blocks(self.mesh,
                                                self.index.embeddings)
                probe = make_sharded_pruned_probe(
                    self.mesh, self.index, k=k, batched=batched,
                    store=self._blocks)
            else:
                if self._blocks is None:
                    self._blocks = shard_blocks(self.mesh, self.embeddings)
                inner = make_sharded_probe(self.mesh, k=k, batched=batched)
                blocks = self._blocks

                def probe(preds, thresholds, *, need_topk=True,
                          _inner=inner):
                    return _inner(blocks, self._tensor(preds),
                                  self._tensor(thresholds))

            self._sharded_probes[key] = probe
        return probe

    def _to_device(self, counts, topk):
        """A probe's (counts, top-k) as tensors on the store's device."""
        return (torch.as_tensor(counts).to(self.device),
                torch.as_tensor(topk).to(self.device))

    # -------------------- core fused probe --------------------

    def _probe(self, pred: np.ndarray, thresholds: np.ndarray, *, k: int,
               need_topk: bool = True):
        """One predicate: (counts (T,), top-k (k,)) on the store's device."""
        if self.mesh is not None and not self._mutable:
            return self._to_device(*self._sharded_probe(k=k, batched=False)(
                np.asarray(pred, np.float32),
                np.asarray(thresholds, np.float32), need_topk=need_topk))
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
        elif self.mesh is not None:
            counts, topk = self._sharded_probe(k=k, batched=True)(
                preds, thresholds, need_topk=need_topk)
        elif self.index is not None:
            counts, topk, _ = self.index.probe_pruned(
                preds, thresholds, k=k, need_topk=need_topk)
        else:
            return ct.cosine_probe_batch(self.embeddings, self._tensor(preds),
                                         self._tensor(thresholds), k=k)
        return self._to_device(counts, topk)

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
        if self.mesh is not None:
            # a row's match does not depend on its shard: the shards'
            # counts sum to the unsharded count
            if self._blocks is None:
                self._blocks = shard_blocks(self.mesh, self.embeddings)
            return sum(int(ct.cosine_compound_count(
                b, torch.as_tensor(preds_np, device=b.device),
                torch.as_tensor(thr_np, device=b.device), mode=mode))
                for b in self._blocks)
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
        if self.mesh is not None and not self._mutable:
            # one thr=0 probe: each shard gives its exact top-min(k, rows)
            # (pruned: through the top-k cover) and the combine re-sorts,
            # so topk[k-1] is the exact k-th, bitwise the full pass's
            _, smallest = self._probe(pred, np.zeros((1,), np.float32),
                                      k=int(k))
            return float(smallest[k - 1])
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


# -------------------------------------------------------------- sharding

def _mesh_data_axes(mesh) -> tuple[str, ...]:
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {dict(mesh.shape)} has no 'pod'/'data' axis "
                         f"to shard the store over")
    return axes


def mesh_shards(mesh) -> int:
    """Shards of the store: the product of the mesh's pod/data axes."""
    n = 1
    for a in _mesh_data_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def shard_blocks(mesh, store: torch.Tensor) -> list[torch.Tensor]:
    """Shard s's contiguous row block of ``store``, on shard s's device: a
    view of ``store`` where the two devices are one, a copy elsewhere."""
    n_shards = mesh_shards(mesh)
    rows = store.shape[0] // n_shards
    return [store[s * rows:(s + 1) * rows].to(dev)
            for s, dev in enumerate(mesh.shard_devices)]


def _combine(counts: list, tops: list, k: int, device: torch.device):
    """The shards' answers as one: counts (B, T) summed as int32, top-k
    lists (B, kk_s) concatenated along the shard axis and re-sorted; a
    batch short of k candidates is filled with +inf. O(B·k) values move,
    whatever the store's size."""
    total = torch.stack([c.to(device) for c in counts]).sum(
        dim=0, dtype=torch.int32)
    flat = torch.cat([t.to(device) for t in tops], dim=1)
    top = torch.topk(flat, min(k, flat.shape[1]), dim=1, largest=False,
                     sorted=True).values
    if top.shape[1] < k:
        top = torch.cat([top, torch.full((top.shape[0], k - top.shape[1]),
                                         torch.inf, device=device)], dim=1)
    return total, top


def make_sharded_probe(mesh, *, k: int = 128, batched: bool = False):
    """The sharded full scan: each shard's fused probe over its row block,
    then the combine (the reference's ``psum`` of counts and
    ``all_gather`` + re-sort of top-k).

    The returned ``probe(store, preds, thresholds)`` takes the store as one
    (N, d) tensor (split into ``shard_blocks``) or as the blocks already
    placed. Scalar (default): pred (d,), thresholds (T,) -> (counts (T,),
    top (k,)); ``batched=True``: preds (B, d), thresholds (B, T) ->
    (counts (B, T), top (B, k)). Each shard's top-k is clamped to its rows,
    so ``k`` may pass a shard's rows (threshold calibration asks for k up
    to N) and the merged result is still the exact global top-k."""
    _mesh_data_axes(mesh)

    def probe(store, preds, thresholds):
        blocks = (shard_blocks(mesh, store)
                  if isinstance(store, torch.Tensor) else list(store))
        kk = max(1, min(int(k), blocks[0].shape[0]))
        p2 = preds if batched else preds[None]
        t2 = thresholds if batched else thresholds[None]
        counts, tops = [], []
        for buf in blocks:
            c, tp = ct.cosine_probe_batch(buf, p2.to(buf.device),
                                          t2.to(buf.device), k=kk) \
                if batched else ct.cosine_probe(
                    buf, preds.to(buf.device), thresholds.to(buf.device),
                    k=kk)
            counts.append(c if batched else c[None])
            tops.append(tp if batched else tp[None])
        total, top = _combine(counts, tops,
                              min(int(k), kk * len(blocks)),
                              blocks[0].device)
        return (total, top) if batched else (total[0], top[0])

    return probe


def make_sharded_pruned_probe(mesh, index, *, k: int = 128,
                              batched: bool = False, store=None):
    """Cluster-pruned twin of ``make_sharded_probe`` — sublinear per shard.

    ``index`` is a ``repro_torch.index.ShardedClusteredStore`` whose shard
    blocks are the mesh's row partition. The returned ``probe(preds,
    thresholds, need_topk=True)`` plans every shard on the host (exact
    float64 Cauchy-Schwarz bounds), gathers exactly each shard's boundary
    rows (plus its top-k cover) on its device and scores them with the
    masked probe, one launch a shard that has rows to scan, then combines.
    Counts and top-k are bitwise ``make_sharded_probe``'s: all-in/all-out
    clusters resolve by bounds (``eps`` covers the kernel's f32 roundoff)
    and each shard's cover keeps its local top-k exact. Returns host
    arrays: counts int32, top-k float32.

    Nothing is padded: the reference pads every shard to one power-of-two
    bucket because ``shard_map`` needs one shape; each shard here scans
    exactly its m rows, a shard promoted to a full scan scans its block in
    place, and a shard with nothing to scan launches nothing.
    ``need_topk=False`` (count-only callers) skips the top-k cover; a probe
    whose every cluster resolves launches nothing and its top-k is +inf.
    ``store``: the reordered store's blocks already placed on the mesh (by
    default placed here, once)."""
    n_shards = mesh_shards(mesh)
    if n_shards != index.n_shards:
        raise ValueError(
            f"index has {index.n_shards} shards but the mesh's data axes "
            f"hold {n_shards} devices — rebuild the index for this mesh")
    kk = max(1, min(int(k), index.shard_rows))   # per-shard cover / top-k
    k_final = max(1, min(int(k), index.n))
    blocks = (list(store) if store is not None
              else shard_blocks(mesh, index.embeddings))

    def probe(preds, thresholds, *, need_topk: bool = True, live=None,
              live_sizes=None, live_n=None):
        """``live`` (per-shard (rows,) bool masks), ``live_sizes``
        (per-shard (K_s,) live cluster counts) and ``live_n`` (per-shard
        live totals) carry the mutable store's tombstones: plans run over
        live sizes, gathers drop dead rows, and the stats denominator is
        the live row count."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32)
        if batched and thr.ndim == 1:
            thr = thr[:, None]
        p2 = preds if batched else preds[None, :]
        t2 = thr if batched else thr[None, :]
        b = t2.shape[0]
        plans = index.plan_shards(p2, t2, k=kk, need_topk=need_topk,
                                  live_sizes=live_sizes)
        extra = np.sum([p.extra for p in plans], axis=0)        # (B, T)
        counts, tops = [], []
        for s, (shard, plan) in enumerate(zip(index.shards, plans)):
            if not plan.m:
                continue
            buf = blocks[s]
            if live is not None or plan.m < index.shard_rows:
                rows = shard.scan_rows(plan.scan_ids,
                                       live=None if live is None else live[s])
                buf = buf.index_select(
                    0, torch.as_tensor(rows, device=buf.device))
            c, tp = shard._masked_probe(
                buf, plan.m, torch.as_tensor(p2, device=buf.device),
                torch.as_tensor(t2, device=buf.device), k=kk)
            counts.append(c)
            tops.append(tp)
        index.record(plans, launched=bool(counts), live_n=live_n)
        if counts:
            total, top = _combine(counts, tops, k_final, blocks[0].device)
            total = (total.cpu().numpy() + extra).astype(np.int32)
            top = top.cpu().numpy()
        else:                   # every cluster on every shard resolved
            total = extra.astype(np.int32)
            top = np.full((b, k_final), np.inf, np.float32)
        return (total, top) if batched else (total[0], top[0])

    return probe

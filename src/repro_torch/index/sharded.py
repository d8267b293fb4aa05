"""Per-shard cluster-pruned index: sublinear probes that survive sharding.

A port of the reference's ``repro/index/sharded.py``. The (N, d) store is
split into ``n_shards`` contiguous row blocks — the partition a
``ProbeMesh`` (``repro_torch.launch.mesh``) gives its shards, pod-major —
and each block gets its own ``ClusteredStore``: cluster-contiguous local
layout, float64 centroids and radii *per shard*. Clustering each shard's
rows on their own keeps a boundary segment inside one shard, so bounds
prune per shard: a shard whose clusters all resolve contributes no rows to
the probe, and uneven boundary work shows in ``stats()['per_shard']``.

``repro_torch.core.histogram.make_sharded_pruned_probe`` plans every shard
on the host (exact Cauchy-Schwarz bounds, float64), gathers each shard's
boundary rows and scores them with the masked probe kernel, one launch a
shard, then combines: counts summed, top-k lists re-sorted. A row's
distance does not depend on the buffer it sits in, so the result is
bitwise the full-scan sharded probe's.

The reordered store is one tensor: each sub-index's ``embeddings`` is a
view of its row block, so the index holds one reordered copy of the store,
not two.

Boundary-mass balancing (``balance="boundary"``): cluster the store
globally, score each cluster's expected boundary mass (size x radius) and
pack clusters onto shards with a greedy LPT min-max packer under the hard
equal-rows-per-shard constraint, splitting clusters at shard edges where
packing needs it. ``perm`` makes any placement result-invariant and a
fragment's radius is recomputed from its members, so probes are bitwise
unchanged; only where boundary rows live moves. The packers are the
reference's host numpy, copied.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading

import numpy as np
import torch

from repro_torch.index.clustered import (
    ClusteredStore,
    _max_row_norm,
    build_clustered_store,
    store_from_fragments,
    store_tensor,
)
from repro_torch.kernels.cosine_topk import ops as ct

__all__ = ["ShardedClusteredStore", "build_sharded_clustered_store"]


@dataclasses.dataclass
class ShardedClusteredStore:
    """One ``ClusteredStore`` per contiguous shard row block of the store.

    ``embeddings`` is the reordered (N, d) store on the device: shard
    blocks in order, each block cluster-contiguous, each sub-index's
    ``embeddings`` a view of its block. ``perm`` maps reordered row ->
    original row id. Attach to ``SemanticHistogram(mesh=..., index=...)``
    to route every probe through the pruned sharded path.
    """

    shards: list[ClusteredStore]   # per-shard sub-index over its row block
    shard_rows: int                # rows per shard (uniform)
    embeddings: torch.Tensor       # (N, d) f32, shard-blocked + reordered
    perm: np.ndarray               # (N,) original row ids in stored order
    balance: str = "contiguous"    # partitioning strategy used at build
    # predicted per-shard boundary mass of the contiguous row-block
    # partition under the balanced build's global clustering (balanced
    # builds only): the counterfactual serve prints beside boundary_mass()
    contiguous_mass: np.ndarray | None = None
    # the balanced build's global centroids: the mutable store's next
    # rebuild warm-starts from them
    global_centroids: np.ndarray | None = None

    def __post_init__(self):
        self.n = int(self.embeddings.shape[0])
        self.n_shards = len(self.shards)
        self.k_clusters = self.shards[0].k_clusters if self.shards else 0
        self.eps = self.shards[0].eps if self.shards else 1e-4
        self._lock = threading.Lock()
        self._probes = 0
        self._launches = 0
        self._rows_scanned = 0
        self._rows_full_equiv = 0
        # telemetry hub, attached by the serve layer to the wrapper only
        # (the per-shard stores keep obs=None, so a probe reports once)
        self.obs = None

    @classmethod
    def from_partition(cls, embeddings, parts: list[dict], *,
                       balance: str = "contiguous",
                       contiguous_mass: np.ndarray | None = None,
                       global_centroids: np.ndarray | None = None,
                       eps: float = 1e-4, chunk_rows: int = 4096,
                       device=None) -> "ShardedClusteredStore":
        """A sharded index over a given partition, with no k-means run: one
        dict per shard with ``perm`` (its rows' original ids, in stored
        order), ``offsets`` (K_s + 1,), float64 ``centroids`` (K_s, d) and
        ``radii`` (K_s,), and optionally ``max_row_norm``. This is how a
        partition built elsewhere — the reference's — is carried over."""
        x = store_tensor(embeddings, device)
        perm = np.concatenate([np.asarray(p["perm"], np.int64)
                               for p in parts])
        full = x.index_select(0, torch.as_tensor(perm, device=x.device))
        rows = len(perm) // max(1, len(parts))
        shards = []
        for s, p in enumerate(parts):
            view = full[s * rows:(s + 1) * rows]
            offsets = np.asarray(p["offsets"], np.int64)
            norm = p.get("max_row_norm")
            if norm is None:
                norm = _max_row_norm(view) * (1.0 + 1e-9) + 1e-12
            shards.append(ClusteredStore(
                embeddings=view, offsets=offsets, sizes=np.diff(offsets),
                centroids=np.asarray(p["centroids"], np.float64),
                radii=np.asarray(p["radii"], np.float64),
                perm=np.asarray(p["perm"], np.int64), eps=eps,
                chunk_rows=chunk_rows, max_row_norm=float(norm)))
        return cls(shards=shards, shard_rows=rows, embeddings=full,
                   perm=perm, balance=balance,
                   contiguous_mass=contiguous_mass,
                   global_centroids=global_centroids)

    # ------------------------------------------------------------ planning

    def plan_shards(self, preds: np.ndarray, thr: np.ndarray, *, k: int,
                    need_topk: bool = True,
                    live_sizes: list | None = None) -> list:
        """One exact ``ScanPlan`` per shard for a (B, d) x (B, T) probe.

        ``k`` is the per-shard top-k cover size, already clamped by the
        caller to the shard's rows. ``live_sizes`` — one (K_s,) live count
        array per shard (mutable-store tombstones) — makes each shard plan
        over its live rows only."""
        if live_sizes is None:
            live_sizes = [None] * self.n_shards
        return [s.plan_scan(preds, thr, k=k, need_topk=need_topk,
                            live_sizes=ls)
                for s, ls in zip(self.shards, live_sizes)]

    def count_bounds(self, preds: np.ndarray, thresholds: np.ndarray, *,
                     live_sizes: list | None = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Exact count interval per (predicate, threshold), zero rows read:
        the sum of every shard's bound-only interval (host-side), so the
        sharded index gives the same degraded answers as one device's.
        ``live_sizes`` as in ``plan_shards``."""
        if live_sizes is None:
            live_sizes = [None] * self.n_shards
        los, his = zip(*(s.count_bounds(preds, thresholds, live_sizes=ls)
                         for s, ls in zip(self.shards, live_sizes)))
        return sum(los), sum(his)

    # ----------------------------------------------------------- compound

    def probe_compound(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       mode: str = "and", live: list | None = None,
                       live_sizes: list | None = None,
                       live_n: list | None = None) -> tuple[int, dict]:
        """Exact compound match count across all shards.

        Each shard plans the conjunction/disjunction jointly
        (``ClusteredStore.plan_compound``), gathers exactly its surviving
        boundary rows and counts them with the probe kernel's compound
        launch; per-shard counts and bound-resolved extras sum. Per-row
        distances are row-local, so the sum is bitwise one scan of the
        whole store. ``live``/``live_sizes``/``live_n``: one entry per
        shard (mutable-store tombstones). Returns (count, stats) with
        ``ClusteredStore.probe_compound``'s keys."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32).reshape(-1)
        if live is None:
            live = [None] * self.n_shards
        if live_sizes is None:
            live_sizes = [None] * self.n_shards
        plans = [s.plan_compound(preds, thr, mode=mode, live_sizes=ls)
                 for s, ls in zip(self.shards, live_sizes)]
        count = sum(int(p.extra[0, 0]) for p in plans)
        rows_scanned = 0
        for shard, plan, lv in zip(self.shards, plans, live):
            if not (len(plan.scan_ids) and plan.m):
                continue
            buf, m = shard._gather(plan.scan_ids, lv)
            rows_scanned += m
            count += int(ct.cosine_compound_count(
                buf, shard._tensor(preds), shard._tensor(thr), mode=mode,
                n_valid=m))
        launched = rows_scanned > 0
        self.record(plans, launched=launched, live_n=live_n)
        nl = live_n if live_n is not None else [s.n for s in self.shards]
        n_eff = sum(int(x) for x in nl)
        stats = {
            "launches": 1 if launched else 0,
            "rows_scanned": rows_scanned,
            "rows_full_equiv": n_eff,
            "scan_fraction": rows_scanned / max(1, n_eff),
            "scanned_clusters": sum(len(p.scan_ids) for p in plans),
            "boundary_clusters": sum(p.boundary_clusters for p in plans),
            "clusters": sum(s.k_clusters for s in self.shards),
            "batch": int(preds.shape[0]),
        }
        return count, stats

    # -------------------------------------------------------------- stats

    def record(self, plans: list, *, launched: bool,
               live_n: list | None = None) -> None:
        """Account one sharded probe: each shard's rows into its sub-index
        (their scan fractions diverge when boundary work is uneven), the
        probe/launch tally here. ``live_n`` — per-shard live row counts
        under tombstones — replaces ``shard.n`` as the full-scan
        denominator. ``launches`` counts sharded probes that scanned
        anything on any shard, as the reference counts its one shard_map
        launch."""
        if live_n is None:
            live_n = [s.n for s in self.shards]
        for shard, plan, nl in zip(self.shards, plans, live_n):
            shard._record({"launches": 1 if (launched and plan.m) else 0,
                           "rows_scanned": plan.m if launched else 0,
                           "rows_full_equiv": int(nl)}, probes=1)
        rows = sum(p.m for p in plans) if launched else 0
        full = sum(int(nl) for nl in live_n)
        with self._lock:
            self._probes += 1
            self._launches += 1 if launched else 0
            self._rows_scanned += rows
            self._rows_full_equiv += full
            frac = self._rows_scanned / max(1, self._rows_full_equiv)
        obs = self.obs
        if obs is not None:
            obs.index_scan(
                {"launches": 1 if launched else 0, "rows_scanned": rows,
                 "rows_full_equiv": full,
                 "scan_fraction": rows / max(1, full)},
                probes=1, fraction=frac,
                per_shard=[{"shard": s,
                            "rows_scanned": int(p.m) if launched else 0,
                            "rows_full_equiv": int(nl)}
                           for s, (p, nl) in
                           enumerate(zip(plans, live_n))])

    def boundary_mass(self) -> np.ndarray:
        """Predicted boundary mass per shard: ``sum(size_c * radius_c)``
        over each shard's clusters — how many rows a threshold landing at
        random forces the shard to scan. The balanced build minimises the
        max of this vector."""
        return np.asarray([float((s.sizes * s.radii).sum())
                           for s in self.shards])

    def stats(self) -> dict:
        """Aggregate scan accounting + ``per_shard`` breakdown.

        ``per_shard[s]['scan_fraction']`` is shard s's rows scanned over
        the rows a full shard scan would have read; ``spread`` (max - min
        per-shard fraction), ``max_scan_fraction`` and
        ``max_shard_rows_scanned`` are the imbalance fields."""
        per = [s.stats() for s in self.shards]
        with self._lock:
            d = {"probes": self._probes, "launches": self._launches}
        d["rows_scanned"] = sum(p["rows_scanned"] for p in per)
        d["rows_full_equiv"] = sum(p["rows_full_equiv"] for p in per)
        d["scan_fraction"] = (d["rows_scanned"]
                              / max(1, d["rows_full_equiv"]))
        d["per_shard"] = [{"rows_scanned": p["rows_scanned"],
                           "rows_full_equiv": p["rows_full_equiv"],
                           "scan_fraction": p["scan_fraction"]}
                          for p in per]
        fracs = [p["scan_fraction"] for p in d["per_shard"]]
        d["max_scan_fraction"] = max(fracs, default=0.0)
        d["spread"] = (max(fracs) - min(fracs)) if fracs else 0.0
        d["max_shard_rows_scanned"] = max(
            (p["rows_scanned"] for p in d["per_shard"]), default=0)
        return d

    def reset_stats(self) -> None:
        for s in self.shards:
            s.reset_stats()
        with self._lock:
            self._probes = 0
            self._launches = 0
            self._rows_scanned = 0
            self._rows_full_equiv = 0


def _cluster_items(gcs: ClusteredStore) -> list:
    """Per-cluster pack items ``(-mass, tiebreak, members, dist, cent)``:
    member ids (global row ids) sorted near-to-far with their centroid
    distances, so fragment masses need no second norm pass. Max-heap order
    on boundary mass ``size x radius``. The distances are the reference's
    host float64 numpy, so the pack is the reference's."""
    xs = gcs.embeddings.cpu().numpy()        # one host copy, in float32
    items = []
    tiebreak = 0
    for c in range(gcs.k_clusters):
        if not gcs.sizes[c]:
            continue
        members = gcs.perm[gcs.offsets[c]:gcs.offsets[c + 1]]
        seg = xs[gcs.offsets[c]:gcs.offsets[c + 1]].astype(np.float64)
        dist = np.linalg.norm(seg - gcs.centroids[c], axis=1)
        order = np.argsort(dist, kind="stable")
        members, dist = members[order], dist[order]
        items.append((-float(len(members) * dist[-1]), tiebreak,
                      members, dist, gcs.centroids[c]))
        tiebreak += 1
    return items


def _lpt_place(items: list, cap: list, load: list, frags: list) -> None:
    """The greedy LPT loop: pop the heaviest item, place it on the lightest
    shard with row capacity left, split it at the shard edge when it does
    not fit (the near core fills the shard, the far shell re-enters the
    worklist with its own mass). ``items`` is a max-heap on mass, ``load``
    a min-heap of ``(mass, shard)``; both are consumed in place, ``frags``
    collects per-shard ``(global_row_ids, centroid)`` fragments."""
    tiebreak = -1          # negative tiebreaks cannot collide with items'
    while items:
        _, _, members, dist, cent = heapq.heappop(items)
        # lightest shard with capacity (full shards drop out of the heap)
        while cap[load[0][1]] == 0:
            heapq.heappop(load)
        mass, s = heapq.heappop(load)
        take = min(len(members), cap[s])
        frags[s].append((members[:take], cent))
        cap[s] -= take
        placed_mass = float(take * dist[take - 1])  # fragment's own radius
        heapq.heappush(load, (mass + placed_mass, s))
        if take < len(members):                     # far shell re-enters
            rest, rdist = members[take:], dist[take:]
            heapq.heappush(items, (-float(len(rest) * rdist[-1]), tiebreak,
                                   rest, rdist, cent))
            tiebreak -= 1


def _pack_boundary_balanced(
    gcs: ClusteredStore, n_shards: int, rows: int,
) -> list[list[tuple[np.ndarray, np.ndarray]]]:
    """Greedy LPT min-max pack of the global clusters onto shards, by
    boundary mass, splitting at shard edges (``_lpt_place``). Capacities
    sum to N, so every shard ends exactly full. Returns per-shard
    ``(global_row_ids, centroid)`` fragment lists."""
    items = _cluster_items(gcs)
    heapq.heapify(items)
    cap = [rows] * n_shards
    load = [(0.0, s) for s in range(n_shards)]      # min-heap on mass
    heapq.heapify(load)
    frags: list[list[tuple[np.ndarray, np.ndarray]]] = \
        [[] for _ in range(n_shards)]
    _lpt_place(items, cap, load, frags)
    return frags


def _pack_boundary_incremental(
    gcs: ClusteredStore, n_shards: int, rows: int,
    shard_hint: np.ndarray, *, tol: float = 0.25,
) -> list[list[tuple[np.ndarray, np.ndarray]]]:
    """Hint-guided LPT pack: keep clusters where their rows already live.

    ``shard_hint`` (N,) gives each global row its previous generation's
    shard (-1 for rows never placed, such as fresh inserts). Each cluster
    is first pinned to the shard holding most of its members while that
    shard has row capacity and its mass stays within ``(1 + tol)`` of the
    ideal; the rest (clusters whose shard is full or heavy, and edge-split
    shells) goes through the LPT pass over the remaining capacity."""
    items = _cluster_items(gcs)
    items.sort()                                   # heaviest first (-mass)
    total_mass = -sum(it[0] for it in items)
    budget = (1.0 + tol) * total_mass / n_shards
    cap = [rows] * n_shards
    mass = [0.0] * n_shards
    frags: list[list[tuple[np.ndarray, np.ndarray]]] = \
        [[] for _ in range(n_shards)]
    leftovers = []
    hint = np.asarray(shard_hint, np.int64)
    for it in items:
        _, tiebreak, members, dist, cent = it
        prev = hint[members]
        prev = prev[prev >= 0]
        s = int(np.bincount(prev, minlength=n_shards).argmax()) \
            if len(prev) else -1
        if s < 0 or cap[s] == 0 or mass[s] >= budget:
            leftovers.append(it)
            continue
        take = min(len(members), cap[s])
        frags[s].append((members[:take], cent))
        cap[s] -= take
        mass[s] += float(take * dist[take - 1])
        if take < len(members):                     # shell -> LPT phase
            rest, rdist = members[take:], dist[take:]
            leftovers.append((-float(len(rest) * rdist[-1]), tiebreak,
                              rest, rdist, cent))
    heapq.heapify(leftovers)
    load = [(mass[s], s) for s in range(n_shards)]
    heapq.heapify(load)
    _lpt_place(leftovers, cap, load, frags)
    return frags


def _join_shards(make_shard, x: torch.Tensor, n_shards: int, rows: int, *,
                 local_perm: bool, **kw) -> ShardedClusteredStore:
    """Build the shards one at a time (``make_shard(s)``), copying each one's
    reordered rows into one (N, d) tensor as it is made and making its
    ``embeddings`` a view of its block, so at most one shard's own copy
    lives beside the joined store. ``local_perm``: the shards' ``perm`` are
    ids within their row block (the contiguous build), not global ids."""
    full = torch.empty((rows * n_shards, x.shape[1]), dtype=x.dtype,
                       device=x.device)
    shards, perm = [], []
    for s in range(n_shards):
        cs = make_shard(s)
        full[s * rows:(s + 1) * rows] = cs.embeddings
        cs.embeddings = full[s * rows:(s + 1) * rows]
        shards.append(cs)
        perm.append(cs.perm + s * rows if local_perm else cs.perm)
    return ShardedClusteredStore(shards=shards, shard_rows=rows,
                                 embeddings=full, perm=np.concatenate(perm),
                                 **kw)


def build_sharded_clustered_store(
    embeddings, k_clusters: int, n_shards: int, *,
    iters: int = 8, seed: int = 0, eps: float = 1e-4,
    chunk_rows: int = 4096, balance: str = "contiguous",
    split_radius: float | None = None, max_clusters: int | None = None,
    init_centroids: np.ndarray | None = None,
    shard_hint: np.ndarray | None = None, device=None,
) -> ShardedClusteredStore:
    """Partition the store into ``n_shards`` equal row blocks of K clusters.

    The block partition is the mesh's (pod-major), so shard s's sub-index
    describes exactly the rows a ``ProbeMesh`` gives shard s.
    ``k_clusters`` is per shard (K ~ sqrt(N/S)). N must divide evenly.
    ``embeddings``: a tensor (it stays on its device) or an array (it goes
    to ``device``, the card by default); k-means runs through the port's
    assignment kernel.

    ``balance``: ``"contiguous"`` clusters each shard's original row block
    on its own (seed ``seed + s``); ``"boundary"`` clusters the store
    globally (``k_clusters * n_shards`` clusters, then fat-cluster
    splitting) and packs clusters onto shards by boundary mass. Probes are
    bitwise the same for any partition. ``split_radius`` (either mode)
    goes to the fat-cluster splitter. ``init_centroids`` (a previous
    build's ``global_centroids``) and ``shard_hint`` (each row's previous
    shard, -1 for new rows: the hint-guided pack) are the mutable store's
    incremental rebuild, ``balance="boundary"`` only.
    """
    x = store_tensor(embeddings, device)
    n = x.shape[0]
    if n_shards < 1 or n % n_shards:
        raise ValueError(
            f"store rows ({n}) must divide evenly into n_shards "
            f"({n_shards}) — same constraint as the mesh sharding")
    rows = n // n_shards
    if not 1 <= int(k_clusters) <= rows:
        raise ValueError(
            f"k_clusters={k_clusters} must be in [1, shard_rows={rows}] — "
            f"each shard holds {rows} rows ({n} rows / {n_shards} shards) "
            f"and k-means cannot place more centroids than rows")
    if balance not in ("contiguous", "boundary"):
        raise ValueError(f"balance={balance!r}: expected 'contiguous' or "
                         f"'boundary'")
    if balance != "boundary" and (init_centroids is not None
                                  or shard_hint is not None):
        raise ValueError("init_centroids / shard_hint warm-start requires "
                         "balance='boundary' (per-shard k-means runs have "
                         "no global clustering to warm-start)")

    if balance == "boundary":
        gcs = build_clustered_store(
            x, int(k_clusters) * n_shards, iters=iters, seed=seed, eps=eps,
            chunk_rows=chunk_rows, split_radius=split_radius,
            max_clusters=max_clusters, init_centroids=init_centroids)
        # counterfactual: the contiguous row blocks' predicted mass under
        # the same global clustering (each row adds its cluster's radius to
        # the block that holds it)
        cluster_of = np.empty(n, np.int64)
        cluster_of[gcs.perm] = np.repeat(np.arange(gcs.k_clusters),
                                         gcs.sizes)
        contiguous_mass = gcs.radii[cluster_of].reshape(n_shards,
                                                        rows).sum(axis=1)
        if shard_hint is not None:
            frags = _pack_boundary_incremental(
                gcs, n_shards, rows, np.asarray(shard_hint, np.int64))
        else:
            frags = _pack_boundary_balanced(gcs, n_shards, rows)
        global_centroids = np.asarray(gcs.centroids, np.float64)
        del gcs
        return _join_shards(
            lambda s: store_from_fragments(x, frags[s], eps=eps,
                                           chunk_rows=chunk_rows),
            x, n_shards, rows, local_perm=False, balance="boundary",
            contiguous_mass=contiguous_mass,
            global_centroids=global_centroids)

    return _join_shards(
        lambda s: build_clustered_store(
            x[s * rows:(s + 1) * rows], k_clusters, iters=iters,
            seed=seed + s, eps=eps, chunk_rows=chunk_rows,
            split_radius=split_radius, max_clusters=max_clusters),
        x, n_shards, rows, local_perm=True)

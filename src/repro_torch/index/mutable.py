"""Mutable clustered store: streaming ingest over the exact pruned index.

The store stays mutable without giving up the index's invariant — every
probe is bitwise equal to a fresh full scan of the live rows:

  hot tail     inserts append to an unindexed device buffer (power-of-two
               capacity) with an int32 live mask; every probe scans it in
               full with the rowmask probe. Counts of base and tail add up,
               and a sorted merge of the two exact top-k candidate sets is
               the fresh scan's top-k, because a row's distance does not
               depend on the buffer it sits in.

  tombstones   deletes clear a per-row live flag (a host numpy array for the
               base, the device mask for the tail). Live rows are a subset
               of their build-time cluster, so the Cauchy-Schwarz bounds
               still hold: all-in clusters add their live count and dead
               rows are never gathered.

  rebuild      when the live tail fraction, the dead-row fraction or the
               worst per-cluster radius inflation (built radius over the
               live rows' extent) crosses its threshold, a background thread
               rebuilds the base over the live rows — warm-started from the
               previous centroids — and swaps it in. The lock is held only
               to snapshot and to swap; probes use the old generation
               meanwhile. Deletes that land mid-rebuild are applied to the
               new base at the swap; inserts that land mid-rebuild stay in
               the new tail. Every launch, the rebuild thread's too, goes on
               the stream that was current when the store was made, so a
               swap never frees a tensor an in-flight probe still reads.

  generations  ``generation`` bumps once per swap, ``version`` once per
               mutation batch and per swap; predicate caches key on
               ``version``.

Sharded mode (``mesh=``, a ``repro_torch.launch.mesh.ProbeMesh``): the base
is a boundary-balanced ``ShardedClusteredStore`` probed through
``make_sharded_pruned_probe`` with per-shard live masks; the tail stays
unsharded (it is small by the rebuild trigger) and is scanned by the
rowmask probe on the store's device. Shards hold equal rows, so a rebuild
keeps ``n_live % n_shards`` remainder rows back in the new tail, and an
incremental rebuild packs clusters back onto the shards that held their
rows.

Row ids are external and stable: the initial rows are ``0..N-1`` and
``insert`` returns fresh ids. Where they live is two numpy arrays indexed by
id (kind, position), not a Python dict of 2^20 entries, and the base rows
stay only on the device. A telemetry hub assigned to ``obs`` reaches the
current base's scan accounting and records every generation swap
(``obs.rebuild``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from repro_torch.core.histogram import (
    make_sharded_pruned_probe,
    mesh_shards,
    shard_blocks,
)
from repro_torch.index.clustered import (
    build_clustered_store,
    center_dists,
    store_tensor,
)
from repro_torch.index.sharded import build_sharded_clustered_store
from repro_torch.kernels.cosine_topk import ops as ct
from repro_torch.kernels.cosine_topk.ref import cosine_distances

f32 = torch.float32
GONE, BASE, TAIL = 0, 1, 2     # where an external id lives

__all__ = ["MutableClusteredStore"]


def _capacity(m: int) -> int:
    return max(64, 1 << max(0, m - 1).bit_length())


class MutableClusteredStore:
    """Streaming-mutable wrapper over the exact cluster-pruned index.

    Attach to ``SemanticHistogram(index=...)`` (with ``mesh=`` the same
    mesh as here, for the sharded base) and every probe routes through
    ``probe`` here — exact under any interleaving of ``insert`` /
    ``delete`` / rebuild.

    Rebuild triggers (checked after every mutation when ``auto_rebuild``):
    live-tail fraction >= ``rebuild_tail_frac``, dead-row fraction >=
    ``rebuild_dead_frac``, or max per-cluster radius inflation >=
    ``rebuild_inflation``. ``incremental=True`` warm-starts the rebuild from
    the previous centroids (``rebuild_iters`` Lloyd refinements instead of
    a cold ``iters``-iteration run, plus the hint-guided shard pack).
    """

    is_mutable = True

    def __init__(self, embeddings, k_clusters: int, *, mesh=None,
                 iters: int = 8, seed: int = 0,
                 split_radius: float | None = None,
                 max_clusters: int | None = None,
                 eps: float = 1e-4, chunk_rows: int = 4096,
                 rebuild_tail_frac: float = 0.25,
                 rebuild_dead_frac: float = 0.25,
                 rebuild_inflation: float = 4.0,
                 incremental: bool = True, rebuild_iters: int = 2,
                 auto_rebuild: bool = True, device=None):
        x = store_tensor(embeddings, device)
        if x.ndim != 2 or not len(x):
            raise ValueError(f"embeddings must be (N, d), got "
                             f"{tuple(x.shape)}")
        self.d = int(x.shape[1])
        self.device = x.device
        self.iters = int(iters)
        self.seed = int(seed)
        self.split_radius = split_radius
        self.eps = float(eps)
        self.chunk_rows = int(chunk_rows)
        self.rebuild_tail_frac = float(rebuild_tail_frac)
        self.rebuild_dead_frac = float(rebuild_dead_frac)
        self.rebuild_inflation = float(rebuild_inflation)
        self.incremental = bool(incremental)
        self.rebuild_iters = int(rebuild_iters)
        self.auto_rebuild = bool(auto_rebuild)
        self._k_clusters = int(k_clusters)
        self._max_clusters = max_clusters
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.mesh = mesh
        self._n_shards = 1
        if mesh is not None:
            self._n_shards = mesh_shards(mesh)
            if len(x) % self._n_shards:
                raise ValueError(
                    f"initial store rows ({len(x)}) must divide the mesh's "
                    f"{self._n_shards} data shards evenly (later "
                    f"generations keep the remainder in the tail "
                    f"automatically)")
            base = build_sharded_clustered_store(
                x, self._k_clusters, self._n_shards, iters=self.iters,
                seed=self.seed, eps=eps, chunk_rows=chunk_rows,
                balance="boundary", split_radius=split_radius,
                max_clusters=max_clusters)
        else:
            base = build_clustered_store(
                x, self._k_clusters, iters=self.iters, seed=self.seed,
                eps=eps, chunk_rows=chunk_rows, split_radius=split_radius,
                max_clusters=max_clusters)

        self._lock = threading.RLock()
        self.version = 0
        self.generation = 0
        self.inserts = 0
        self.deletes = 0
        self.rebuilds = 0
        self.last_rebuild_s: float | None = None
        self.last_rebuild_incremental: bool | None = None
        self._rebuilding = False
        self._rebuild_thread: threading.Thread | None = None
        self._deleted_during_rebuild: set[int] = set()
        self._pre_swap_hook = None        # test hook: runs just before swap
        self._obs = None
        self._next_id = len(x)
        self._loc_kind = np.zeros(len(x), np.int8)
        self._loc_pos = np.zeros(len(x), np.int64)
        self._apply_state(self._prepare_state(base, np.arange(len(x))))
        self._reset_tail(x[:0], np.empty(0, np.int64))

    # -------------------------------------------------- state construction

    def _prepare_state(self, base, ids: np.ndarray) -> dict:
        """Everything derivable from a freshly built base, computed outside
        the lock so the swap only assigns. ``ids`` maps build-input row ->
        external id. A sharded base is a list of segments (sub-index, first
        row), one a shard; an unsharded one is one segment."""
        if self.mesh is not None:
            segments = [(cs, s * base.shard_rows)
                        for s, cs in enumerate(base.shards)]
            placed = shard_blocks(self.mesh, base.embeddings)
        else:
            segments, placed = [(base, 0)], None
        cluster_of, cdist, live_sizes, tight = [], [], [], []
        for cs, _ in segments:
            cl = np.repeat(np.arange(cs.k_clusters), cs.sizes)
            cd = center_dists(cs.embeddings, cs.centroids, cl).cpu().numpy()
            tt = np.zeros(cs.k_clusters)
            full = cs.sizes > 0
            if full.any():
                tt[full] = np.maximum.reduceat(cd, cs.offsets[:-1][full])
            cluster_of.append(cl)
            cdist.append(cd)
            live_sizes.append(cs.sizes.astype(np.int64).copy())
            tight.append(tt)
        return {"base": base, "segments": segments, "placed": placed,
                "base_ids": np.asarray(ids, np.int64)[base.perm],
                "cluster_of": np.concatenate(cluster_of),
                "cdist": np.concatenate(cdist),
                "live_sizes": live_sizes, "tight": tight}

    def _apply_state(self, st: dict) -> None:
        self._base = st["base"]
        # the telemetry hub follows every generation swap
        self._base.obs = self._obs
        self._segments = st["segments"]
        self._placed = st["placed"]
        self._base_ids = st["base_ids"]
        self._live = np.ones(len(self._base_ids), bool)
        self._cluster_of = st["cluster_of"]
        self._cdist = st["cdist"]
        self._live_sizes = st["live_sizes"]
        self._tight = st["tight"]
        self._base_live_n = len(self._base_ids)
        self._loc_kind.fill(GONE)
        self._loc_kind[self._base_ids] = BASE
        self._loc_pos[self._base_ids] = np.arange(len(self._base_ids))

    def _reset_tail(self, emb: torch.Tensor, ids: np.ndarray) -> None:
        m = len(ids)
        cap = _capacity(m)
        self._tail_emb = torch.zeros((cap, self.d), dtype=f32,
                                     device=self.device)
        self._tail_mask = torch.zeros((cap,), dtype=torch.int32,
                                      device=self.device)
        self._tail_live = np.zeros(cap, bool)      # host mirror of the mask
        self._tail_ids = np.zeros(cap, np.int64)
        self._tail_emb[:m] = emb
        self._tail_mask[:m] = 1
        self._tail_live[:m] = True
        self._tail_ids[:m] = ids
        self._tail_len = m
        self._tail_live_n = m
        self._loc_kind[ids] = TAIL
        self._loc_pos[ids] = np.arange(m)

    # ------------------------------------------------------------ mutation

    def insert(self, embeddings) -> np.ndarray:
        """Append rows to the hot tail; returns their external ids."""
        x = store_tensor(embeddings, self.device)
        if x.ndim == 1:
            x = x[None]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (m, {self.d}) rows, got "
                             f"{tuple(x.shape)}")
        m = len(x)
        with self._lock:
            need = self._tail_len + m
            if need > len(self._tail_ids):
                cap = _capacity(need)
                emb = torch.zeros((cap, self.d), dtype=f32, device=self.device)
                mask = torch.zeros((cap,), dtype=torch.int32,
                                   device=self.device)
                emb[:self._tail_len] = self._tail_emb[:self._tail_len]
                mask[:self._tail_len] = self._tail_mask[:self._tail_len]
                self._tail_emb, self._tail_mask = emb, mask
                self._tail_live = np.concatenate(
                    [self._tail_live, np.zeros(cap - len(self._tail_live),
                                               bool)])
                self._tail_ids = np.concatenate(
                    [self._tail_ids, np.zeros(cap - len(self._tail_ids),
                                              np.int64)])
            ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
            self._next_id += m
            if self._next_id > len(self._loc_kind):
                grow = max(self._next_id, 2 * len(self._loc_kind))
                self._loc_kind = np.concatenate(
                    [self._loc_kind, np.zeros(grow - len(self._loc_kind),
                                              np.int8)])
                self._loc_pos = np.concatenate(
                    [self._loc_pos, np.zeros(grow - len(self._loc_pos),
                                             np.int64)])
            p0 = self._tail_len
            self._tail_emb[p0:need] = x
            self._tail_mask[p0:need] = 1
            self._tail_live[p0:need] = True
            self._tail_ids[p0:need] = ids
            self._loc_kind[ids] = TAIL
            self._loc_pos[ids] = np.arange(p0, need)
            self._tail_len = need
            self._tail_live_n += m
            self.inserts += m
            self.version += 1
        if self.auto_rebuild:
            self.maybe_rebuild()
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows by external id. Raises KeyError, and applies
        nothing, when an id is unknown, already deleted or repeated."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._lock:
            known = (ids >= 0) & (ids < self._next_id)
            kind = np.where(known, self._loc_kind[np.where(known, ids, 0)],
                            GONE)
            bad = np.flatnonzero(kind == GONE)
            if len(bad):
                raise KeyError(f"unknown or already-deleted id "
                               f"{int(ids[bad[0]])}")
            if len(np.unique(ids)) != len(ids):
                raise KeyError("an id is repeated in one delete")
            pos = self._loc_pos[ids]
            tail = pos[kind == TAIL]
            if len(tail):
                self._tail_live[tail] = False
                self._tail_mask[torch.as_tensor(tail, device=self.device)] = 0
                self._tail_live_n -= len(tail)
            self._tombstone(pos[kind == BASE])
            self._loc_kind[ids] = GONE
            if self._rebuilding:
                self._deleted_during_rebuild.update(int(i) for i in ids)
            self.deletes += len(ids)
            self.version += 1
        if self.auto_rebuild:
            self.maybe_rebuild()

    def _tombstone(self, pos: np.ndarray) -> None:
        """Kill base rows (lock held): live flags, per-cluster live sizes,
        and each cluster's tight (live-max) radius where a dead row carried
        it — the inflation trigger reads built radius / tight radius."""
        if not len(pos):
            return
        self._live[pos] = False
        self._base_live_n -= len(pos)
        seg = (pos // self._base.shard_rows if len(self._segments) > 1
               else np.zeros(len(pos), np.int64))
        for s in np.unique(seg):
            cs, start = self._segments[s]
            p = pos[seg == s]
            cl = self._cluster_of[p]
            np.subtract.at(self._live_sizes[s], cl, 1)
            tight = self._tight[s]
            carried = self._cdist[p] >= tight[cl] - 1e-12
            for c in np.unique(cl[carried]):
                lo, hi = start + cs.offsets[c], start + cs.offsets[c + 1]
                alive = self._live[lo:hi]
                tight[c] = (float(self._cdist[lo:hi][alive].max())
                            if alive.any() else 0.0)

    # ------------------------------------------------------------- probing

    @property
    def n_live(self) -> int:
        with self._lock:
            return self._base_live_n + self._tail_live_n

    def _snapshot(self):
        """A consistent view for one probe; the lock is held only for the
        copies (the tail mask is cloned on the stream, ahead of any later
        delete's write)."""
        with self._lock:
            n = self._tail_len
            return (self._base, self._placed, self._live.copy(),
                    [ls.copy() for ls in self._live_sizes],
                    self._base_live_n, self._tail_emb[:n],
                    self._tail_mask[:n].clone(), self._tail_live_n)

    def _per_shard_live(self, base, live, ls) -> dict:
        """The sharded base's tombstones, one entry a shard, as
        ``make_sharded_pruned_probe`` and ``probe_compound`` take them."""
        rows = base.shard_rows
        return {"live": [live[s * rows:(s + 1) * rows]
                         for s in range(base.n_shards)],
                "live_sizes": ls, "live_n": [int(x.sum()) for x in ls]}

    def _base_probe(self, base, placed, preds, thr, k, need_topk, live, ls):
        """The base's pruned, live-masked probe: (counts (B, T), top-k)."""
        if self.mesh is None:
            c, t, _ = base.probe_pruned(preds, thr, k=k, need_topk=need_topk,
                                        live=live, live_sizes=ls[0])
            return c, t
        probe = make_sharded_pruned_probe(self.mesh, base, k=k, batched=True,
                                          store=placed)
        return probe(preds, thr, need_topk=need_topk,
                     **self._per_shard_live(base, live, ls))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def probe(self, preds: np.ndarray, thresholds: np.ndarray, *,
              k: int = 1, need_topk: bool = True,
              ) -> tuple[np.ndarray, np.ndarray]:
        """Exact batched probe over the live rows: base (pruned, live-masked)
        + hot tail (rowmask full scan), counts summed, top-k merged.

        preds (B, d); thresholds (B,) or (B, T). Returns (counts (B, T)
        int32, top-k (B, k) float32), bitwise a fresh full scan's."""
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32)
        if thr.ndim == 1:
            thr = thr[:, None]
        b, t = thr.shape
        base, placed, live, ls, base_live_n, temb, tmask, tail_live_n = \
            self._snapshot()
        k = max(1, min(int(k), max(base_live_n + tail_live_n, 1)))
        counts = np.zeros((b, t), np.int64)
        cand = []
        if base_live_n:
            bc, bt = self._base_probe(base, placed, preds, thr, k, need_topk,
                                      live, ls)
            counts += bc
            cand.append(bt)
        if tail_live_n:
            k_t = k if need_topk else 1
            p, th = self._tensor(preds), self._tensor(thr)
            if b == 1:
                tc, tt = ct.cosine_probe_rowmask(temb, tmask, p[0], th[0],
                                                 k=k_t)
                tc, tt = tc[None], tt[None]
            else:
                tc, tt = ct.cosine_probe_batch_rowmask(temb, tmask, p, th,
                                                       k=k_t)
            counts += tc.cpu().numpy()
            cand.append(tt.cpu().numpy())
        topk = np.full((b, k), np.inf, np.float32)
        if need_topk and cand:
            merged = np.sort(np.concatenate(cand, axis=1), axis=1)[:, :k]
            topk[:, :merged.shape[1]] = merged
        return counts.astype(np.int32), topk

    def probe_compound(self, preds: np.ndarray, thresholds: np.ndarray, *,
                       mode: str = "and") -> tuple[int, dict]:
        """Exact compound match count over the live rows: the base's compound
        probe (joint cluster bounds, live-masked) plus a compound rowmask
        scan of the tail."""
        if mode not in ("and", "or"):
            raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
        preds = np.asarray(preds, np.float32)
        thr = np.asarray(thresholds, np.float32).reshape(-1)
        base, _, live, ls, base_live_n, temb, tmask, tail_live_n = \
            self._snapshot()
        count, stats = 0, None
        if base_live_n:
            if self.mesh is None:
                count, stats = base.probe_compound(
                    preds, thr, mode=mode, live=live, live_sizes=ls[0])
            else:
                count, stats = base.probe_compound(
                    preds, thr, mode=mode,
                    **self._per_shard_live(base, live, ls))
        if tail_live_n:
            count += int(ct.cosine_compound_count(
                temb, self._tensor(preds), self._tensor(thr), mode=mode,
                mask=tmask))
        return count, (stats or {"launches": 0, "rows_scanned": 0})

    def kth_smallest(self, pred: np.ndarray, k: int) -> float:
        """Exact k-th smallest distance over the live rows."""
        _, topk = self.probe(np.asarray(pred, np.float32)[None],
                             np.zeros((1, 1), np.float32), k=int(k))
        return float(topk[0, max(1, min(int(k), topk.shape[1])) - 1])

    def count_bounds(self, preds: np.ndarray, thresholds: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Certified count interval over the live rows, zero rows read: the
        base's live-masked bounds plus [0, tail_live] for the tail."""
        with self._lock:
            base = self._base
            ls = [x.copy() for x in self._live_sizes]
            tail_live_n = self._tail_live_n
        lo, hi = base.count_bounds(
            preds, thresholds, live_sizes=ls if self.mesh is not None
            else ls[0])
        return lo, hi + tail_live_n

    def live_rows(self) -> torch.Tensor:
        """The live rows (base in stored order, then tail order), gathered
        on the device — a fresh store to check probes against."""
        with self._lock:
            base_rows = torch.as_tensor(np.flatnonzero(self._live),
                                        device=self.device)
            tail_rows = torch.as_tensor(
                np.flatnonzero(self._tail_live[:self._tail_len]),
                device=self.device)
            return torch.cat([self._base.embeddings.index_select(0, base_rows),
                              self._tail_emb.index_select(0, tail_rows)])

    def distances(self, pred: np.ndarray) -> np.ndarray:
        """Distances of all live rows (``live_rows`` order) — test/debug
        only, like ``SemanticHistogram.distances``."""
        return cosine_distances(self.live_rows(),
                                self._tensor(pred)[None])[0].cpu().numpy()

    # ------------------------------------------------------------- rebuild

    def _due_locked(self) -> bool:
        n_live = self._base_live_n + self._tail_live_n
        if n_live == 0:
            return False
        n_base = len(self._live)
        if self._tail_live_n / n_live >= self.rebuild_tail_frac:
            return True
        if (n_base - self._base_live_n) / max(1, n_base) \
                >= self.rebuild_dead_frac:
            return True
        return self._max_inflation_locked() >= self.rebuild_inflation

    def _max_inflation_locked(self) -> float:
        worst = 1.0
        for (cs, _), sizes, tight in zip(self._segments, self._live_sizes,
                                         self._tight):
            ok = (sizes > 0) & (cs.radii > 1e-9)
            if ok.any():
                worst = max(worst, float(
                    (cs.radii[ok] / np.maximum(tight[ok], 1e-12)).max()))
        return worst

    def _start_thread(self) -> None:
        self._rebuild_thread = threading.Thread(
            target=self._do_rebuild, name="mutable-index-rebuild",
            daemon=True)
        self._rebuild_thread.start()

    def maybe_rebuild(self) -> bool:
        """Start a background rebuild if a trigger fired; False if not due
        or one is already running."""
        with self._lock:
            if self._rebuilding or not self._due_locked():
                return False
            self._rebuilding = True
            self._deleted_during_rebuild = set()
        self._start_thread()
        return True

    def drain_rebuild(self, timeout: float | None = None) -> None:
        """Join any in-flight background rebuild (no-op when idle)."""
        with self._lock:
            t = self._rebuild_thread if self._rebuilding else None
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def rebuild(self, *, wait: bool = True) -> bool:
        """Force a rebuild now, whatever the triggers say; ``wait=False``
        runs it in the background. Returns False if one was already running
        (after joining it when ``wait``)."""
        with self._lock:
            if self._rebuilding:
                t = self._rebuild_thread
            else:
                self._rebuilding = True
                self._deleted_during_rebuild = set()
                t = None
        if t is not None:
            if wait:
                t.join()
            return False
        if wait:
            return self._do_rebuild()
        self._start_thread()
        return True

    def _do_rebuild(self) -> bool:
        """Snapshot the live rows -> build a new base (outside the lock) ->
        swap. Runs on the store's stream, whichever thread calls it. The
        sharded store holds ``n_live % n_shards`` remainder rows back for
        the new tail, so every shard keeps equal rows."""
        t0 = time.perf_counter()
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                with self._lock:
                    base_rows = np.flatnonzero(self._live)
                    snap_len = self._tail_len
                    tpos = np.flatnonzero(self._tail_live[:snap_len])
                    x_new = torch.cat([
                        self._base.embeddings.index_select(
                            0, torch.as_tensor(base_rows, device=self.device)),
                        self._tail_emb.index_select(
                            0, torch.as_tensor(tpos, device=self.device))])
                    ids_new = np.concatenate([self._base_ids[base_rows],
                                              self._tail_ids[tpos]])
                    prev_cent = None
                    if self.incremental:
                        prev_cent = (self._base.global_centroids
                                     if self.mesh is not None
                                     else self._base.centroids)
                    hint = None
                    if self.mesh is not None and self.incremental:
                        # each row's shard in this generation (-1: tail)
                        hint = np.where(
                            self._loc_kind[ids_new] == BASE,
                            self._loc_pos[ids_new] // self._base.shard_rows,
                            -1)
                left_x, left_ids = x_new[:0], ids_new[:0]
                if self.mesh is not None:
                    n_keep = len(x_new) - len(x_new) % self._n_shards
                    if n_keep < self._n_shards:
                        return False     # too few live rows to shard-build
                    left_x, left_ids = x_new[n_keep:].clone(), \
                        ids_new[n_keep:]
                    x_new, ids_new = x_new[:n_keep], ids_new[:n_keep]
                    if hint is not None:
                        hint = hint[:n_keep]
                if not len(x_new):
                    return False
                init_c = (prev_cent if prev_cent is not None
                          and len(prev_cent) <= len(x_new) else None)
                iters = (self.rebuild_iters if init_c is not None
                         else self.iters)
                if self.mesh is not None:
                    rows = len(x_new) // self._n_shards
                    new_base = build_sharded_clustered_store(
                        x_new, max(1, min(self._k_clusters, rows)),
                        self._n_shards, iters=iters, seed=self.seed,
                        eps=self.eps, chunk_rows=self.chunk_rows,
                        balance="boundary", split_radius=self.split_radius,
                        max_clusters=self._max_clusters,
                        init_centroids=init_c, shard_hint=hint)
                else:
                    new_base = build_clustered_store(
                        x_new, max(1, min(self._k_clusters, len(x_new))),
                        iters=iters, seed=self.seed, eps=self.eps,
                        chunk_rows=self.chunk_rows,
                        split_radius=self.split_radius,
                        max_clusters=self._max_clusters,
                        init_centroids=init_c)
                del x_new
                prepared = self._prepare_state(new_base, ids_new)
                hook = self._pre_swap_hook
                if hook is not None:
                    hook()
                with self._lock:
                    self._swap_locked(prepared, snap_len, left_x, left_ids)
                    self.rebuilds += 1
                    self.generation += 1
                    self.version += 1
                    self.last_rebuild_s = time.perf_counter() - t0
                    self.last_rebuild_incremental = init_c is not None
                    obs, gen = self._obs, self.generation
                    rebuild_s = self.last_rebuild_s
                if obs is not None:
                    obs.rebuild(seconds=rebuild_s,
                                incremental=init_c is not None,
                                generation=gen)
            return True
        finally:
            with self._lock:
                self._rebuilding = False
                self._deleted_during_rebuild = set()

    def _swap_locked(self, prepared: dict, snap_len: int,
                     left_x: torch.Tensor, left_ids: np.ndarray) -> None:
        """The generation swap (lock held): install the new base, apply the
        deletes made mid-rebuild as its tombstones, and make the new tail
        of the inserts made mid-rebuild and the sharded build's remainder
        rows (``left_x``, ``left_ids``) not deleted meanwhile."""
        keep = snap_len + np.flatnonzero(
            self._tail_live[snap_len:self._tail_len])
        dead = np.fromiter(self._deleted_during_rebuild, np.int64)
        left = ~np.isin(left_ids, dead)
        tail_x = torch.cat([
            self._tail_emb.index_select(
                0, torch.as_tensor(keep, device=self.device)),
            left_x[torch.as_tensor(left, device=self.device)]])
        tail_ids = np.concatenate([self._tail_ids[keep], left_ids[left]])
        self._apply_state(prepared)
        dead = dead[self._loc_kind[dead] == BASE]
        self._tombstone(self._loc_pos[dead])
        self._loc_kind[dead] = GONE
        self._reset_tail(tail_x, tail_ids)

    # ----------------------------------------------------------- telemetry

    @property
    def obs(self):
        """Telemetry hub; assigning forwards it to the current base index
        (scan accounting lives there), and every generation swap forwards
        it to the new base."""
        return self._obs

    @obs.setter
    def obs(self, hub) -> None:
        with self._lock:
            self._obs = hub
            self._base.obs = hub

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            d = {
                "n_live": self._base_live_n + self._tail_live_n,
                "base_rows": int(len(self._live)),
                "base_live": int(self._base_live_n),
                "base_dead": int(len(self._live) - self._base_live_n),
                "tail_rows": int(self._tail_len),
                "tail_live": int(self._tail_live_n),
                "inserts": self.inserts,
                "deletes": self.deletes,
                "rebuilds": self.rebuilds,
                "generation": self.generation,
                "version": self.version,
                "rebuilding": self._rebuilding,
                "max_inflation": self._max_inflation_locked(),
                "last_rebuild_s": self.last_rebuild_s,
                "last_rebuild_incremental": self.last_rebuild_incremental,
            }
            base = self._base
        d["base_stats"] = base.stats()
        return d

    def reset_stats(self) -> None:
        with self._lock:
            self._base.reset_stats()

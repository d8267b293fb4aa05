"""Serve entry point: the paper's semantic-filter execution engine end-to-end.

``PYTHONPATH=src python -m repro_torch.launch.serve --dataset wildlife``
``... --device cpu --vlm-smoke --n-images 600`` (runs on the host)
``... --index-clusters 16 --compound`` (the cluster-pruned index, and
cascades ordered by conditional selectivity)
``... --concurrency 8`` (the concurrent serve path)
``... --shards 4 --index-clusters 256 --balance-boundary --concurrency 16
--replicas 3`` (sharded probes behind a replicated fleet)

Builds the Semantic-Histogram stack — corpus, the (N, d) store on the
device, the specificity model, the k-means medoid sample the KV-batch
estimator calibrates on — then plans and executes semantic queries one at
a time, printing per-estimator calls and latency, as
``repro.launch.serve``'s sequential path does. The store goes to the device
once; k-means and the histogram share that tensor. Every selectivity goes
through the ``cosine_topk`` probe and the sample through the ``kmeans``
assignment kernel (their plain versions on the CPU).

The KV-batch estimator runs its machinery, as the reference's does: the
build prefills the medoid sample's patch embeddings through the VLM
(``llava-next-8b`` at full width by default; ``--vlm-smoke`` takes its
smoke reduction, for ``--device cpu``), compresses every layer's cache with
Expected Attention and keeps it on the device; the estimator times one
batched prompt decode over those caches. The prefill, the compression and
the decode go through the ``flash_attention``, ``expected_attention`` and
``decode_attention`` kernels. The yes/no answers come from the corpus
oracle, as in the reference.

``--index-clusters K`` builds the cluster-pruned index
(``repro_torch.index.ClusteredStore``) over the device store: probes read
only the boundary clusters, through the masked probe, bitwise the full
scan's answers; ``--split-radius`` splits wide clusters at the build.
``--compound`` orders every plan by conditional selectivity through the
index's compound probe.

``--concurrency N`` switches to the cross-query serving path
(``serve_concurrent``): N planner threads share one
``repro_torch.launch.coalescer.PredicateCoalescer``, whose flusher merges
the predicates of in-flight queries into one probe of exactly the flush's
b predicates (at most ``--max-batch``; with the default 64 a flush of
9–64 takes the probe's wide scan, one store pass; ``--window-ms`` is
accepted and ignored), and hot
predicates resolve from its LRU cache (``--cache-size`` / ``--cache-bits``)
without a launch. ``--passes`` replays the workload; the passes run one
after another, so without ingest every request of pass 2 on is a cache
hit. The control plane: ``--deadline-ms``, ``--max-queue``,
``--degraded-ok`` (certified bound-only answers from the index's
Cauchy-Schwarz bounds, [0, 1] without one) and ``--chaos`` (seeded probe
failures, delays and a flusher kill). ``--ingest-rate R`` streams R
rows/second into the mutable store (``MutableClusteredStore``: hot tail,
tombstones, background rebuilds at ``--rebuild-tail-frac``) while the
workload runs. ``--feedback`` turns on the ensemble's learned write-back
loop.

``--shards S`` shards every probe over a ``ProbeMesh`` of S shards
(``repro_torch.launch.mesh``; on one card all S sit on it, each a view of
the store's s-th row block): each shard is probed by its own launch and
the answers combined, bitwise the unsharded probe. With
``--index-clusters K`` each shard carries its own K-cluster index
(``ShardedClusteredStore``), and ``--balance-boundary`` packs clusters
onto shards by boundary mass instead of taking contiguous row blocks.
``--replicas R`` serves the concurrent path through a fleet
(``repro_torch.launch.fleet.ReplicaSet``): R replicas, each a coalescer
and cache over its own histogram handle on the same store, with
cache-affinity routing, health-checked failover (``--heartbeat-ms``),
hedged requests (``--hedge-ms``) and the replica-scoped ``--chaos`` keys;
every exact answer is bitwise a single replica's.

Telemetry: every run records into one ``repro_torch.obs`` registry; the
exit summary is rendered from its snapshot (the reference's schema),
``--metrics-json`` writes that snapshot and ``--trace-out`` (with
``--trace-sample N``) streams JSONL trace spans.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs.paper_stack import SpecificityModelConfig
from repro_torch.core.estimators import (
    EnsembleEstimator,
    KVBatchEstimator,
    OracleEstimator,
    SamplingEstimator,
    SpecificityEstimator,
)
from repro_torch.core.histogram import SemanticHistogram
from repro_torch.core.kvbatch import build_compressed_store
from repro_torch.core.optimizer import (
    ExecutionResult,
    execute_cascade,
    generate_queries,
    plan_query,
)
from repro_torch.core.specificity import train_specificity
from repro_torch.core.synthetic import make_corpus, specificity_dataset
from repro_torch.device import resolve_device
from repro_torch.index.clustered import build_clustered_store
from repro_torch.index.mutable import MutableClusteredStore
from repro_torch.kernels import _build
from repro_torch.kernels.cosine_topk import kernel as probe_kernel
from repro_torch.kernels.kmeans.ops import medoid_sample
from repro_torch.index.sharded import build_sharded_clustered_store
from repro_torch.launch.chaos import (
    ChaosConfig,
    ChaosInjector,
    FleetChaos,
    FleetChaosConfig,
)
from repro_torch.launch.coalescer import (
    CoalescerConfig,
    PredicateCache,
    PredicateCoalescer,
)
from repro_torch.launch.fleet import FLEET_BUCKETS, FleetConfig, ReplicaSet
from repro_torch.launch.mesh import make_probe_mesh
from repro_torch.obs import ObsHub, Tracer
from repro_torch.obs import report as obs_report

# share of the 2880 patch positions Expected Attention drops from every
# layer's cache: the reference's build_stack passes 0.6 (1152 kept)
COMPRESSION_RATE = 0.6


def build_stack(dataset: str, *, n_images: int = 1000, sample: int = 32,
                spec_steps: int = 600, seed: int = 0,
                device=None, vlm_smoke: bool = False,
                index_clusters: int = 0, shards: int = 0,
                split_radius: float = 0.0, balance_boundary: bool = False,
                ingest: bool = False, rebuild_tail_frac: float = 0.25,
                timings: dict | None = None):
    """(corpus, {name: estimator}) for one dataset preset, on ``device``.

    ``vlm_smoke`` builds the KV-batch store on the smoke reduction of
    ``llava-next-8b`` instead of its full width. ``index_clusters`` > 0
    puts the cluster-pruned index behind the histogram (``split_radius``
    tunes its build); with ``ingest`` it is the mutable store instead.
    ``shards`` > 0 shards every probe over a mesh of that many shards on
    ``device`` (the index then is K clusters a shard; ``balance_boundary``
    packs them by boundary mass). ``timings``, when given, receives the
    host seconds of each build phase."""
    if balance_boundary and (shards <= 0 or index_clusters <= 0):
        raise ValueError("--balance-boundary repartitions the sharded "
                         "pruned index — it needs --shards and "
                         "--index-clusters")
    if split_radius > 0 and index_clusters <= 0:
        raise ValueError("--split-radius tunes the pruned-index build — "
                         "it needs --index-clusters")
    if ingest and index_clusters <= 0:
        raise ValueError("ingest streams into the mutable cluster index — "
                         "it needs --index-clusters")
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    corpus = make_corpus(dataset, n_images=n_images, seed=seed)
    timings["corpus_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = torch.from_numpy(corpus.images).to(dev)     # the one device copy
    timings["store_s"] = time.perf_counter() - t0

    mesh = None
    if shards > 0:
        # the card by default: shards dealt round-robin over the visible
        # CUDA devices (all on cuda:0 on a single card)
        mesh = make_probe_mesh(shards,
                               device=None if device is None else dev)
        print(f"mesh: {shards} probe shard(s) on "
              f"{sorted({str(d) for d in mesh.devices})}, "
              f"{corpus.images.shape[0] // shards} rows each")
    index = None
    sr = split_radius if split_radius > 0 else None
    if index_clusters > 0:
        t0 = time.perf_counter()
        if ingest:
            index = MutableClusteredStore(
                store, index_clusters, mesh=mesh, seed=seed,
                split_radius=sr, rebuild_tail_frac=rebuild_tail_frac)
            print(f"index: mutable, {index_clusters} clusters over "
                  f"{index.n_live} rows"
                  + (f", {shards} shards" if mesh is not None else "")
                  + f", rebuild_tail_frac={rebuild_tail_frac}")
        elif mesh is not None:
            index = build_sharded_clustered_store(
                store, index_clusters, shards, seed=seed,
                balance="boundary" if balance_boundary else "contiguous",
                split_radius=sr)
            print(f"index: {index.n_shards} shards x ~{index.k_clusters} "
                  f"clusters over {index.n} rows ({index.balance} partition"
                  f"{f', split_radius={split_radius}' if sr else ''})")
            mass = index.boundary_mass()
            if index.contiguous_mass is not None:
                cm = index.contiguous_mass
                print(f"boundary mass/shard: contiguous "
                      f"[{', '.join(f'{m:.0f}' for m in cm)}] "
                      f"(spread {cm.max() - cm.min():.0f}) -> balanced "
                      f"[{', '.join(f'{m:.0f}' for m in mass)}] "
                      f"(spread {mass.max() - mass.min():.0f})")
            else:
                print(f"boundary mass/shard: "
                      f"[{', '.join(f'{m:.0f}' for m in mass)}] "
                      f"(spread {mass.max() - mass.min():.0f}; "
                      f"--balance-boundary repartitions to even it out)")
        else:
            index = build_clustered_store(store, index_clusters, seed=seed,
                                          split_radius=sr)
            print(f"index: {index.k_clusters} clusters over {index.n} rows "
                  f"(radii p50={float(np.median(index.radii)):.3f}"
                  f"{f', split_radius={split_radius}' if sr else ''})")
        timings["index_s"] = time.perf_counter() - t0
    hist = SemanticHistogram(store, mesh=mesh, index=index)

    t0 = time.perf_counter()
    X, y = specificity_dataset(corpus, n_samples=2000, seed=seed)
    model, _ = train_specificity(
        X, y, SpecificityModelConfig(embed_dim=corpus.dim, steps=spec_steps),
        device=dev)
    timings["specificity_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ids = medoid_sample(store, sample, iters=5, seed=seed)
    timings["kmeans_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    kvstore = build_compressed_store(corpus.images, ids, smoke=vlm_smoke,
                                     rate=COMPRESSION_RATE, seed=seed,
                                     device=dev)
    timings["kvstore_s"] = time.perf_counter() - t0

    spec = SpecificityEstimator(corpus, hist, model)
    kvb = KVBatchEstimator(corpus, hist, kvstore)
    return corpus, {
        "specificity": spec,
        "kvbatch": kvb,
        "ensemble": EnsembleEstimator(spec, kvb),
        "sampling-16": SamplingEstimator(corpus, 16),
        "oracle": OracleEstimator(corpus),
    }


def serve_sequential(corpus, estimators, queries, *, seed: int,
                     obs: ObsHub | None = None, compound: bool = False,
                     feedback: bool = False,
                     ) -> dict[str, list[ExecutionResult]]:
    """Every estimator, one query at a time; returns each estimator's
    execution results (plans included) in query order. ``compound`` orders
    multi-filter plans by conditional selectivity (estimators exposing
    ``compound_selectivity``); ``obs`` records each plan's q-error;
    ``feedback`` turns on the ensemble's learned write-back loop with a
    dedicated observed-selectivity cache."""
    oracle = estimators["oracle"]
    if feedback:
        ens = estimators.get("ensemble")
        if ens is not None and ens.observed_cache is None:
            ens.feedback = True
            ens.observed_cache = PredicateCache(1024)
    results: dict[str, list[ExecutionResult]] = {
        name: [] for name in estimators}
    for qi, q in enumerate(queries):
        base = execute_cascade(corpus, plan_query(q, oracle), seed=seed)
        results["oracle"].append(base)
        print(f"\nquery {qi}: filters={q}  oracle calls={base.vlm_calls}")
        for name, est in estimators.items():
            if name == "oracle":
                continue
            fb = est if (feedback and hasattr(est, "observe")) else None
            res = execute_cascade(
                corpus, plan_query(q, est, seed=seed, compound=compound),
                seed=seed, obs=obs, est_name=name, feedback=fb)
            results[name].append(res)
            overhead = res.total_s - base.total_s
            print(f"  {name:14s} calls={res.vlm_calls:5d} "
                  f"est_lat={res.plan.est_latency_s*1e3:8.1f}ms "
                  f"overhead={overhead:+8.2f}s  |result|={len(res.result_ids)}")
    return results


@dataclasses.dataclass
class ConcurrentRun:
    """What ``serve_concurrent`` returns."""

    stats: dict             # PredicateCoalescer.stats() after the last pass
    #                         (ReplicaSet.stats() with a fleet: it carries
    #                         a ``replicas`` list)
    passes: list[dict]      # per pass: each counter's increase over it
    results: list           # per job, workload order: (pass, query index,
    #                         ExecutionResult, or None for a failed plan)
    failures: list          # (query index, "Error: message")
    cache: PredicateCache   # the coalescer's cache (and observed store;
    #                         with a fleet only the observed store)
    wall_s: float


def serve_concurrent(corpus, estimators, queries, *, est_name: str,
                     seed: int, concurrency: int, window_ms: float,
                     max_batch: int, cache_size: int, cache_bits: int,
                     passes: int, deadline_ms: float = 0.0,
                     max_queue: int = 0, degraded_ok: bool = False,
                     chaos_spec: str = "", ingest_rate: float = 0.0,
                     obs: ObsHub | None = None, compound: bool = False,
                     feedback: bool = False, replicas: int = 1,
                     hedge_ms: float = 0.0,
                     heartbeat_ms: float = 50.0) -> ConcurrentRun:
    """Cross-query serving: N planner threads share one coalescer + cache.

    The control plane rides along per request: each plan's probes carry the
    deadline, the coalescer sheds past ``max_queue``, and ``degraded_ok``
    turns overload/fault resolutions into certified bound-only answers. A
    failing query is a *partial* failure — its worker records the error and
    the rest of the workload proceeds. ``obs`` collects counters / latency
    histograms / q-error accounting / trace spans; the caller renders the
    exit summary from its registry.

    The passes run one after another, each over a pool of ``concurrency``
    threads, so every predicate pass 1 probed is cached before pass 2
    starts (the reference's one pool interleaves the passes' ends). With
    ``ingest_rate`` a thread streams rows into the mutable store meanwhile;
    the cache keys on the store's version, so nothing stale is served.

    On the card, the probe's library is loaded and the KV-batch machinery's
    one timed decode runs before the workers start: neither the ``nvcc``
    build of a first launch nor that decode counts against a plan's
    deadline or the flush-latency watchdog. A build error raises here.

    ``replicas > 1`` serves through a ``repro_torch.launch.fleet``
    ``ReplicaSet`` instead of one coalescer: R replicas, each a histogram
    handle on the same store and index (and mesh), predicates routed by
    cache affinity with health-checked failover, hedged duplicates
    (``hedge_ms``), a heartbeat monitor (``heartbeat_ms``) and the
    replica-scoped chaos keys in ``chaos_spec`` (``replica-kill=R@N``,
    ``replica-slow=R@N:MS``, ``partition=R@A-B``)."""
    est = estimators[est_name]
    hist = est.hist
    obs = obs if obs is not None else ObsHub()
    cache = PredicateCache(cache_size, bits=cache_bits)
    if feedback and hasattr(est, "observe"):
        # the serving predicate cache doubles as the observed-selectivity
        # store: same quantization, same LRU discipline, version-keyed
        est.feedback = True
        est.observed_cache = cache
    chaos = fleet_chaos = None
    if chaos_spec and replicas > 1:
        fleet_chaos = FleetChaos(FleetChaosConfig.parse(chaos_spec), obs=obs)
    elif chaos_spec:
        chaos = ChaosInjector(ChaosConfig.parse(chaos_spec), obs=obs)
    if hist.device.type == "cuda":
        _build.load(probe_kernel.NAME)
    machinery = getattr(getattr(est, "kvb", est), "_machinery_latency", None)
    if machinery is not None:
        machinery()
    workload = [[(p, qi, q) for qi, q in enumerate(queries)]
                for p in range(passes)]
    n_preds = passes * sum(len(q) for q in queries)
    print(f"\nconcurrent serve: {passes * len(queries)} queries "
          f"({len(queries)} x {passes} passes), {n_preds} predicate "
          f"requests, estimator={est_name}, threads={concurrency}, "
          f"max_batch={max_batch}, "
          f"cache={cache_size}x{cache_bits}bit"
          + (f", replicas={replicas}" if replicas > 1 else "")
          + (f", hedge={hedge_ms}ms" if hedge_ms else "")
          + (f", deadline={deadline_ms}ms" if deadline_ms else "")
          + (f", max_queue={max_queue}" if max_queue else "")
          + (", degraded-ok" if degraded_ok else "")
          + (f", chaos[{chaos_spec}]" if chaos_spec else "")
          + (f", ingest={ingest_rate}/s" if ingest_rate else ""))

    index = hist.index
    stop_ingest = threading.Event()
    ingest_thread = None
    if ingest_rate > 0:
        if index is None or not getattr(index, "is_mutable", False):
            raise ValueError("--ingest-rate needs the mutable index "
                             "(build the stack with ingest=True)")

        def ingest_loop():
            rng = np.random.default_rng(seed + 0x1735)
            period = 1.0 / ingest_rate
            mine: list[int] = []
            while not stop_ingest.is_set():
                x = rng.normal(size=(1, corpus.dim)).astype(np.float32)
                x /= np.linalg.norm(x)
                mine.extend(int(i) for i in index.insert(x))
                # ~30% churn: retire an earlier streamed row now and then
                if len(mine) >= 8 and rng.random() < 0.3:
                    index.delete([mine.pop(int(rng.integers(len(mine))))])
                stop_ingest.wait(period)

        ingest_thread = threading.Thread(target=ingest_loop,
                                         name="serve-ingest", daemon=True)
        ingest_thread.start()

    ccfg = CoalescerConfig(max_batch=max_batch, window_ms=window_ms,
                           cache_capacity=cache_size,
                           cache_bits=cache_bits, max_queue=max_queue)
    if replicas > 1:
        # every replica gets its own histogram handle over the same store,
        # index and mesh: bitwise the same probes, one copy of the data
        hists = [hist] + [
            SemanticHistogram(hist.embeddings, mesh=hist.mesh,
                              index=hist.index)
            for _ in range(replicas - 1)]
        serving = ReplicaSet(
            hists, ccfg,
            fleet=FleetConfig(replicas=replicas, hedge_ms=hedge_ms,
                              heartbeat_ms=heartbeat_ms,
                              max_replica_queue=max_queue),
            chaos=fleet_chaos, obs=obs)
        counters = ("requests",) + FLEET_BUCKETS
    else:
        serving = PredicateCoalescer(hist, ccfg, cache=cache, chaos=chaos,
                                     obs=obs)
        counters = PredicateCoalescer._COUNTERS
    failures: list[tuple[int, str]] = []
    results: list = []
    per_pass: list[dict] = []
    with serving as coal:

        def run_one(job):
            p, qi, q = job
            t_q = time.perf_counter()
            try:
                plan = plan_query(q, est, seed=seed, coalescer=coal,
                                  deadline_ms=deadline_ms or None,
                                  degraded_ok=degraded_ok,
                                  compound=compound)
            except Exception as e:  # noqa: BLE001 — partial failure
                failures.append((qi, f"{type(e).__name__}: {e}"))
                return p, qi, None
            fb = est if (feedback and hasattr(est, "observe")) else None
            res = execute_cascade(corpus, plan, seed=seed, obs=obs,
                                  est_name=est_name, feedback=fb)
            tr = obs.tracer
            if tr is not None and tr.sample_hit("plan"):
                tr.emit("plan", query=int(qi), estimator=est_name,
                        degraded=bool(plan.degraded),
                        est_ms=round(plan.est_latency_s * 1e3, 3),
                        wall_ms=round((time.perf_counter() - t_q) * 1e3,
                                      3),
                        vlm_calls=int(res.vlm_calls))
            return p, qi, res

        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(max_workers=concurrency) as pool:
                for jobs in workload:
                    before = coal.stats()
                    results.extend(pool.map(run_one, jobs))
                    after = coal.stats()
                    per_pass.append({name: after[name] - before[name]
                                     for name in counters})
            wall_s = time.perf_counter() - t0
        finally:
            if ingest_thread is not None:
                stop_ingest.set()
                ingest_thread.join(timeout=10.0)
                index.drain_rebuild(timeout=120.0)
        stats = coal.stats()

    degraded_plans = sum(1 for _, _, r in results
                         if r is not None and r.plan.degraded)
    oracle = estimators["oracle"]
    for _, qi, res in results[:len(queries)]:
        if res is None:
            print(f"  query {qi}: FAILED")
            continue
        base = execute_cascade(corpus, plan_query(queries[qi], oracle),
                               seed=seed)
        print(f"  query {qi}: calls={res.vlm_calls:5d} "
              f"(oracle {base.vlm_calls}) |result|={len(res.result_ids)}")

    # Everything the run learned goes through the registry: the exit
    # summary (obs.report.render) and --metrics-json are both views of
    # the same snapshot.
    reg = obs.registry
    n_jobs = passes * len(queries)
    reg.counter("serve.queries").inc(n_jobs)
    reg.counter("serve.degraded_plans").inc(degraded_plans)
    reg.counter("serve.failed_queries").inc(len(failures))
    reg.gauge("serve.wall_s").set(wall_s)
    reg.gauge("serve.qps").set(n_jobs / wall_s if wall_s else 0.0)
    if failures:
        print(f"  first failure: {failures[0][1]}")
    return ConcurrentRun(stats=stats, passes=per_pass, results=results,
                         failures=failures, cache=cache, wall_s=wall_s)


def coalescer_totals(stats: dict) -> dict:
    """What the coalescers resolved: a coalescer's stats as they are, a
    fleet's (``ReplicaSet.stats()``) with its replicas' coalescer counters
    summed — the trace summary's totals, which count every dispatch a
    replica took (failed-over and hedged ones too)."""
    if "replicas" not in stats:
        return stats
    return {name: sum(r["coalescer"][name] for r in stats["replicas"])
            for name in PredicateCoalescer._COUNTERS}


def main(argv=None):
    """The CLI; returns ``serve_sequential``'s results, or with
    ``--concurrency`` > 1 ``serve_concurrent``'s run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wildlife",
                    choices=["wildlife", "artwork", "ecommerce"])
    ap.add_argument("--filters", type=int, default=3)
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-images", type=int, default=1000,
                    help="corpus size (rows in the embedding store)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    ap.add_argument("--vlm-smoke", action="store_true",
                    help="build the KV-batch store on the smoke reduction "
                         "of llava-next-8b (full width is for the card)")
    ap.add_argument("--index-clusters", type=int, default=0,
                    help=">0: build a cluster-pruned probe index with this "
                         "many k-means clusters (exact counts, a fraction "
                         "of the rows read at low selectivity); with "
                         "--shards, K clusters per shard")
    ap.add_argument("--shards", type=int, default=0,
                    help=">0: shard every probe over this many shards "
                         "(a ('data',) probe mesh dealt round-robin over "
                         "the visible cards; on one card every shard is a "
                         "view of its row block). Composes with "
                         "--index-clusters: per-shard pruned probes, "
                         "per-shard scan counters at exit")
    ap.add_argument("--split-radius", type=float, default=0.0,
                    help=">0: split clusters wider than this at index build")
    ap.add_argument("--balance-boundary", action="store_true",
                    help="with --shards + --index-clusters: cluster "
                         "globally and pack clusters onto shards by "
                         "boundary mass (size x radius, min-max LPT under "
                         "equal rows/shard) instead of taking contiguous "
                         "row blocks — evens the max per-shard boundary "
                         "rows every probe pays; prints the before/after "
                         "per-shard mass spread")
    ap.add_argument("--rebuild-tail-frac", type=float, default=0.25,
                    help="mutable store: rebuild the index once the "
                         "unindexed hot tail holds this share of the rows")
    ap.add_argument("--compound", action="store_true",
                    help="order cascades by conditional (joint-prefix) "
                         "selectivity through the index's compound probe")
    ap.add_argument("--concurrency", type=int, default=1,
                    help=">1: plan queries from this many threads through "
                         "a shared predicate coalescer + LRU cache")
    ap.add_argument("--estimator", default="ensemble",
                    choices=["specificity", "kvbatch", "ensemble"],
                    help="estimator for the concurrent path")
    ap.add_argument("--window-ms", type=float, default=4.0,
                    help="accepted and ignored: the coalescer holds no "
                         "window, a flush takes what pends")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="the most pending predicates one flush probes")
    ap.add_argument("--cache-size", type=int, default=1024,
                    help="LRU predicate-cache capacity (entries)")
    ap.add_argument("--cache-bits", type=int, default=12,
                    help="embedding quantization bits for cache keys")
    ap.add_argument("--passes", type=int, default=2,
                    help="replay the query workload this many times, one "
                         "pass after another (hot repeated predicates)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help=">0: wall deadline per plan's probes; past it the "
                         "request degrades to a certified bound-only "
                         "answer (--degraded-ok) or fails, never hangs")
    ap.add_argument("--max-queue", type=int, default=0,
                    help=">0: admission control — shed new predicates once "
                         "this many are pending (bound-only answer with "
                         "--degraded-ok, ShedError without)")
    ap.add_argument("--degraded-ok", action="store_true",
                    help="resolve shed/late/breaker-blocked requests with "
                         "certified selectivity bounds (cluster-index "
                         "Cauchy-Schwarz interval; [0,1] without an index) "
                         "instead of raising; plans are marked degraded")
    ap.add_argument("--ingest-rate", type=float, default=0.0,
                    help=">0: stream this many rows/second into the store "
                         "while the concurrent workload runs — switches "
                         "--index-clusters to the mutable store; needs "
                         "--concurrency > 1")
    ap.add_argument("--chaos", default="",
                    help="deterministic fault injection on the probe path, "
                         "e.g. 'seed=1,fail=0.3,delay=0.2,delay-ms=5,"
                         "kill-at=3' — seeded probe failures/delays and a "
                         "flusher kill at the given launch ordinal; with "
                         "--replicas also replica-scoped faults keyed by "
                         "fleet dispatch ordinal: 'replica-kill=1@6', "
                         "'replica-slow=2@3:25', 'partition=0@4-9'")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1: serve through a replicated fleet — this many "
                         "independent replicas (own coalescer, predicate "
                         "cache, breaker) over the same store build, with "
                         "cache-affinity consistent-hash routing and "
                         "health-checked ring-successor failover; needs "
                         "--concurrency > 1")
    ap.add_argument("--hedge-ms", type=float, default=0.0,
                    help=">0 with --replicas: fire a hedged duplicate at "
                         "the key's next healthy replica when a dispatch "
                         "hasn't landed within this budget; first "
                         "completion wins, the loser is accounted "
                         "hedge_cancelled")
    ap.add_argument("--heartbeat-ms", type=float, default=50.0,
                    help="fleet health monitor period: replicas missing "
                         "beats for 5x this are routed around until they "
                         "recover (0 disables the monitor)")
    ap.add_argument("--feedback", action="store_true",
                    help="Larch-style learned loop: after each executed "
                         "plan, write observed per-filter and per-prefix "
                         "selectivities back into the ensemble's "
                         "correction and the version-keyed "
                         "observed-selectivity cache")
    ap.add_argument("--metrics-json", default="",
                    help="write the exit metrics snapshot (counters, "
                         "latency/q-error histograms, reconciliation) to "
                         "this path as schema-versioned JSON")
    ap.add_argument("--trace-out", default="",
                    help="write sampled per-request trace spans (submit/"
                         "flush/scan/plan/event + a closing summary) to "
                         "this path as JSONL")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="trace 1-in-N requests per span kind (1 = every "
                         "request)")
    args = ap.parse_args(argv)

    if args.ingest_rate > 0 and args.concurrency <= 1:
        ap.error("--ingest-rate streams during the concurrent serve "
                 "path — it needs --concurrency > 1")
    if args.replicas > 1 and args.concurrency <= 1:
        ap.error("--replicas serves through the concurrent path — it "
                 "needs --concurrency > 1")
    dev = resolve_device(args.device)
    tracer = (Tracer(args.trace_out, sample=args.trace_sample)
              if args.trace_out else None)
    hub = ObsHub(tracer=tracer)
    print(f"building semantic-histogram stack for '{args.dataset}' "
          f"on {dev}...")
    corpus, estimators = build_stack(
        args.dataset, seed=args.seed, n_images=args.n_images,
        device=args.device,
        vlm_smoke=args.vlm_smoke, index_clusters=args.index_clusters,
        shards=args.shards, split_radius=args.split_radius,
        balance_boundary=args.balance_boundary,
        ingest=args.ingest_rate > 0,
        rebuild_tail_frac=args.rebuild_tail_frac)
    index = estimators["specificity"].hist.index
    if index is not None:
        index.obs = hub
    queries = generate_queries(corpus, n_queries=args.queries,
                               n_filters=args.filters, seed=args.seed)
    stats = None
    if args.concurrency > 1:
        out = serve_concurrent(
            corpus, estimators, queries, est_name=args.estimator,
            seed=args.seed, concurrency=args.concurrency,
            window_ms=args.window_ms, max_batch=args.max_batch,
            cache_size=args.cache_size, cache_bits=args.cache_bits,
            passes=args.passes, deadline_ms=args.deadline_ms,
            max_queue=args.max_queue, degraded_ok=args.degraded_ok,
            chaos_spec=args.chaos, ingest_rate=args.ingest_rate,
            obs=hub, compound=args.compound, feedback=args.feedback,
            replicas=args.replicas, hedge_ms=args.hedge_ms,
            heartbeat_ms=args.heartbeat_ms)
        stats = out.stats
    else:
        out = serve_sequential(corpus, estimators, queries, seed=args.seed,
                               obs=hub, compound=args.compound,
                               feedback=args.feedback)
    is_fleet = stats is not None and "replicas" in stats
    snap = obs_report.build_snapshot(
        registry=hub.registry,
        coalescer=None if is_fleet else stats,
        fleet=stats if is_fleet else None,
        index=index.stats() if index is not None else None,
        mutable=bool(getattr(index, "is_mutable", False)))
    print()
    print(obs_report.render(snap))
    if is_fleet:
        # the fleet invariant is load-bearing: a serve run that fails to
        # reconcile its counters must not exit 0
        fl = snap["fleet"]
        if not (fl["reconciles"]
                and all(r["reconciles"] for r in fl["replicas"])):
            raise SystemExit(
                "fleet counters do not reconcile (requests != sum of "
                "resolution buckets) — see the fleet block above")
    if args.metrics_json:
        obs_report.write_json(snap, args.metrics_json)
        print(f"metrics snapshot -> {args.metrics_json}")
    if tracer is not None:
        if stats is not None:
            hub.write_trace_summary(coalescer_totals(stats))
        tracer.close()
        print(f"trace spans -> {args.trace_out} "
              f"({tracer.emitted} records, sample=1/{args.trace_sample})")
    return out


if __name__ == "__main__":
    main()

"""Serve entry point: the paper's semantic-filter execution engine end-to-end.

``PYTHONPATH=src python -m repro_torch.launch.serve --dataset wildlife``
``... --device cpu --vlm-smoke --n-images 600`` (runs on the host)
``... --index-clusters 16 --compound`` (the cluster-pruned index, and
cascades ordered by conditional selectivity)

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
``build_stack(ingest=True)`` builds the mutable store
(``MutableClusteredStore``: hot tail, tombstones, background rebuilds at
``--rebuild-tail-frac``) instead. ``--compound`` orders every plan by
conditional selectivity through the index's compound probe. The ingest
loop (``--ingest-rate``) belongs to ``serve_concurrent``, ROADMAP §1 item 10.
"""

from __future__ import annotations

import argparse
import time

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
from repro_torch.kernels.kmeans.ops import medoid_sample

# share of the 2880 patch positions Expected Attention drops from every
# layer's cache: the reference's build_stack passes 0.6 (1152 kept)
COMPRESSION_RATE = 0.6


def build_stack(dataset: str, *, n_images: int = 1000, sample: int = 32,
                spec_steps: int = 600, seed: int = 0,
                device=None, vlm_smoke: bool = False,
                index_clusters: int = 0, split_radius: float = 0.0,
                ingest: bool = False, rebuild_tail_frac: float = 0.25,
                timings: dict | None = None):
    """(corpus, {name: estimator}) for one dataset preset, on ``device``.

    ``vlm_smoke`` builds the KV-batch store on the smoke reduction of
    ``llava-next-8b`` instead of its full width. ``index_clusters`` > 0
    puts the cluster-pruned index behind the histogram (``split_radius``
    tunes its build); with ``ingest`` it is the mutable store instead.
    ``timings``, when given, receives the host seconds of each build
    phase."""
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

    index = None
    sr = split_radius if split_radius > 0 else None
    if index_clusters > 0:
        t0 = time.perf_counter()
        if ingest:
            index = MutableClusteredStore(
                store, index_clusters, seed=seed, split_radius=sr,
                rebuild_tail_frac=rebuild_tail_frac)
            print(f"index: mutable, {index_clusters} clusters over "
                  f"{index.n_live} rows, rebuild_tail_frac="
                  f"{rebuild_tail_frac}")
        else:
            index = build_clustered_store(store, index_clusters, seed=seed,
                                          split_radius=sr)
            print(f"index: {index.k_clusters} clusters over {index.n} rows "
                  f"(radii p50={float(np.median(index.radii)):.3f}"
                  f"{f', split_radius={split_radius}' if sr else ''})")
        timings["index_s"] = time.perf_counter() - t0
    hist = SemanticHistogram(store, index=index)

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
                     compound: bool = False,
                     ) -> dict[str, list[ExecutionResult]]:
    """Every estimator, one query at a time; returns each estimator's
    execution results (plans included) in query order. ``compound`` orders
    multi-filter plans by conditional selectivity (estimators exposing
    ``compound_selectivity``)."""
    oracle = estimators["oracle"]
    results: dict[str, list[ExecutionResult]] = {
        name: [] for name in estimators}
    for qi, q in enumerate(queries):
        base = execute_cascade(corpus, plan_query(q, oracle), seed=seed)
        results["oracle"].append(base)
        print(f"\nquery {qi}: filters={q}  oracle calls={base.vlm_calls}")
        for name, est in estimators.items():
            if name == "oracle":
                continue
            res = execute_cascade(
                corpus, plan_query(q, est, seed=seed, compound=compound),
                seed=seed)
            results[name].append(res)
            overhead = res.total_s - base.total_s
            print(f"  {name:14s} calls={res.vlm_calls:5d} "
                  f"est_lat={res.plan.est_latency_s*1e3:8.1f}ms "
                  f"overhead={overhead:+8.2f}s  |result|={len(res.result_ids)}")
    return results


def main(argv=None) -> dict[str, list[ExecutionResult]]:
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
                         "of the rows read at low selectivity)")
    ap.add_argument("--split-radius", type=float, default=0.0,
                    help=">0: split clusters wider than this at index build")
    ap.add_argument("--rebuild-tail-frac", type=float, default=0.25,
                    help="mutable store: rebuild the index once the "
                         "unindexed hot tail holds this share of the rows")
    ap.add_argument("--compound", action="store_true",
                    help="order cascades by conditional (joint-prefix) "
                         "selectivity through the index's compound probe")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"building semantic-histogram stack for '{args.dataset}' "
          f"on {dev}...")
    corpus, estimators = build_stack(
        args.dataset, seed=args.seed, n_images=args.n_images, device=dev,
        vlm_smoke=args.vlm_smoke, index_clusters=args.index_clusters,
        split_radius=args.split_radius,
        rebuild_tail_frac=args.rebuild_tail_frac)
    queries = generate_queries(corpus, n_queries=args.queries,
                               n_filters=args.filters, seed=args.seed)
    results = serve_sequential(corpus, estimators, queries, seed=args.seed,
                               compound=args.compound)
    index = estimators["specificity"].hist.index
    if index is not None:
        st = index.stats()
        print(f"\nindex: {st['probes']} probes, {st['launches']} launches, "
              f"scan fraction {st['scan_fraction']:.4f}")
    return results


if __name__ == "__main__":
    main()

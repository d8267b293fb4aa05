"""The system under test, assembled from the port's public parts around
the benchmark's inputs, and the thin wrappers that record the calls into
its layers.

``build`` hands the program the corpus the benchmark drew (the device store
and one host copy as the port's ``Corpus``), the specificity MLP's weights
the benchmark trained and the KV-batch sample it drew, then lets the port
build the rest itself: the cluster-pruned index where the configuration
asks for one, the KV-batch machinery's compressed caches, the three
estimators and the coalescer.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.configs.paper_stack import SpecificityModelConfig
from repro_torch.core.estimators import (
    EnsembleEstimator,
    KVBatchEstimator,
    SpecificityEstimator,
)
from repro_torch.core.histogram import SemanticHistogram
from repro_torch.core.kvbatch import build_compressed_store
from repro_torch.core.optimizer import plan_query
from repro_torch.core.specificity import specificity_model_from_numpy
from repro_torch.core.synthetic import Concept, Corpus
from repro_torch.index.clustered import build_clustered_store
from repro_torch.launch.coalescer import CoalescerConfig, PredicateCoalescer
from repro_torch.obs import ObsHub

from semhist_bench.corpus import Tree, rng_for, torch_seed

_local = threading.local()


def current():
    """The request record of the calling thread, or None."""
    return getattr(_local, "rec", None)


class Spans:
    """Host-clock intervals of the probes the histogram ran, kept in
    memory (a request's own spans live on its ``Request``)."""

    def __init__(self):
        self.launches: list[tuple[float, float, int]] = []   # (t0, t1, B)
        self._lock = threading.Lock()


class SpecModelRecorder:
    """Stands in for the port's ``SpecificityModel``: delegates, and keeps
    the MLP's thresholds on the calling request's record."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def thresholds(self, embs):
        out = self._model.thresholds(embs)
        rec = current()
        if rec is not None:
            rec.spec.append(np.asarray(out, np.float64).copy())
        return out


class CoalescerSpan:
    """Passed to ``plan_query`` as ``coalescer=``: times the planner's calls
    into the coalescer on the calling request's record."""

    def __init__(self, coal):
        self._coal = coal

    def __getattr__(self, name):
        return getattr(self._coal, name)

    def probe_outcomes(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self._coal.probe_outcomes(*args, **kwargs)
        finally:
            rec = current()
            if rec is not None:
                rec.coal.append((t0, time.perf_counter()))


def wrap_probe_launches(hist, spans: Spans) -> None:
    """Record every batched probe the histogram runs: its interval and B."""
    inner = hist.probe_batch

    def probe_batch(preds, thresholds, **kwargs):
        t0 = time.perf_counter()
        out = inner(preds, thresholds, **kwargs)
        with spans._lock:
            spans.launches.append((t0, time.perf_counter(),
                                   int(np.shape(preds)[0])))
        return out

    hist.probe_batch = probe_batch


@dataclasses.dataclass
class Request:
    nodes: tuple
    qseed: int
    due: float = 0.0
    start: float = 0.0
    end: float = 0.0
    coal: list = dataclasses.field(default_factory=list)   # (t0, t1)
    spec: list = dataclasses.field(default_factory=list)
    order: list | None = None        # node ids, as planned
    sel: dict | None = None          # node -> planned selectivity
    thr: dict | None = None          # node -> planned threshold
    error: str | None = None

    @property
    def coal_s(self) -> float:
        """Seconds spent inside the coalescer."""
        return sum(b - a for a, b in self.coal)

    @property
    def done(self) -> bool:
        return self.end > 0.0

    @property
    def ok(self) -> bool:
        return self.done and self.error is None


@dataclasses.dataclass
class Stack:
    corpus: Corpus
    hist: SemanticHistogram
    estimator: EnsembleEstimator
    coalescer: PredicateCoalescer
    obs: ObsHub
    index: object | None

    def close(self) -> None:
        self.coalescer.close()


def port_corpus(tree: Tree, host_images: np.ndarray, seed: int) -> Corpus:
    concepts = {}
    for nid in range(tree.nodes):
        par = int(tree.parent[nid])
        concepts[nid] = Concept(
            node_id=nid, depth=int(tree.depth[nid]),
            parent=None if par < 0 else par,
            children=list(tree.children[nid]),
            direction=tree.directions[nid], name=f"n{nid}",
            leaf_image_ids=np.arange(tree.lo[nid], tree.hi[nid],
                                     dtype=np.int64))
    leaf = np.repeat(tree.leaves, tree.leaf_counts)
    return Corpus(name=tree.preset, dim=tree.dim, images=host_images,
                  image_leaf=leaf, concepts=concepts,
                  text_noise=tree.text_noise, vlm_error=tree.vlm_error,
                  rng=rng_for(seed, 20))


def build(cfg: dict, tree: Tree, store: torch.Tensor,
          host_images: np.ndarray, mlp_params: dict,
          sample_ids: np.ndarray, seed: int, spans: Spans) -> Stack:
    dev = store.device
    corpus = port_corpus(tree, host_images, seed)
    index = None
    if cfg.get("index_clusters", 0):
        index = build_clustered_store(store, int(cfg["index_clusters"]),
                                      seed=torch_seed(seed, 21))
    hist = SemanticHistogram(store, index=index)
    model = specificity_model_from_numpy(
        mlp_params,
        SpecificityModelConfig(embed_dim=tree.dim,
                               hidden=tuple(cfg["mlp_hidden"])),
        device=dev)
    kv = cfg["kvbatch"]
    kvstore = build_compressed_store(
        host_images, sample_ids, rate=float(kv["compression_rate"]),
        smoke=bool(kv.get("smoke", False)), seed=torch_seed(seed, 22),
        device=dev)
    spec = SpecificityEstimator(corpus, hist, SpecModelRecorder(model))
    kvb = KVBatchEstimator(corpus, hist, kvstore,
                           prompt_len=int(kv["prompt_len"]))
    ens = EnsembleEstimator(spec, kvb)
    co = cfg["coalescer"]
    obs = ObsHub()
    coal = PredicateCoalescer(
        hist, CoalescerConfig(max_batch=int(co["max_batch"]),
                              window_ms=float(co["window_ms"]),
                              cache_capacity=int(co["cache_capacity"]),
                              cache_bits=int(co["cache_bits"])),
        obs=obs)
    wrap_probe_launches(hist, spans)
    return Stack(corpus=corpus, hist=hist, estimator=ens, coalescer=coal,
                 obs=obs, index=index)


def serve(stack: Stack, coal: CoalescerSpan, rec: Request) -> None:
    """One request: ``plan_query`` through the coalescer, recorded."""
    _local.rec = rec
    rec.start = time.perf_counter()
    try:
        plan = plan_query(list(rec.nodes), stack.estimator, seed=rec.qseed,
                          coalescer=coal)
        if plan.degraded:
            rec.error = "degraded plan"
        rec.order = [int(n) for n in plan.filter_order]
        rec.sel = {int(n): float(e.selectivity)
                   for n, e in zip(plan.filter_order, plan.estimates)}
        rec.thr = {int(n): float(e.threshold)
                   for n, e in zip(plan.filter_order, plan.estimates)}
    except Exception as e:  # noqa: BLE001 — a failed request is counted
        rec.error = f"{type(e).__name__}: {e}"
    finally:
        rec.end = time.perf_counter()
        _local.rec = None

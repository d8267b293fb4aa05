"""The system under test, assembled from the port's public parts around
the benchmark's inputs, and the thin wrappers that record the calls into
its layers.

``build`` hands the program the corpus the benchmark drew (the device store
and one host copy as the port's ``Corpus``), the specificity MLP's weights
the benchmark trained, the KV-batch sample it drew and the KV-batch VLM's
weights, patch embeddings and calibration tokens (``vlmdraw``), then lets
the port build the rest itself: the cluster-pruned index where the
configuration asks for one, the VLM's compressed caches
(``assemble_store``), the three estimators and the coalescer.

The configuration's ``kvbatch`` group goes to the port whole: ``vlm``
(a registry id) and ``smoke`` pick the port's model configuration,
``compression_rate`` is ``assemble_store``'s ``rate``, and every other key
but the benchmark's own (``sample``, ``kmeans_iters``) goes to the port
entry point whose signature names it as a keyword, ``assemble_store`` or
``KVBatchEstimator``. A key that none names stops the run, so a
configuration is never half read.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.paper_stack import SpecificityModelConfig
from repro_torch.core import estimators, kvbatch
from repro_torch.core.estimators import (
    EnsembleEstimator,
    KVBatchEstimator,
    SpecificityEstimator,
)
from repro_torch.core.histogram import SemanticHistogram
from repro_torch.core.optimizer import plan_query
from repro_torch.core.specificity import specificity_model_from_numpy
from repro_torch.core.synthetic import Concept, Corpus
from repro_torch.index.clustered import build_clustered_store
from repro_torch.launch.coalescer import CoalescerConfig, PredicateCoalescer
from repro_torch.models import nn
from repro_torch.models.steps import model_specs
from repro_torch.obs import ObsHub

from semhist_bench import vlmdraw
from semhist_bench.corpus import Tree, rng_for, torch_seed
from semhist_bench.vlmcheck import DECODES_KEPT, VLMRecord

KV_OWN = ("sample", "kmeans_iters")     # the benchmark's keys (inputs.py)
KV_CONFIG = ("vlm", "smoke")            # the port's model configuration
KV_ALIAS = {"compression_rate": "rate"}  # assemble_store's name for a key

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


def _keywords(fn) -> set[str]:
    return {n for n, p in inspect.signature(fn).parameters.items()
            if p.kind is inspect.Parameter.KEYWORD_ONLY}


@dataclasses.dataclass
class PortVLM:
    """The ``kvbatch`` group as the port reads it."""

    cfg: object                # the port's model configuration
    store_kw: dict             # assemble_store's keywords
    estimator_kw: dict         # KVBatchEstimator's keywords


def port_vlm(kv: dict) -> PortVLM:
    """Route every key of ``kv`` to what reads it; raise on one that
    nothing reads."""
    targets = {"assemble_store": (_keywords(kvbatch.assemble_store), {}),
               "KVBatchEstimator": (_keywords(KVBatchEstimator), {})}
    unread = []
    for key, value in kv.items():
        if key in KV_OWN or key in KV_CONFIG:
            continue
        name = KV_ALIAS.get(key, key)
        hit = [t for t, (kws, _) in targets.items() if name in kws]
        if len(hit) != 1:
            unread.append(key)
            continue
        targets[hit[0]][1][name] = value
    if unread:
        raise ValueError(
            f"kvbatch keys {unread} are read by neither the benchmark "
            f"({list(KV_OWN)}) nor the port (the model configuration: "
            f"{list(KV_CONFIG)}; assemble_store: "
            f"{sorted(targets['assemble_store'][0])}; KVBatchEstimator: "
            f"{sorted(targets['KVBatchEstimator'][0])})")
    cfg = get_config(str(kv["vlm"]), smoke=bool(kv.get("smoke", False)))
    return PortVLM(cfg, targets["assemble_store"][1],
                   targets["KVBatchEstimator"][1])


def _leaves(tree, prefix: str = "") -> list[tuple]:
    """(dotted path, spec) of each leaf, in ``nn.tree_leaves`` order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [leaf for k, v in items
            for leaf in _leaves(v, f"{prefix}.{k}" if prefix else str(k))]


def vlm_layout(cfg) -> list[tuple]:
    """The port's weight tree as leaves (path, shape, init, dtype): its
    ``embed`` and ``normal`` leaves are both random."""
    return [(p, tuple(s.shape), "normal" if s.init == "embed" else s.init,
             s.dtype) for p, s in _leaves(model_specs(cfg))]


def vlm_params(cfg, seed: int, dev: torch.device):
    """The port's weight tree, each leaf drawn by ``vlmdraw``."""
    specs = model_specs(cfg)
    layout = vlm_layout(cfg)
    drawn = {}
    for g in vlmdraw.groups(layout):
        drawn.update(vlmdraw.draw_group(layout, seed, g, dev))
    return nn.tree_unflatten(specs, [drawn[p] for p, _ in _leaves(specs)])


def build_vlm_store(port: PortVLM, sample_embs: np.ndarray,
                    sample_ids: np.ndarray, seed: int, dev: torch.device,
                    rec: VLMRecord):
    """The port's compressed caches of the sample (its ids and its rows of
    the store), from the benchmark's draws, with the press's kept
    positions of the judged rows in ``rec``."""
    cfg = port.cfg
    t0 = time.perf_counter()
    params = vlm_params(cfg, seed, dev)
    embs = torch.as_tensor(sample_embs, device=dev)
    patches = vlmdraw.draw_patches(embs, cfg.d_model,
                                   cfg.vlm.num_patch_tokens,
                                   cfg.compute_dtype, seed)
    calib = vlmdraw.calib_tokens(cfg.vocab_size, seed, dev)
    rows = torch.as_tensor(rec.rows, device=dev)
    inner = kvbatch.compress_cache

    def compress_cache(*args, **kwargs):
        out = inner(*args, **kwargs)
        rec.kept.append(out[2][rows].cpu().numpy())
        return out

    kvbatch.compress_cache = compress_cache
    try:
        store = kvbatch.assemble_store(cfg, params, patches, calib,
                                       sample_ids, **port.store_kw)
    finally:
        kvbatch.compress_cache = inner
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    store.build_s = time.perf_counter() - t0
    return store


def record_cache(kvstore, rec: VLMRecord) -> None:
    """The judged rows' compressed caches as the store holds them: per
    layer, every tensor of the layer's dict by its name (each (B, slots,
    ...)), at the kept slots, on the host."""
    n = kvstore.cache_len
    rows = torch.as_tensor(rec.rows)
    rec.cache = [{name: t[rows.to(t.device), :n].cpu()
                  for name, t in c.items()} for c in kvstore.cache]


def wrap_decodes(rec: VLMRecord):
    """Record the answer logits of the judged rows of the first
    ``DECODES_KEPT`` batched prompt decodes the KV-batch estimator runs
    (it calls ``estimators.batched_prompt_decode``). Returns the undo."""
    inner = estimators.batched_prompt_decode
    lock = threading.Lock()

    def batched_prompt_decode(store, prompt_tokens):
        logits, dt = inner(store, prompt_tokens)
        with lock:
            rec.decode_calls += 1
            if len(rec.decodes) < DECODES_KEPT:
                rec.decodes.append((np.array(prompt_tokens),
                                    np.array(logits[rec.rows])))
        return logits, dt

    estimators.batched_prompt_decode = batched_prompt_decode

    def undo():
        estimators.batched_prompt_decode = inner
    return undo


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
    kvstore: object            # the port's CompressedCacheStore
    vlm: VLMRecord
    undo: list                 # restores what the wrappers replaced

    def unwrap(self) -> None:
        while self.undo:
            self.undo.pop()()

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
    port = port_vlm(cfg["kvbatch"])
    rec = VLMRecord(rows=vlmdraw.judged_rows(seed, len(sample_ids)))
    kvstore = build_vlm_store(port, host_images[np.asarray(sample_ids)],
                              sample_ids, seed, dev, rec)
    spec = SpecificityEstimator(corpus, hist, SpecModelRecorder(model))
    kvb = KVBatchEstimator(corpus, hist, kvstore, **port.estimator_kw)
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
                 obs=obs, index=index, kvstore=kvstore, vlm=rec,
                 undo=[wrap_decodes(rec)])


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

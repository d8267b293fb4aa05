"""The four selectivity estimators of the paper, behind one interface.

Latency accounting (DESIGN.md §9.4): every estimate carries
  * measured_s   — wall time actually measured on this machine for the
                   estimator's own compute (probe, MLP, batched decode), and
  * vlm_calls    — equivalent sequential VLM calls the method costs online
                   (sampling: n; kv-batch: ~1, the paper's headline claim).
End-to-end figures convert calls -> seconds with a per-call latency constant
so relative comparisons match the paper's protocol.

Batched interface: estimators that can amortize work across predicates
implement ``estimate_batch(node_ids)`` — thresholds for the whole batch come
from one device call (``SpecificityModel.thresholds`` already batches the
MLP; KV-batch calibration is numpy), and selectivity for all predicates
comes from **one** batched histogram probe (one store pass, one device
round-trip) instead of a per-predicate Python loop of probe + float()
conversions. ``plan_query`` uses it for all filters of a query at once.

The KV-batch estimator runs its machinery by default, as the reference
does: the batched prompt decode over the compressed caches is timed once
(``_machinery_latency``) and reported with every kvbatch and ensemble
estimate. The coalescer's ``probe=`` hook and the ensemble's
observed-selectivity cache (which ``compound_selectivity`` consults first
in the reference) come with the coalescer and its ``PredicateCache``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core.histogram import SemanticHistogram
from repro_torch.core.kvbatch import (
    CompressedCacheStore,
    batched_prompt_decode,
    threshold_from_matches,
)
from repro_torch.core.specificity import SpecificityModel
from repro_torch.core.synthetic import Corpus

# EMA rate of the ensemble's feedback correction (the reference's default).
FEEDBACK_ALPHA = 0.25


@dataclasses.dataclass
class Estimate:
    selectivity: float
    measured_s: float
    vlm_calls: float            # sequential-equivalent online VLM calls
    threshold: float | None = None
    extra: dict = dataclasses.field(default_factory=dict)


def _predicate_embeddings(corpus: Corpus, node_ids, seed: int) -> np.ndarray:
    """(B, d) text embeddings for a predicate batch."""
    return np.stack([corpus.text_embedding(n, seed) for n in node_ids])


class SamplingEstimator:
    """The online-profiling baseline every semantic data system uses."""

    def __init__(self, corpus: Corpus, sample_size: int):
        self.corpus = corpus
        self.n = sample_size
        self.name = f"sampling-{sample_size}"

    def estimate(self, node_id: int, seed: int = 0) -> Estimate:
        rng = np.random.default_rng(seed)
        ids = rng.choice(len(self.corpus.images), size=self.n, replace=False)
        t0 = time.perf_counter()
        ans = self.corpus.vlm_answer(node_id, ids, seed=seed)
        dt = time.perf_counter() - t0
        sel = float(ans.mean())
        return Estimate(sel, dt, vlm_calls=self.n)


class SpecificityEstimator:
    """Paper §3.1: MLP threshold -> histogram probe. No VLM calls at all."""

    def __init__(self, corpus: Corpus, hist: SemanticHistogram,
                 model: SpecificityModel):
        self.corpus, self.hist, self.model = corpus, hist, model
        self.name = "specificity-model"

    def _thresholds(self, embs: np.ndarray) -> np.ndarray:
        """Batched MLP thresholds — one jitted apply for the whole batch."""
        return self.model.thresholds(embs)

    def estimate(self, node_id: int, seed: int = 0) -> Estimate:
        t0 = time.perf_counter()
        emb = self.corpus.text_embedding(node_id, seed)
        thr = self.model.threshold(emb)
        sel = self.hist.selectivity(emb, thr)
        return Estimate(sel, time.perf_counter() - t0, vlm_calls=0.0,
                        threshold=thr)

    def estimate_batch(self, node_ids, seed: int = 0) -> list[Estimate]:
        """All thresholds in one MLP apply, all selectivities in one probe."""
        t0 = time.perf_counter()
        embs = _predicate_embeddings(self.corpus, node_ids, seed)
        thrs = self._thresholds(embs)
        sels = self.hist.selectivity_batch(embs, thrs)
        dt = (time.perf_counter() - t0) / max(1, len(node_ids))
        return [Estimate(float(s), dt, vlm_calls=0.0, threshold=float(t))
                for s, t in zip(sels, thrs)]


class KVBatchEstimator:
    """Paper §3.2: one batched decode over compressed caches -> threshold."""

    def __init__(self, corpus: Corpus, hist: SemanticHistogram,
                 store: CompressedCacheStore, *, prompt_len: int = 6,
                 run_machinery: bool = True):
        self.corpus, self.hist, self.store = corpus, hist, store
        self.prompt_len = prompt_len
        self.run_machinery = run_machinery
        self.name = f"kvbatch-{len(store.sample_ids)}"
        self._machine_s: float | None = None

    def _machinery_latency(self) -> float:
        """Measured batched prompt-decode latency (cached: prompt length and
        batch are constant across predicates, per the paper's design); 0.0
        with the machinery off. The answers come from the corpus oracle
        either way."""
        if self._machine_s is None:
            if self.run_machinery:
                if self.store.params["embed"].is_cuda:
                    torch.cuda.synchronize()   # earlier work is not counted
                prompt = np.arange(self.prompt_len) % self.store.cfg.vocab_size
                _, self._machine_s = batched_prompt_decode(self.store, prompt)
            else:
                self._machine_s = 0.0
        return self._machine_s

    def _thresholds(self, node_ids, embs: np.ndarray,
                    seed: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched §3.2 calibration: (thresholds (B,), sample matches (B,)).
        One (S, d) x (d, B) distance matmul for the whole predicate batch;
        the batched decode machinery runs once regardless of B."""
        ids = self.store.sample_ids
        dists = 1.0 - self.corpus.images[ids] @ embs.T      # (S, B)
        ms = np.asarray([int(self.corpus.vlm_answer(n, ids, seed=seed).sum())
                         for n in node_ids])
        thrs = np.asarray([threshold_from_matches(dists[:, j], int(ms[j]))
                           for j in range(len(node_ids))])
        return thrs, ms

    def estimate(self, node_id: int, seed: int = 0) -> Estimate:
        machine_s = self._machinery_latency()
        t0 = time.perf_counter()
        emb = self.corpus.text_embedding(node_id, seed)
        ids = self.store.sample_ids
        # answers: oracle stands in for the (synthetic-weight) VLM's argmax
        ans = self.corpus.vlm_answer(node_id, ids, seed=seed)
        m = int(ans.sum())
        dists = 1.0 - self.corpus.images[ids] @ emb
        thr = threshold_from_matches(dists, m)
        sel = self.hist.selectivity(emb, thr)
        dt = time.perf_counter() - t0
        # measured_s = embedding-side work only, as in the reference; the
        # batched decode counts as vlm_calls=1 and its measured seconds ride
        # in extra (under the reference's key)
        return Estimate(sel, dt, vlm_calls=1.0, threshold=thr,
                        extra={"sample_matches": m,
                               "machine_cpu_s": machine_s})

    def estimate_batch(self, node_ids, seed: int = 0) -> list[Estimate]:
        """Batched calibration + one histogram probe for all predicates."""
        machine_s = self._machinery_latency()
        t0 = time.perf_counter()
        embs = _predicate_embeddings(self.corpus, node_ids, seed)
        thrs, ms = self._thresholds(node_ids, embs, seed)
        sels = self.hist.selectivity_batch(embs, thrs)
        dt = (time.perf_counter() - t0) / max(1, len(node_ids))
        return [Estimate(float(s), dt, vlm_calls=1.0, threshold=float(t),
                         extra={"sample_matches": int(m),
                                "machine_cpu_s": machine_s})
                for s, t, m in zip(sels, thrs, ms)]


class EnsembleEstimator:
    """Paper §3.3: average the two thresholds; most robust across datasets.

    Compound + feedback extensions:

    * ``compound_selectivity(node_ids, thresholds)`` estimates the joint
      selectivity of a conjunction through the histogram's one-launch
      compound probe, so ``plan_query`` can order cascades by
      *conditional* instead of independent selectivities.
    * ``feedback=True`` enables the Larch-style loop: ``observe`` (called
      by ``execute_cascade`` after every plan) EMA-updates a multiplicative
      log-space correction from observed-vs-predicted selectivity ratios,
      applied to subsequent predictions.
    """

    def __init__(self, spec: SpecificityEstimator, kvb: KVBatchEstimator, *,
                 feedback: bool = False):
        self.spec, self.kvb = spec, kvb
        self.hist = spec.hist
        self.corpus = spec.corpus
        self.name = "ensemble"
        self.feedback = feedback
        self._log_corr = 0.0                 # EMA of log(observed/predicted)
        self._corr_lock = threading.Lock()

    # --------------------------------------------------- feedback helpers

    def _correct(self, sel: float) -> float:
        """Apply the learned multiplicative correction (identity until
        feedback has observed anything)."""
        if not self.feedback or self._log_corr == 0.0:
            return float(sel)
        return float(min(1.0, max(0.0, sel * np.exp(self._log_corr))))

    def observe(self, corpus, plan, observed_prefix,
                seed: int = 0) -> None:
        """Write one executed plan's ground truth back into the estimator.

        EMA-update the log correction from the mean ratio of true to
        predicted marginal selectivity over the plan's filters (execution
        makes truth free). ``observed_prefix`` (the cascade's per-prefix
        survival fractions) is part of the ``feedback=`` interface; the
        observed-selectivity cache that stores it is not ported yet.
        """
        eps = 1.0 / max(len(corpus.images), 1)
        ratios = [np.log((float(corpus.true_selectivity(node_id)) + eps)
                         / (float(est.selectivity) + eps))
                  for node_id, est in zip(plan.filter_order, plan.estimates)]
        if self.feedback and ratios:
            with self._corr_lock:
                self._log_corr = ((1.0 - FEEDBACK_ALPHA) * self._log_corr
                                  + FEEDBACK_ALPHA * float(np.mean(ratios)))

    # ----------------------------------------------------------- compound

    def compound_selectivity(self, node_ids, thresholds, seed: int = 0,
                             *, mode: str = "and") -> float:
        """Joint selectivity of a conjunction/disjunction of calibrated
        filters — one compound probe through the index's joint cluster
        bounds (a full compound scan without an index)."""
        embs = _predicate_embeddings(self.corpus, node_ids, seed)
        sel = self.hist.selectivity_compound(
            embs, np.asarray(thresholds, np.float64), mode=mode)
        return self._correct(sel)

    def estimate(self, node_id: int, seed: int = 0) -> Estimate:
        e1 = self.spec.estimate(node_id, seed)
        e2 = self.kvb.estimate(node_id, seed)
        t0 = time.perf_counter()
        emb = self.corpus.text_embedding(node_id, seed)
        thr = 0.5 * (e1.threshold + e2.threshold)
        sel = self.hist.selectivity(emb, thr)
        dt = time.perf_counter() - t0
        return Estimate(sel, e1.measured_s + e2.measured_s + dt,
                        vlm_calls=e2.vlm_calls, threshold=thr,
                        extra=e2.extra)

    def estimate_batch(self, node_ids, seed: int = 0) -> list[Estimate]:
        """Both component thresholds are pure calibration (MLP apply +
        sample-distance sort — no probe needed), so the whole query batch
        costs exactly **one** histogram probe at the averaged thresholds."""
        machine_s = self.kvb._machinery_latency()
        t0 = time.perf_counter()
        embs = _predicate_embeddings(self.corpus, node_ids, seed)
        t_spec = self.spec._thresholds(embs)
        t_kvb, ms = self.kvb._thresholds(node_ids, embs, seed)
        thrs = 0.5 * (t_spec + t_kvb)
        sels = self.hist.selectivity_batch(embs, thrs)
        dt = (time.perf_counter() - t0) / max(1, len(node_ids))
        return [Estimate(self._correct(float(s)), dt, vlm_calls=1.0,
                         threshold=float(t),
                         extra={"sample_matches": int(m),
                                "machine_cpu_s": machine_s})
                for s, t, m in zip(sels, thrs, ms)]


class OracleEstimator:
    """Zero-latency perfect selectivity — the paper's Fig.4 baseline."""

    name = "oracle"

    def __init__(self, corpus: Corpus):
        self.corpus = corpus

    def estimate(self, node_id: int, seed: int = 0) -> Estimate:
        return Estimate(self.corpus.true_selectivity(node_id), 0.0, 0.0)

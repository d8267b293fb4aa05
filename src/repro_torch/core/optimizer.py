"""Selectivity-driven query optimization (paper §4.3).

A semantic query is a conjunction of filter predicates, each evaluated by a
VLM call per surviving image. The optimizer orders filters ascending by
estimated selectivity (most selective first minimizes downstream calls); the
executor runs the cascade and accounts true VLM calls.

Runtime model: end-to-end seconds = estimation latency (measured) +
VLM_calls x per-call latency, with the reference's per-call constant.

Compound planning (``compound=True``) orders a multi-filter plan by
*conditional* selectivity: greedy joint-prefix probes through the
estimator's ``compound_selectivity``. Serving: ``plan_query(coalescer=)``
routes the estimators' probes through a
``repro_torch.launch.coalescer.PredicateCoalescer`` under its control plane
(deadlines, bound-only degraded answers), and ``execute_cascade(obs=)``
feeds the executed plan's q-error into a ``repro_torch.obs.ObsHub``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core import phases
from repro_torch.core.estimators import Estimate
from repro_torch.core.synthetic import Corpus

# The reference's modelled cost of one sequential VLM call, in seconds.
DEFAULT_VLM_CALL_S = 0.15


@dataclasses.dataclass
class QueryPlan:
    filter_order: list[int]           # node ids, most selective first
    estimates: list[Estimate]
    est_latency_s: float
    est_vlm_calls: float
    degraded: bool = False            # any estimate answered from bounds
    #                                   (its Estimate.extra carries the
    #                                   certified "sel_interval")
    # estimated selectivity of each cascade *prefix* (filters 0..i ANDed),
    # filled by the compound planner; None for independence-ordered plans
    prefix_sels: list[float] | None = None


class _CoalescedProbe:
    """Request-scoped probe callable: routes through the coalescer's
    control plane and keeps the per-predicate ``ProbeOutcome``s so the
    planner can mark bound-only (degraded) estimates afterwards."""

    def __init__(self, coalescer, deadline, degraded_ok):
        self.coalescer = coalescer
        self.deadline = deadline
        self.degraded_ok = degraded_ok
        self.outcomes = []

    def __call__(self, preds, thresholds):
        with phases.phase("probe"):
            res = self.coalescer.probe_outcomes(
                preds, thresholds, deadline=self.deadline,
                degraded_ok=self.degraded_ok)
        self.outcomes.extend(res)
        return np.asarray([o.sel for o in res])


@dataclasses.dataclass
class ExecutionResult:
    plan: QueryPlan
    vlm_calls: int                    # true calls during cascade execution
    result_ids: np.ndarray
    exec_s: float                     # modeled: calls x per-call
    total_s: float                    # estimation + execution
    overhead_s: float = 0.0           # vs oracle plan (filled by caller)


def _mark_degraded(ests: list, outcomes: list) -> bool:
    """Map accumulated ``ProbeOutcome``s back onto per-filter estimates.

    ``outcomes`` holds one *group* of ``len(ests)`` outcomes per probe call,
    in filter order within each group, so filter ``j``'s outcomes are
    ``outcomes[j::len(ests)]`` — an estimate is degraded if ANY of its probe
    calls answered from bounds. An outcome count that is not a whole number
    of groups cannot be attributed to filters and raises.
    """
    n_out, n_est = len(outcomes), len(ests)
    if n_out == 0:
        return False
    if n_est == 0 or n_out % n_est != 0:
        raise RuntimeError(
            f"cannot reconcile {n_out} probe outcome(s) with {n_est} "
            f"estimate(s): the probe wrapper saw batches that are not a "
            f"whole multiple of the filter count, so degraded/bound-only "
            f"status cannot be attributed per filter")
    degraded = False
    for j, e in enumerate(ests):
        for o in outcomes[j::n_est]:
            if o.degraded:
                degraded = True
                e.extra["degraded"] = True
                e.extra["sel_interval"] = (o.lo, o.hi)
    return degraded


def _compound_order(filters: list, ests: list, estimator, seed: int
                    ) -> tuple[list[int], list[float]] | None:
    """Greedy conditional ordering: the filter with the smallest marginal
    selectivity first, then repeatedly the candidate that minimizes the
    *joint* selectivity of the extended prefix (one compound probe per
    candidate). Returns (order indices, per-prefix joint selectivities), or
    None when an estimate lacks a calibrated threshold."""
    thrs = [e.threshold for e in ests]
    if any(t is None for t in thrs):
        return None
    remaining = list(range(len(ests)))
    first = min(remaining, key=lambda i: (ests[i].selectivity, i))
    order = [first]
    remaining.remove(first)
    prefix_sels = [float(ests[first].selectivity)]
    while remaining:
        best, best_sel = None, None
        for c in remaining:
            ids = [filters[i] for i in order + [c]]
            ts = [thrs[i] for i in order + [c]]
            sel = float(estimator.compound_selectivity(ids, ts, seed=seed))
            if best_sel is None or sel < best_sel:
                best, best_sel = c, sel
        order.append(best)
        remaining.remove(best)
        prefix_sels.append(best_sel)
    return order, prefix_sels


def plan_query(filters: Sequence[int], estimator, seed: int = 0,
               coalescer=None, *, deadline_ms: float | None = None,
               degraded_ok: bool | None = None,
               compound: bool = False) -> QueryPlan:
    """Estimate every filter, order ascending by selectivity.

    Fast path: estimators exposing ``estimate_batch`` (specificity, kv-batch,
    ensemble) get all filters of the query in one call — thresholds batched,
    selectivities from a single batched histogram probe (one store pass).
    Estimators without it fall back to the per-filter loop.

    Serving path: with a ``PredicateCoalescer`` handle, estimators
    advertising ``supports_probe`` route their probe through it, so
    concurrent ``plan_query`` calls share one cross-query micro-batched
    store pass and hot predicates resolve from its LRU cache.
    ``deadline_ms`` (wall budget for this plan's probes, from entry; None
    defers to the coalescer's config) and ``degraded_ok`` (accept certified
    bound-only answers instead of errors) are forwarded per request. A plan
    built from any degraded estimate is marked ``QueryPlan.degraded`` and
    each such estimate carries ``extra['sel_interval'] = (lo, hi)``.

    With ``compound=True`` and an estimator exposing
    ``compound_selectivity`` (the ensemble), a multi-filter plan is ordered
    by conditional selectivity instead, and ``QueryPlan.prefix_sels``
    carries the estimated joint selectivity of every cascade prefix.
    Degraded plans keep the interval-midpoint order: a compound probe
    cannot certify bounds.

    With a coalescer that carries a telemetry hub (``coalescer.obs``), the
    plan runs under a ``phases.PhaseClock`` and hands it to the hub's
    ``planner_phases`` at its end (``repro_torch.core.phases``)."""
    record = getattr(getattr(coalescer, "obs", None), "planner_phases", None)
    if record is None:
        return _plan(filters, estimator, seed, coalescer, deadline_ms,
                     degraded_ok, compound)
    clock, prev = phases.PhaseClock(), phases.current()
    phases.bind(clock)
    try:
        with phases.phase("wall"):
            return _plan(filters, estimator, seed, coalescer, deadline_ms,
                         degraded_ok, compound)
    finally:
        phases.bind(prev)
        record(clock)


def _plan(filters, estimator, seed, coalescer, deadline_ms, degraded_ok,
          compound) -> QueryPlan:
    batch = getattr(estimator, "estimate_batch", None)
    wrapper = None
    if batch is not None and len(filters) > 0:
        kwargs = {}
        if coalescer is not None and getattr(estimator, "supports_probe",
                                             False):
            deadline = (time.monotonic() + deadline_ms / 1e3
                        if deadline_ms else None)
            wrapper = _CoalescedProbe(coalescer, deadline, degraded_ok)
            kwargs["probe"] = wrapper
        ests = batch(list(filters), seed=seed, **kwargs)
    else:
        ests = [estimator.estimate(f, seed=seed) for f in filters]
    degraded = False
    if wrapper is not None:
        degraded = _mark_degraded(ests, wrapper.outcomes)
    filters = list(filters)
    order = list(np.argsort([e.selectivity for e in ests], kind="stable"))
    prefix_sels = None
    if (compound and not degraded and len(ests) > 1
            and hasattr(estimator, "compound_selectivity")):
        ordered = _compound_order(filters, ests, estimator, seed)
        if ordered is not None:
            order, prefix_sels = ordered
    return QueryPlan(
        filter_order=[filters[i] for i in order],
        estimates=[ests[i] for i in order],
        est_latency_s=sum(e.measured_s for e in ests),
        est_vlm_calls=sum(e.vlm_calls for e in ests),
        degraded=degraded,
        prefix_sels=prefix_sels,
    )


def execute_cascade(
    corpus: Corpus, plan: QueryPlan, *, seed: int = 0,
    per_call_s: float = DEFAULT_VLM_CALL_S,
    obs=None, est_name: str | None = None, feedback=None,
) -> ExecutionResult:
    """Run the cascade; with ``obs`` (a ``repro_torch.obs.ObsHub``), feed
    the now-known true selectivities back as per-estimator q-error
    accounting (``obs.record_plan``).

    ``feedback`` (duck-typed, e.g. the ensemble estimator with feedback
    enabled) receives ``observe(corpus, plan, observed_prefix)`` after the
    cascade: the observed per-prefix survival fractions (padded with 0.0
    past an early empty-set break — the prefix truly matched nothing)
    plus ground-truth per-filter selectivities, which it writes back into
    its correction and its observed-selectivity cache."""
    n0 = len(corpus.images)
    alive = np.arange(n0)
    calls = 0
    observed_prefix: list[float] = []
    for f in plan.filter_order:
        if len(alive) == 0:
            observed_prefix.append(0.0)
            continue
        ans = corpus.vlm_answer(f, alive, seed=seed)
        calls += len(alive)
        alive = alive[ans]
        observed_prefix.append(len(alive) / max(n0, 1))
    exec_s = calls * per_call_s
    est_exec_s = plan.est_vlm_calls * per_call_s
    total = plan.est_latency_s + est_exec_s + exec_s
    if obs is not None:
        obs.record_plan(est_name or "estimator", corpus, plan,
                        observed_prefix=observed_prefix)
    if feedback is not None:
        feedback.observe(corpus, plan, observed_prefix, seed=seed)
    return ExecutionResult(plan=plan, vlm_calls=calls, result_ids=alive,
                           exec_s=exec_s, total_s=total)


def run_query(corpus, filters, estimator, *, seed=0,
              per_call_s: float = DEFAULT_VLM_CALL_S, coalescer=None,
              deadline_ms: float | None = None,
              degraded_ok: bool | None = None, obs=None,
              est_name: str | None = None, compound: bool = False,
              feedback=None) -> ExecutionResult:
    """Plan + execute one query, forwarding the control plane to
    ``plan_query`` and the telemetry + feedback handles to
    ``execute_cascade``."""
    plan = plan_query(filters, estimator, seed=seed, coalescer=coalescer,
                      deadline_ms=deadline_ms, degraded_ok=degraded_ok,
                      compound=compound)
    return execute_cascade(corpus, plan, seed=seed, per_call_s=per_call_s,
                           obs=obs, est_name=est_name, feedback=feedback)


def generate_queries(corpus: Corpus, *, n_queries: int, n_filters: int,
                     seed: int = 0) -> list[list[int]]:
    """Random conjunctions over the available predicates (paper: 100 each of
    2/3/4 filters). ``n_filters`` must not exceed the corpus's predicate
    count — conjunctions sample without replacement."""
    rng = np.random.default_rng(seed)
    preds = corpus.predicate_nodes()
    if n_filters < 1:
        raise ValueError(f"n_filters must be >= 1, got {n_filters}")
    if n_filters > len(preds):
        raise ValueError(
            f"n_filters={n_filters} exceeds the corpus's "
            f"{len(preds)} predicate node(s); conjunctions sample "
            f"predicates without replacement")
    return [list(rng.choice(preds, size=n_filters, replace=False))
            for _ in range(n_queries)]

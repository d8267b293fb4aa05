"""Selectivity-driven query optimization (paper §4.3).

A semantic query is a conjunction of filter predicates, each evaluated by a
VLM call per surviving image. The optimizer orders filters ascending by
estimated selectivity (most selective first minimizes downstream calls); the
executor runs the cascade and accounts true VLM calls.

Runtime model: end-to-end seconds = estimation latency (measured) +
VLM_calls x per-call latency, with the reference's per-call constant.

Compound planning (``compound=True``) orders a multi-filter plan by
*conditional* selectivity: greedy joint-prefix probes through the
estimator's ``compound_selectivity``. Not ported yet
(``NotImplementedError``): the cross-query coalescer (``coalescer=``) and
telemetry (``obs=``), ROADMAP §1 item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

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
    # estimated selectivity of each cascade *prefix* (filters 0..i ANDed),
    # filled by the compound planner; None for independence-ordered plans
    prefix_sels: list[float] | None = None


@dataclasses.dataclass
class ExecutionResult:
    plan: QueryPlan
    vlm_calls: int                    # true calls during cascade execution
    result_ids: np.ndarray
    exec_s: float                     # modeled: calls x per-call
    total_s: float                    # estimation + execution
    overhead_s: float = 0.0           # vs oracle plan (filled by caller)


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
               coalescer=None, *, compound: bool = False) -> QueryPlan:
    """Estimate every filter, order ascending by selectivity.

    Fast path: estimators exposing ``estimate_batch`` (specificity, kv-batch,
    ensemble) get all filters of the query in one call — thresholds batched,
    selectivities from a single batched histogram probe (one store pass).
    Estimators without it fall back to the per-filter loop.

    With ``compound=True`` and an estimator exposing
    ``compound_selectivity`` (the ensemble), a multi-filter plan is ordered
    by conditional selectivity instead, and ``QueryPlan.prefix_sels``
    carries the estimated joint selectivity of every cascade prefix."""
    if coalescer is not None:
        raise NotImplementedError(
            "the predicate coalescer is ROADMAP §1 item 10 of the port")
    batch = getattr(estimator, "estimate_batch", None)
    if batch is not None and len(filters) > 0:
        ests = batch(list(filters), seed=seed)
    else:
        ests = [estimator.estimate(f, seed=seed) for f in filters]
    filters = list(filters)
    order = list(np.argsort([e.selectivity for e in ests], kind="stable"))
    prefix_sels = None
    if (compound and len(ests) > 1
            and hasattr(estimator, "compound_selectivity")):
        ordered = _compound_order(filters, ests, estimator, seed)
        if ordered is not None:
            order, prefix_sels = ordered
    return QueryPlan(
        filter_order=[filters[i] for i in order],
        estimates=[ests[i] for i in order],
        est_latency_s=sum(e.measured_s for e in ests),
        est_vlm_calls=sum(e.vlm_calls for e in ests),
        prefix_sels=prefix_sels,
    )


def execute_cascade(
    corpus: Corpus, plan: QueryPlan, *, seed: int = 0,
    per_call_s: float = DEFAULT_VLM_CALL_S,
    obs=None, feedback=None,
) -> ExecutionResult:
    """Run the cascade.

    ``feedback`` (duck-typed, e.g. the ensemble estimator with feedback
    enabled) receives ``observe(corpus, plan, observed_prefix)`` after the
    cascade: the observed per-prefix survival fractions (padded with 0.0
    past an early empty-set break — the prefix truly matched nothing),
    and updates its selectivity correction. ``obs`` (telemetry) is not
    ported yet and must stay None."""
    if obs is not None:
        raise NotImplementedError(
            "telemetry (obs/) is ROADMAP §1 item 10 of the port")
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
    if feedback is not None:
        feedback.observe(corpus, plan, observed_prefix, seed=seed)
    return ExecutionResult(plan=plan, vlm_calls=calls, result_ids=alive,
                           exec_s=exec_s, total_s=total)


def run_query(corpus, filters, estimator, *, seed=0,
              per_call_s: float = DEFAULT_VLM_CALL_S, coalescer=None,
              compound: bool = False, feedback=None) -> ExecutionResult:
    """Plan + execute one query."""
    plan = plan_query(filters, estimator, seed=seed, coalescer=coalescer,
                      compound=compound)
    return execute_cascade(corpus, plan, seed=seed, per_call_s=per_call_s,
                           feedback=feedback)


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

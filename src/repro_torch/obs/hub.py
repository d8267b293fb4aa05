"""ObsHub: the one telemetry handle threaded through the serving stack.

Bundles a ``MetricsRegistry`` and an optional ``Tracer`` so subsystems
take a single ``obs`` argument/attribute. Everything is duck-typed at
the call sites (the index layer never imports this module — it just
calls ``self.obs.index_scan(...)`` when an obs handle was attached), so
layering stays: core/index/runtime know nothing about obs, launch wires
it.

Accuracy accounting (``record_plan``): after a plan executes, the true
selectivity of every filter is known for free (the observation behind
Larch-style learned feedback, PAPERS.md) — exact estimates record a
per-estimator q-error histogram; degraded (bound-only) estimates record
their certified interval *width* and whether the truth fell inside the
interval, never a fake point q-error.
"""

from __future__ import annotations

from repro_torch.core.metrics import q_error
from repro_torch.obs.registry import (
    QERROR_EDGES,
    SECONDS_EDGES,
    UNIT_EDGES,
    MetricsRegistry,
)
from repro_torch.obs.trace import Tracer, get_flush_ctx

__all__ = ["ObsHub"]

# the tolerance ``count_bounds`` certifies under (float bound arithmetic
# vs integer truth): containment is checked with this slack
_EPS = 1e-9


class ObsHub:
    """registry + tracer bundle with the cross-cutting record helpers."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self._planner = None     # planner.* counter handles, made at first use

    # ------------------------------------------------------------- events

    def event(self, name: str, **fields) -> None:
        """Control-plane event: a counter bump + (if tracing) a span."""
        self.registry.counter(f"events.{name}").inc()
        if self.tracer is not None:
            self.tracer.emit("event", event=name, **fields)

    # -------------------------------------------------------------- index

    def index_scan(self, stats: dict, *, probes: int = 1,
                   fraction: float | None = None,
                   per_shard: list | None = None) -> None:
        """One recorded index probe: counters, the cumulative
        scan-fraction gauge, and (inside a traced flush) a scan span."""
        r = self.registry
        r.counter("index.probes").inc(probes)
        r.counter("index.launches").inc(int(stats.get("launches", 0)))
        r.counter("index.rows_scanned").inc(int(stats.get("rows_scanned", 0)))
        r.counter("index.rows_full_equiv").inc(
            int(stats.get("rows_full_equiv", 0)))
        if fraction is not None:
            r.gauge("index.scan_fraction").set(fraction)
        tr = self.tracer
        if tr is not None:
            flush = get_flush_ctx()
            if flush is not None:
                rec = {
                    "flush": flush,
                    "rows_scanned": int(stats.get("rows_scanned", 0)),
                    "rows_full_equiv": int(stats.get("rows_full_equiv", 0)),
                    "launches": int(stats.get("launches", 0)),
                }
                if "scan_fraction" in stats:
                    rec["scan_fraction"] = round(
                        float(stats["scan_fraction"]), 6)
                if per_shard is not None:
                    rec["per_shard"] = per_shard
                tr.emit("scan", **rec)

    def rebuild(self, *, seconds: float, incremental: bool,
                generation: int) -> None:
        """One mutable-store background rebuild + generation swap."""
        r = self.registry
        r.histogram("index.rebuild_s", edges=SECONDS_EDGES).observe(seconds)
        r.counter("index.generation_swaps").inc()
        r.gauge("index.generation").set(generation)
        self.event("generation_swap", seconds=round(float(seconds), 4),
                   incremental=bool(incremental), generation=int(generation))

    # ------------------------------------------------------------ planner

    def planner_phases(self, clock) -> None:
        """One plan's ``repro_torch.core.phases.PhaseClock``, folded into
        the ``planner.*`` counters (integer nanoseconds, and the plan's
        ``vlm_answer`` calls and dense calls)."""
        c = self._planner
        if c is None:
            r = self.registry
            c = self._planner = {
                name: r.counter(f"planner.{name}")
                for name in ("plans", "wall_ns", "probe_ns", "embed_ns",
                             "mlp_ns", "calibration_ns", "vlm_answer_ns",
                             "host_cpu_ns", "vlm_answer_calls",
                             "vlm_answer_dense")}
        c["plans"].inc()
        ns = clock.ns
        for ph in ("wall", "probe", "embed", "mlp", "calibration",
                   "vlm_answer"):
            c[f"{ph}_ns"].inc(ns[ph])
        c["host_cpu_ns"].inc(clock.host_cpu_ns)
        c["vlm_answer_calls"].inc(clock.vlm_answer_calls)
        c["vlm_answer_dense"].inc(clock.vlm_answer_dense)

    # ----------------------------------------------------------- accuracy

    def record_plan(self, est_name: str, corpus, plan,
                    observed_prefix=None) -> None:
        """Per-estimator q-error (exact estimates) / interval accounting
        (degraded estimates) for one executed plan.

        ``observed_prefix`` — the cascade's observed per-prefix survival
        fractions (``execute_cascade`` passes them) — additionally feeds
        ``qerror.prefix.{est_name}`` when the plan carries compound
        ``prefix_sels``: the q-error of every estimated joint prefix
        selectivity against what the cascade actually observed."""
        r = self.registry
        n = len(corpus.images)
        for node_id, est in zip(plan.filter_order, plan.estimates):
            true = float(corpus.true_selectivity(node_id))
            if est.extra.get("degraded"):
                lo, hi = est.extra["sel_interval"]
                r.histogram("qerror.degraded_interval_width",
                            edges=UNIT_EDGES).observe(float(hi) - float(lo))
                contained = lo - _EPS <= true <= hi + _EPS
                r.counter("qerror.bound_contained" if contained
                          else "qerror.bound_violations").inc()
            else:
                r.histogram(f"qerror.{est_name}",
                            edges=QERROR_EDGES).observe(
                    q_error(est.selectivity, true, n))
        prefix_sels = getattr(plan, "prefix_sels", None)
        if prefix_sels and observed_prefix:
            for est_sel, obs_sel in zip(prefix_sels, observed_prefix):
                r.histogram(f"qerror.prefix.{est_name}",
                            edges=QERROR_EDGES).observe(
                    q_error(float(est_sel), float(obs_sel), n))

    # ------------------------------------------------------------ summary

    def write_trace_summary(self, coal_stats: dict) -> None:
        """Final JSONL record: the coalescer's resolution totals (the
        same stats dict ``--metrics-json`` snapshots — one source, no
        drift) plus the per-kind span counts actually emitted."""
        tr = self.tracer
        if tr is None:
            return
        tr.emit(
            "summary",
            requests=int(coal_stats["requests"]),
            probe_scored=int(coal_stats["probe_scored"]),
            cache_hits=int(coal_stats["cache_hits"]),
            coalesced_dups=int(coal_stats["coalesced_dups"]),
            shed=int(coal_stats["shed"]),
            degraded=int(coal_stats["degraded"]),
            errors=int(coal_stats["errors"]),
            probes_fired=int(coal_stats["probes_fired"]),
            sample=tr.sample,
            spans=tr.span_counts(),
            submit_spans=tr.submit_counts(),
        )

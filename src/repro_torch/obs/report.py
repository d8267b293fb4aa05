"""Canonical telemetry snapshot + the ONE exit-summary renderer.

``build_snapshot`` assembles the schema-versioned dict that both
``serve --metrics-json`` writes and ``render`` formats for humans — the
coalescing, cache, control-plane, chaos, index/mutable, fleet, latency
and q-error blocks all read from this single dict, so the human output
and the JSON export cannot drift. Schema and keys are the reference's
(``repro/obs/report.py``).

Snapshot schema (``schema`` bumps on breaking change):

  schema        int — SCHEMA_VERSION
  coalescer     PredicateCoalescer.stats() verbatim (incl. nested
                breaker / cache / chaos dicts), plus ``reconciles``:
                the invariant requests == probe_scored + cache_hits +
                coalesced_dups + shed + degraded + errors
  fleet         ReplicaSet.stats() verbatim (replicated serving):
                aggregate + per-replica reconciliation buckets (the
                coalescer's invariant extended with ``hedge_cancelled``), a
                ``replicas`` list with per-replica health (alive /
                breaker / queue depth / EWMA dispatch latency) and
                nested coalescer stats, fleet cache aggregate, plus
                ``failovers`` / ``hedges`` / ``healthy_replicas`` and
                the replica-scoped chaos counters; ``reconciles`` is
                recomputed here fleet-wide AND per replica
  index         index.stats() verbatim (absent without an index);
                ``mutable`` flags the MutableClusteredStore form
  latency_ms    per-phase {count, p50, p95, p99, ...} summaries for
                queue_wait / probe / combine / request
  qerror        per-estimator exact-q-error histogram summaries
  degraded_answers  interval-width summary + containment counters
  serve         wall_s / qps / queries / degraded_plans / failed_queries
  registry      the full MetricsRegistry.snapshot()
"""

from __future__ import annotations

import json

__all__ = ["SCHEMA_VERSION", "build_snapshot", "render", "write_json"]

SCHEMA_VERSION = 1

RECONCILE_BUCKETS = ("probe_scored", "cache_hits", "coalesced_dups",
                     "shed", "degraded", "errors")

# fleet edition: hedged duplicates that lost the first-wins race
# resolve into their own bucket, so the invariant stays exact with hedging
FLEET_RECONCILE_BUCKETS = RECONCILE_BUCKETS + ("hedge_cancelled",)

_PHASES = ("queue_wait", "probe", "combine", "request")


def build_snapshot(*, registry, coalescer: dict | None = None,
                   fleet: dict | None = None,
                   index: dict | None = None,
                   mutable: bool = False) -> dict:
    reg = registry.snapshot()
    hists = reg["histograms"]
    snap: dict = {"schema": SCHEMA_VERSION}
    if coalescer is not None:
        coalescer = dict(coalescer)
        coalescer["reconciles"] = (
            coalescer["requests"]
            == sum(coalescer[b] for b in RECONCILE_BUCKETS))
        snap["coalescer"] = coalescer
    if fleet is not None:
        fleet = dict(fleet)
        fleet["reconciles"] = (
            fleet["requests"]
            == sum(fleet[b] for b in FLEET_RECONCILE_BUCKETS))
        fleet["replicas"] = [
            dict(r, reconciles=(r["requests"] == sum(
                r[b] for b in FLEET_RECONCILE_BUCKETS)))
            for r in fleet["replicas"]]
        snap["fleet"] = fleet
    if index is not None:
        snap["index"] = index
        snap["mutable"] = bool(mutable)
    snap["latency_ms"] = {ph: hists[f"serve.{ph}_ms"] for ph in _PHASES
                          if f"serve.{ph}_ms" in hists}
    snap["qerror"] = {name.split(".", 1)[1]: h
                      for name, h in hists.items()
                      if name.startswith("qerror.")
                      and name != "qerror.degraded_interval_width"}
    c = reg["counters"]
    snap["degraded_answers"] = {
        "interval_width": hists.get("qerror.degraded_interval_width",
                                    {"count": 0}),
        "bound_contained": c.get("qerror.bound_contained", 0),
        "bound_violations": c.get("qerror.bound_violations", 0),
    }
    g = reg["gauges"]
    snap["serve"] = {
        "queries": c.get("serve.queries", 0),
        "degraded_plans": c.get("serve.degraded_plans", 0),
        "failed_queries": c.get("serve.failed_queries", 0),
        "wall_s": g.get("serve.wall_s", 0.0),
        "qps": g.get("serve.qps", 0.0),
    }
    snap["registry"] = reg
    return snap


def _fmt_table(rows: list[list[str]]) -> list[str]:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return ["  " + "  ".join(
        c.ljust(w) if i == 0 else c.rjust(w)
        for i, (c, w) in enumerate(zip(r, widths))) for r in rows]


def render(snap: dict) -> str:
    """The unified exit summary — every line reads the snapshot only."""
    out: list[str] = []
    st = snap.get("coalescer")
    serve = snap["serve"]
    if st is not None:
        amort = st["requests"] / max(1, st["probes_fired"])
        out.append(
            f"coalescing: {st['probes_fired']} probes for "
            f"{st['requests']} predicate requests across "
            f"{serve['queries']} queries ({amort:.1f} preds "
            f"amortized/probe, {st['coalesced_dups']} in-flight dups "
            f"piggybacked)")
        c = st["cache"]
        out.append(
            f"cache: hit_rate={c['hit_rate']:.0%} ({c['hits']} hits / "
            f"{c['misses']} misses), {c['entries']}/{c['capacity']} "
            f"entries, {c['evictions']} evictions")
        br = st["breaker"]
        out.append(
            f"control plane: shed={st['shed']} degraded={st['degraded']} "
            f"errors={st['errors']} retries={st['retries']} "
            f"probe_failures={st['probe_failures']} "
            f"breaker={br['state']}({br['opens']} opens) "
            f"flusher_deaths={st['flusher_deaths']} "
            f"restarts={st['flusher_restarts']} "
            f"queue_hwm={st['queue_depth_hwm']}")
        out.append(
            "reconciliation: requests == "
            + " + ".join(RECONCILE_BUCKETS)
            + (" OK" if st["reconciles"] else " VIOLATED"))
        if "chaos" in st:
            cs = st["chaos"]
            out.append(
                f"chaos: {cs['injected_failures']} failures, "
                f"{cs['injected_delays']} delays, "
                f"{cs['injected_kills']} kills injected over "
                f"{cs['launches']} probe launches")
    fl = snap.get("fleet")
    if fl is not None:
        c = fl["cache"]
        out.append(
            f"fleet: {fl['replica_count']} replicas "
            f"({fl['healthy_replicas']} healthy), routing="
            f"{fl['routing']}, {fl['requests']} requests, "
            f"{fl['failovers']} failovers, {fl['hedges']} hedges "
            f"({fl['hedge_cancelled']} cancelled); aggregate cache "
            f"hit_rate={c['hit_rate']:.0%} ({c['hits']} hits / "
            f"{c['misses']} misses)")
        rows = [["replica", "req", "scored", "cache", "dups", "shed",
                 "degr", "err", "hedge_x", "health", "recon"]]
        for r in fl["replicas"]:
            health = ("dead" if not r["alive"]
                      else r["breaker"] if r["breaker"] != "closed"
                      else "ok")
            rows.append([
                f"r{r['rid']}", str(r["requests"]),
                str(r["probe_scored"]), str(r["cache_hits"]),
                str(r["coalesced_dups"]), str(r["shed"]),
                str(r["degraded"]), str(r["errors"]),
                str(r["hedge_cancelled"]), health,
                "OK" if r["reconciles"] else "VIOLATED"])
        out.extend(_fmt_table(rows))
        out.append(
            "fleet reconciliation: requests == "
            + " + ".join(FLEET_RECONCILE_BUCKETS)
            + (" OK" if fl["reconciles"]
               and all(r["reconciles"] for r in fl["replicas"])
               else " VIOLATED"))
        if "chaos" in fl:
            cs = fl["chaos"]
            out.append(
                f"fleet chaos: {cs['injected_kills']} replica kills, "
                f"{cs['injected_slow']} slow dispatches, "
                f"{cs['injected_partitions']} partitioned over "
                f"{cs['dispatches']} fleet dispatches")
    s = snap.get("index")
    if s is not None:
        if snap.get("mutable"):
            last = (f"; last rebuild {s['last_rebuild_s']:.2f}s ("
                    + ("incremental" if s["last_rebuild_incremental"]
                       else "full") + ")") if s["rebuilds"] else ""
            out.append(
                f"mutable store: {s['inserts']} inserts, {s['deletes']} "
                f"deletes, {s['rebuilds']} background rebuilds "
                f"(generation {s['generation']}, version {s['version']}); "
                f"live {s['n_live']} = base {s['base_live']} "
                f"(+{s['base_dead']} tombstoned) + hot tail "
                f"{s['tail_live']}{last}")
            s = s["base_stats"]
        out.append(
            f"index: {s['probes']} pruned probes, "
            f"{s['rows_scanned']}/{s['rows_full_equiv']} rows scanned "
            f"(scan_fraction={s['scan_fraction']:.0%}) across "
            f"{s['launches']} kernel launches")
        if "per_shard" in s:
            fr = [p["scan_fraction"] for p in s["per_shard"]]
            out.append(
                "per-shard scan fraction: ["
                + ", ".join(f"{f:.0%}" for f in fr)
                + f"] (spread {s['spread']:.0%} = boundary-work "
                f"imbalance; probes pay the max, "
                f"{s['max_scan_fraction']:.0%})")
    lat = snap.get("latency_ms") or {}
    if any(h.get("count") for h in lat.values()):
        out.append("")
        out.append("latency (ms, exact percentiles):")
        rows = [["phase", "count", "p50", "p95", "p99", "max"]]
        for ph in _PHASES:
            h = lat.get(ph)
            if not h or not h.get("count"):
                continue
            rows.append([ph, str(h["count"])]
                        + [f"{h[k]:.2f}" for k in ("p50", "p95", "p99",
                                                   "max")])
        out.extend(_fmt_table(rows))
    qe = snap.get("qerror") or {}
    if any(h.get("count") for h in qe.values()):
        out.append("")
        out.append("estimator q-error (executed plans, truth known "
                   "post-execution):")
        rows = [["estimator", "plans", "p50", "p95", "p99", "max"]]
        for name in sorted(qe):
            h = qe[name]
            if not h.get("count"):
                continue
            rows.append([name, str(h["count"])]
                        + [f"{h[k]:.2f}" for k in ("p50", "p95", "p99",
                                                   "max")])
        out.extend(_fmt_table(rows))
    da = snap.get("degraded_answers", {})
    if da.get("interval_width", {}).get("count"):
        w = da["interval_width"]
        out.append(
            f"degraded answers: {w['count']} bound-only estimates, "
            f"interval width p50={w['p50']:.3f} max={w['max']:.3f}; "
            f"truth contained {da['bound_contained']}/"
            f"{da['bound_contained'] + da['bound_violations']}")
    if serve["queries"]:
        extra = ""
        if serve["degraded_plans"] or serve["failed_queries"]:
            extra = (f"; degraded plans {serve['degraded_plans']}, "
                     f"failed {serve['failed_queries']}")
        out.append(
            f"wall: {serve['wall_s']:.2f}s for {serve['queries']} "
            f"queries ({serve['qps']:.1f} qps){extra}")
    return "\n".join(out)


def write_json(snap: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(snap, f, indent=1, default=str)
        f.write("\n")

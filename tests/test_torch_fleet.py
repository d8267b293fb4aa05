"""The port's replicated serving fleet (``repro_torch.launch.fleet``):
vnode-ring properties, cache-affinity routing, health-checked failover,
hedging and the replica-kill storm, mirroring the reference's
``tests/test_fleet.py`` over the port's histogram on the CPU; and against
the reference itself: ring owners, config and chaos-spec parsing and the
``stats()`` keys are the reference's. The serve CLI's sharded fleet
(``--shards --balance-boundary --replicas``) runs end to end and its
answers are bitwise a lone unsharded replica's.

The load-bearing invariants, fleet edition:

  * ring balance — key distribution stays within 1.5x of uniform across
    R in {2, 3, 5} (property-tested over random key sets);
  * minimal disruption — removing a replica remaps only that replica's
    keys; every other key keeps its owner;
  * bitwise exactness — any exact fleet answer equals the single-replica
    oracle bit for bit, regardless of routing, failover, or hedging;
  * fleet reconciliation — per replica AND fleet-wide,
    ``requests == probe_scored + cache_hits + coalesced_dups + shed
    + degraded + errors + hedge_cancelled`` (asserted after every
    scenario, including the kill storm);
  * zero loss — killing a replica mid-storm loses no request: survivors
    absorb the traffic and every answer stays exact.
"""

import dataclasses
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.histogram import SemanticHistogram as JaxHistogram  # noqa: E402
from repro.launch import chaos as jax_chaos  # noqa: E402
from repro.launch import fleet as jax_fleet  # noqa: E402
from repro.launch.coalescer import CoalescerConfig as JaxCoalescerConfig  # noqa: E402,E501
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.chaos import (  # noqa: E402
    ChaosConfig,
    FleetChaos,
    FleetChaosConfig,
    ReplicaPartitionedError,
)
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCoalescer,
)
from repro_torch.launch.fleet import (  # noqa: E402
    FLEET_BUCKETS,
    FleetConfig,
    NoHealthyReplicaError,
    ReplicaSet,
    VnodeRing,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    HeartbeatRegistry,
    TransientError,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see test_torch_coalescer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_fleet_reconciles(st_):
    """The fleet invariant, fleet-wide and per replica."""
    assert st_["requests"] == sum(st_[b] for b in FLEET_BUCKETS), st_
    assert st_["reconciles"], st_
    for rep in st_["replicas"]:
        assert rep["requests"] == sum(rep[b] for b in FLEET_BUCKETS), rep
        assert rep["reconciles"], rep


def _wait_until(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition never became true")
        time.sleep(0.002)


def _keys(seed, n=4000):
    rng = np.random.default_rng(seed)
    return [rng.bytes(16) for _ in range(n)]


def _fleet(x, replicas=3, *, ccfg=None, fleet=None, chaos=None):
    hists = [SemanticHistogram(torch.from_numpy(x))
             for _ in range(replicas)]
    return ReplicaSet(
        hists,
        ccfg or CoalescerConfig(max_batch=64, window_ms=1.0),
        fleet=fleet or FleetConfig(replicas=replicas, heartbeat_ms=0.0),
        chaos=chaos)


# ------------------------------------------------------------- vnode ring


@given(seed=st.integers(0, 2**32 - 1))
@settings(max_examples=10, deadline=None)
def test_ring_balance_within_uniform(seed):
    """Key distribution within 1.5x of uniform, R in {2, 3, 5}."""
    keys = _keys(seed)
    for n_replicas in (2, 3, 5):
        ring = VnodeRing(range(n_replicas), vnodes=128)
        counts = {r: 0 for r in range(n_replicas)}
        for k in keys:
            counts[ring.owner(k)] += 1
        uniform = len(keys) / n_replicas
        assert max(counts.values()) <= 1.5 * uniform, counts
        assert min(counts.values()) > 0, counts


@given(seed=st.integers(0, 2**32 - 1),
       n_replicas=st.sampled_from([2, 3, 5]))
@settings(max_examples=10, deadline=None)
def test_ring_minimal_disruption(seed, n_replicas):
    """Removing a replica remaps ONLY that replica's keys."""
    keys = _keys(seed, n=1000)
    ring = VnodeRing(range(n_replicas), vnodes=128)
    before = {k: ring.owner(k) for k in keys}
    victim = before[keys[0]]            # guaranteed to own something
    after = ring.without(victim)
    assert victim not in after.replica_ids
    for k, owner in before.items():
        if owner != victim:
            assert after.owner(k) == owner   # untouched keys keep their home
        else:
            assert after.owner(k) != victim  # victim's keys go elsewhere


def test_ring_route_order_owner_first_and_complete():
    ring = VnodeRing(range(4), vnodes=64)
    for k in _keys(7, n=200):
        order = ring.route(k)
        assert order[0] == ring.owner(k)
        assert sorted(order) == [0, 1, 2, 3]   # full failover chain, no dups


def test_ring_is_stable_across_instances():
    # blake2b, not hash(): the ring must agree across processes/runs
    a, b = VnodeRing(range(3)), VnodeRing(range(3))
    assert all(a.owner(k) == b.owner(k) for k in _keys(3, n=500))


def test_ring_validates():
    with pytest.raises(ValueError, match="at least one replica"):
        VnodeRing([])
    with pytest.raises(ValueError, match="vnodes"):
        VnodeRing([0, 1], vnodes=0)


# ------------------------------------------------------ config / chaos spec


def test_fleet_config_validates():
    for bad in (dict(replicas=0), dict(routing="sticky"),
                dict(hedge_ms=-1.0), dict(heartbeat_ms=-5.0)):
        with pytest.raises(ValueError):
            FleetConfig(**bad)
    cfg = FleetConfig(heartbeat_ms=40.0)
    assert cfg.heartbeat_timeout_ms == 200.0    # 5 x heartbeat default


def test_fleet_chaos_spec_parses_both_layers():
    cfg = FleetChaosConfig.parse(
        "seed=9,replica-kill=1@6,replica-slow=2@3:25,partition=0@2-4,"
        "fail=0.25")
    assert (cfg.kill_replica, cfg.kill_at) == (1, 6)
    assert (cfg.slow_replica, cfg.slow_from, cfg.slow_ms) == (2, 3, 25.0)
    assert (cfg.partition_replica, cfg.partition_lo,
            cfg.partition_hi) == (0, 2, 4)
    # non-fleet keys delegate to the per-replica ChaosConfig
    assert cfg.base == ChaosConfig(seed=9, fail_rate=0.25)
    assert FleetChaosConfig.parse("replica-kill=0@1").base is None
    with pytest.raises(ValueError, match="unknown chaos key"):
        FleetChaosConfig.parse("frobnicate=1")


def test_fleet_chaos_fires_by_dispatch_ordinal():
    chaos = FleetChaos(FleetChaosConfig(
        kill_replica=1, kill_at=3, slow_replica=0, slow_from=4, slow_ms=1.0,
        partition_replica=2, partition_lo=2, partition_hi=2))
    acts = [chaos.on_dispatch(rid) for rid in (0, 2, 1, 0, 0)]
    assert acts[0].kills == () and not acts[0].partitioned
    assert acts[1].partitioned                 # rid 2 at ordinal 2
    assert acts[2].kills == (1,)               # ordinal 3
    assert acts[3].delay_ms == 1.0             # rid 0 from ordinal 4 on
    assert acts[4].delay_ms == 1.0
    s = chaos.stats()
    assert (s["dispatches"], s["injected_kills"], s["injected_slow"],
            s["injected_partitions"]) == (5, 1, 2, 1)


def test_heartbeat_freshness():
    hb = HeartbeatRegistry(timeout_s=1.0)
    assert not hb.fresh(0)                  # never beat -> not fresh
    assert hb.age_s(0) is None
    hb.beat(0, now=100.0)
    assert hb.fresh(0, now=100.5) and hb.age_s(0, now=100.5) == 0.5
    assert not hb.fresh(0, now=102.0)       # stale


# --------------------------------------------------- routing + exactness


def test_fleet_matches_single_replica_bitwise(rng):
    """Routing is invisible: every fleet answer == the oracle, bit for bit."""
    x = _unit_rows(rng, 400, 16)
    preds = _unit_rows(rng, 24, 16)
    thrs = np.linspace(0.2, 1.2, 24).astype(np.float32)
    oracle_hist = SemanticHistogram(torch.from_numpy(x))
    with PredicateCoalescer(oracle_hist,
                            CoalescerConfig(window_ms=1.0)) as oracle:
        want = oracle.probe_outcomes(preds, thrs)
    with _fleet(x, replicas=3) as fleet:
        got = fleet.probe_outcomes(preds, thrs)
        st_ = fleet.stats()
    assert [o.sel for o in got] == [o.sel for o in want]
    assert not any(o.degraded for o in got)
    _assert_fleet_reconciles(st_)
    # affinity actually spread the work: >1 replica took traffic
    assert sum(1 for r in st_["replicas"] if r["requests"]) > 1


def test_affinity_routes_to_ring_owner(rng):
    """Every request lands on (and is attributed to) its ring owner."""
    x = _unit_rows(rng, 300, 16)
    preds = _unit_rows(rng, 12, 16)
    thrs = np.full(12, 0.8, np.float32)
    with _fleet(x, replicas=3) as fleet:
        fleet.probe_outcomes(preds, thrs)
        owners = [fleet.ring.owner(fleet._route_key(p)) for p in preds]
        st_ = fleet.stats()
    for rid, rep in enumerate(st_["replicas"]):
        assert rep["requests"] == owners.count(rid)
    _assert_fleet_reconciles(st_)


def test_affinity_cache_partitions_beat_duplicated_caches(rng):
    """Affinity's point: R small affinity caches ~ one big cache,
    while random routing duplicates entries and thrashes."""
    x = _unit_rows(rng, 300, 16)
    hot = _unit_rows(rng, 9, 16)
    thrs = np.full(9, 0.8, np.float32)
    # per-replica capacity 10 holds any replica's affinity share of the
    # hot set, while random routing keeps re-missing on replicas that
    # never saw the key
    ccfg = CoalescerConfig(window_ms=1.0, cache_capacity=30)

    def hit_rate(routing):
        fleet_cfg = FleetConfig(replicas=3, routing=routing,
                                heartbeat_ms=0.0, seed=5)
        with _fleet(x, replicas=3, ccfg=ccfg, fleet=fleet_cfg) as fleet:
            for _ in range(5):              # 80%-hot style repeat traffic
                fleet.probe_outcomes(hot, thrs)
            st_ = fleet.stats()
        _assert_fleet_reconciles(st_)
        return st_["cache"]["hit_rate"]

    affinity, random_ = hit_rate("affinity"), hit_rate("random")
    assert affinity >= random_
    # affinity: pass 1 misses, passes 2-5 all hit -> exactly 36/45
    assert affinity == pytest.approx(0.8)


def test_cache_capacity_is_split_capacity_fair(rng):
    x = _unit_rows(rng, 100, 8)
    ccfg = CoalescerConfig(window_ms=1.0, cache_capacity=12)
    with _fleet(x, replicas=3, ccfg=ccfg) as fleet:
        caps = [rep.coalescer.cache.capacity for rep in fleet.replicas]
    assert caps == [4, 4, 4]    # aggregate == one single-replica cache


# ----------------------------------------------------- failover / health


def test_failover_reroutes_off_dead_replica(rng):
    x = _unit_rows(rng, 300, 16)
    preds = _unit_rows(rng, 12, 16)
    thrs = np.full(12, 0.8, np.float32)
    oracle_hist = SemanticHistogram(torch.from_numpy(x))
    with PredicateCoalescer(oracle_hist,
                            CoalescerConfig(window_ms=1.0)) as oracle:
        want = [o.sel for o in oracle.probe_outcomes(preds, thrs)]
    with _fleet(x, replicas=3) as fleet:
        victim = fleet.ring.owner(fleet._route_key(preds[0]))
        fleet.replicas[victim].kill()
        got = fleet.probe_outcomes(preds, thrs)
        st_ = fleet.stats()
        assert victim not in fleet.healthy_replicas()
    assert [o.sel for o in got] == want     # survivors answer exactly
    assert not any(o.degraded for o in got)
    assert st_["replicas"][victim]["requests"] == 0
    _assert_fleet_reconciles(st_)


def test_all_dead_degrades_to_certified_bounds(rng):
    x = _unit_rows(rng, 300, 16)
    preds = _unit_rows(rng, 4, 16)
    thrs = np.full(4, 0.8, np.float32)
    truth = SemanticHistogram(torch.from_numpy(x)).selectivity_batch(preds, thrs)
    with _fleet(x, replicas=2) as fleet:
        for rep in fleet.replicas:
            rep.kill()
        with pytest.raises(NoHealthyReplicaError):
            fleet.probe_outcomes(preds, thrs, degraded_ok=False)
        out = fleet.probe_outcomes(preds, thrs, degraded_ok=True)
        st_ = fleet.stats()
    for o, t in zip(out, truth):
        assert o.degraded
        assert o.lo - 1e-12 <= t <= o.hi + 1e-12  # certified, never wrong
    _assert_fleet_reconciles(st_)


def test_saturated_replica_is_skipped(rng, monkeypatch):
    """Backpressure: a deep per-replica queue removes it from routing."""
    x = _unit_rows(rng, 100, 8)
    fleet_cfg = FleetConfig(replicas=3, heartbeat_ms=0.0,
                            max_replica_queue=4)
    with _fleet(x, replicas=3, fleet=fleet_cfg) as fleet:
        assert fleet.healthy_replicas() == [0, 1, 2]
        monkeypatch.setattr(fleet.replicas[1].coalescer, "queue_depth",
                            lambda: 4)
        assert fleet.healthy_replicas() == [0, 2]
        out = fleet.probe_outcomes(_unit_rows(rng, 6, 8),
                                   np.full(6, 0.8, np.float32))
        st_ = fleet.stats()
    assert not any(o.degraded for o in out)
    assert st_["replicas"][1]["requests"] == 0
    _assert_fleet_reconciles(st_)


def test_partition_fails_over_then_heals(rng):
    x = _unit_rows(rng, 300, 16)
    preds = _unit_rows(rng, 8, 16)
    thrs = np.full(8, 0.8, np.float32)
    with _fleet(x, replicas=2) as probe_fleet:
        victim = probe_fleet.ring.owner(probe_fleet._route_key(preds[0]))
    chaos = FleetChaos(FleetChaosConfig(
        partition_replica=victim, partition_lo=1, partition_hi=2))
    with _fleet(x, replicas=2, chaos=chaos) as fleet:
        out = fleet.probe_outcomes(preds, thrs)
        st_ = fleet.stats()
    assert not any(o.degraded for o in out)       # failover absorbed it
    assert st_["failovers"] >= 1
    assert chaos.stats()["injected_partitions"] >= 1
    _assert_fleet_reconciles(st_)


def test_hedge_accounting_first_wins(rng):
    """A slow primary triggers a hedge; the loser resolves into
    hedge_cancelled and the invariant still balances exactly."""
    x = _unit_rows(rng, 300, 16)
    preds = _unit_rows(rng, 6, 16)
    thrs = np.full(6, 0.8, np.float32)
    with _fleet(x, replicas=2) as probe_fleet:
        slow = probe_fleet.ring.owner(probe_fleet._route_key(preds[0]))
        oracle = [o.sel for o in probe_fleet.probe_outcomes(preds, thrs)]
    # every dispatch to the owner sleeps 200ms; hedge fires at 10ms
    chaos = FleetChaos(FleetChaosConfig(
        slow_replica=slow, slow_from=1, slow_ms=200.0))
    fleet_cfg = FleetConfig(replicas=2, heartbeat_ms=0.0, hedge_ms=10.0)
    with _fleet(x, replicas=2, fleet=fleet_cfg, chaos=chaos) as fleet:
        out = fleet.probe_outcomes(preds, thrs)
        st_ = fleet.stats()
    assert [o.sel for o in out] == oracle   # hedged answers still exact
    assert st_["hedges"] >= 1
    # the slow replica owns preds[0]'s group and loses that race
    assert st_["replicas"][slow]["hedge_cancelled"] >= 1
    _assert_fleet_reconciles(st_)


# ------------------------------------------------------- the kill storm


def test_replica_kill_storm_zero_loss_bitwise_exact(rng):
    """The kill storm: concurrent submitters, one replica killed
    mid-storm by chaos. Zero requests lost, every answer bitwise equal
    to the single-replica oracle, exact reconciliation everywhere."""
    x = _unit_rows(rng, 400, 16)
    n_threads, per_thread = 4, 10
    batches = [_unit_rows(rng, per_thread, 16) for _ in range(n_threads)]
    thrs = np.linspace(0.3, 1.1, per_thread).astype(np.float32)

    oracle_hist = SemanticHistogram(torch.from_numpy(x))
    with PredicateCoalescer(oracle_hist,
                            CoalescerConfig(window_ms=1.0)) as oracle:
        want = [[o.sel for o in oracle.probe_outcomes(b, thrs)]
                for b in batches]

    chaos = FleetChaos(FleetChaosConfig(kill_replica=1, kill_at=3))
    got: list = [None] * n_threads
    errs: list = []
    with _fleet(x, replicas=3, chaos=chaos) as fleet:

        def storm(i):
            try:
                got[i] = fleet.probe_outcomes(batches[i], thrs)
            except Exception as e:  # noqa: BLE001 — zero-loss means none
                errs.append(e)

        threads = [threading.Thread(target=storm, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st_ = fleet.stats()
        assert not fleet.replicas[1].alive      # the kill really landed

    assert not errs                             # zero requests lost...
    for i in range(n_threads):
        assert [o.sel for o in got[i]] == want[i]   # ...and all exact
        assert not any(o.degraded for o in got[i])
    assert chaos.stats()["injected_kills"] == 1
    # every submitted predicate is attributed exactly once (no hedging)
    assert st_["requests"] == n_threads * per_thread
    _assert_fleet_reconciles(st_)


def test_stats_shape_matches_report_contract(rng):
    """obs/report.py renders these keys; drift breaks the exit summary."""
    x = _unit_rows(rng, 100, 8)
    chaos = FleetChaos(FleetChaosConfig())
    with _fleet(x, replicas=2, chaos=chaos) as fleet:
        fleet.probe_outcomes(_unit_rows(rng, 4, 8),
                             np.full(4, 0.8, np.float32))
        st_ = fleet.stats()
    for key in ("replica_count", "routing", "hedge_ms", "reconciles",
                "failovers", "hedges", "healthy_replicas", "cache",
                "chaos", "replicas") + ("requests",) + FLEET_BUCKETS:
        assert key in st_, key
    for rep in st_["replicas"]:
        for key in ("rid", "alive", "breaker", "queue_depth", "ewma_ms",
                    "coalescer") + ("requests",) + FLEET_BUCKETS:
            assert key in rep, key
    assert st_["cache"].keys() >= {"hits", "misses", "hit_rate"}


# ----------------------------------------------- against the reference


def test_ring_owners_and_routes_are_the_references():
    """blake2b vnodes: every key has the reference's owner and failover
    order, so a fleet of either package homes a predicate on one replica."""
    for n_replicas, vnodes in ((2, 128), (3, 128), (5, 16)):
        mine = VnodeRing(range(n_replicas), vnodes=vnodes)
        ref = jax_fleet.VnodeRing(range(n_replicas), vnodes=vnodes)
        for k in _keys(11 + n_replicas, n=300):
            assert mine.owner(k) == ref.owner(k)
            assert mine.route(k) == ref.route(k)
    mine, ref = VnodeRing(range(4)).without(2), \
        jax_fleet.VnodeRing(range(4)).without(2)
    assert all(mine.owner(k) == ref.owner(k) for k in _keys(5, n=200))


def test_fleet_config_and_chaos_spec_are_the_references():
    for kw in (dict(), dict(replicas=4, heartbeat_ms=40.0),
               dict(routing="random", hedge_ms=3.0, max_replica_queue=8)):
        assert dataclasses.asdict(FleetConfig(**kw)) == \
            dataclasses.asdict(jax_fleet.FleetConfig(**kw))
    for bad in (dict(replicas=0), dict(routing="sticky"),
                dict(hedge_ms=-1.0), dict(heartbeat_timeout_ms=-1.0)):
        with pytest.raises(ValueError) as mine:
            FleetConfig(**bad)
        with pytest.raises(ValueError) as ref:
            jax_fleet.FleetConfig(**bad)
        assert str(mine.value) == str(ref.value)
    for spec in ("seed=1,replica-kill=1@3,partition=2@1-4",
                 "seed=9,replica-kill=1@6,replica-slow=2@3:25,"
                 "partition=0@2-4,fail=0.25",
                 "replica-slow=0@1:5", "seed=3,delay=0.5,delay-ms=2"):
        mine, ref = FleetChaosConfig.parse(spec), \
            jax_chaos.FleetChaosConfig.parse(spec)
        base = mine.base
        assert dataclasses.asdict(dataclasses.replace(mine, base=None)) == \
            dataclasses.asdict(dataclasses.replace(ref, base=None))
        assert (base is None) == (ref.base is None)
        if base is not None:
            assert dataclasses.asdict(base) == dataclasses.asdict(ref.base)
    for bad in ("frobnicate=1", "replica-kill", "partition=1@x-2"):
        with pytest.raises(ValueError):
            FleetChaosConfig.parse(bad)
        with pytest.raises(ValueError):
            jax_chaos.FleetChaosConfig.parse(bad)


def test_stats_keys_are_the_references(rng):
    """The same traffic through a fleet of each package: the stats dicts
    have the same keys at every level, and the same request counts per
    replica (the ring homes every predicate on the same replica)."""
    x = _unit_rows(rng, 128, 8)
    preds = _unit_rows(rng, 10, 8)
    thrs = np.full(10, 0.8, np.float32)
    cfg = dict(replicas=3, heartbeat_ms=0.0)
    with ReplicaSet([SemanticHistogram(torch.from_numpy(x))
                     for _ in range(3)], CoalescerConfig(window_ms=1.0),
                    fleet=FleetConfig(**cfg),
                    chaos=FleetChaos(FleetChaosConfig())) as fleet:
        got = fleet.probe_outcomes(preds, thrs)
        mine = fleet.stats()
    with jax_fleet.ReplicaSet(
            [JaxHistogram(jnp.asarray(x)) for _ in range(3)],
            JaxCoalescerConfig(window_ms=1.0),
            fleet=jax_fleet.FleetConfig(**cfg),
            chaos=jax_chaos.FleetChaos(
                jax_chaos.FleetChaosConfig())) as ref_fleet:
        want = ref_fleet.probe_outcomes(preds, thrs)
        ref = ref_fleet.stats()

    def keys(d, path=""):
        out = set()
        for k, v in d.items():
            out.add(path + k)
            if isinstance(v, dict):
                out |= keys(v, path + k + ".")
        return out

    assert keys(mine) == keys(ref)
    for r_mine, r_ref in zip(mine["replicas"], ref["replicas"]):
        assert keys(r_mine) == keys(r_ref)
        assert r_mine["requests"] == r_ref["requests"]
    # the thresholds sit far from every distance: the selectivities agree
    assert [o.sel for o in got] == [o.sel for o in want]


def test_partitioned_dispatch_raises_a_transient_error(rng):
    """A partitioned dispatch raises ``ReplicaPartitionedError`` (transient:
    the router fails over) and resolves nothing on that replica."""
    x = _unit_rows(rng, 64, 8)
    chaos = FleetChaos(FleetChaosConfig(partition_replica=0, partition_lo=1,
                                        partition_hi=1))
    with _fleet(x, replicas=2, chaos=chaos) as fleet:
        with pytest.raises(ReplicaPartitionedError):
            fleet._try_dispatch(0, np.arange(2), _unit_rows(rng, 2, 8),
                                np.full(2, 0.8, np.float32), None)
        st_ = fleet.stats()
    assert issubclass(ReplicaPartitionedError, TransientError)
    assert st_["replicas"][0]["requests"] == 0


# ------------------------------------------------ the serve CLI's fleet


def test_serve_cli_shards_and_replicas_end_to_end(tmp_path):
    """``--shards 2 --index-clusters 8 --balance-boundary --concurrency 4
    --replicas 2`` builds a balanced sharded index behind a two-replica
    fleet; the fleet reconciles, no query fails, and every selectivity a
    plan used is bitwise a lone unsharded replica's probe of it."""
    path = tmp_path / "m.json"
    out = serve.main(["--shards", "2", "--index-clusters", "8",
                      "--balance-boundary", "--concurrency", "4",
                      "--replicas", "2", "--device", "cpu", "--vlm-smoke",
                      "--n-images", "600", "--queries", "3",
                      "--metrics-json", str(path)])
    snap = json.loads(path.read_text())
    fl = snap["fleet"]
    assert fl["reconciles"] and all(r["reconciles"] for r in fl["replicas"])
    assert fl["replica_count"] == 2 and "coalescer" not in snap
    assert snap["index"]["per_shard"] and len(snap["index"]["per_shard"]) == 2
    assert not out.failures and len(out.results) == 6
    assert out.stats["requests"] == 18
    corpus = serve.make_corpus("wildlife", n_images=600, seed=0)
    lone = SemanticHistogram(torch.from_numpy(corpus.images))
    for _, _, res in out.results:
        for node, e in zip(res.plan.filter_order, res.plan.estimates):
            want = lone.selectivity_batch(
                corpus.text_embedding(node, 0)[None],
                np.asarray([e.threshold], np.float32))[0]
            assert e.selectivity == want


def test_balance_boundary_needs_shards_and_clusters():
    for kw in (dict(balance_boundary=True, index_clusters=8),
               dict(balance_boundary=True, shards=2)):
        with pytest.raises(ValueError, match="needs --shards and "
                                             "--index-clusters"):
            serve.build_stack("wildlife", n_images=600, device="cpu", **kw)

"""The port's mutable store (``repro_torch.index.mutable``): streaming
inserts, tombstone deletes and background rebuilds over the pruned index.

The invariant, held bitwise within the port: after any sequence of insert /
delete / probe / rebuild, every probe answer (counts and top-k) equals a
fresh full scan over exactly the live rows. Against the reference's
mutable store after the same mutations, counts are exactly equal (the
thresholds sit in gaps between row distances) and top-k within 1e-4."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import settings, strategies as st  # noqa: E402
from hypothesis.stateful import (  # noqa: E402
    RuleBasedStateMachine,
    invariant,
    precondition,
    rule,
    run_state_machine_as_test,
)

from repro.index import MutableClusteredStore as JaxMutable  # noqa: E402
from repro.launch.coalescer import PredicateCache  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.index import MutableClusteredStore  # noqa: E402
from repro_torch.launch.mesh import make_probe_mesh  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the many small torch ops here would otherwise
    wait on descheduled threads, many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _mutable(x0, k, mesh=None, **kw):
    kw.setdefault("auto_rebuild", False)
    ms = MutableClusteredStore(x0, k, mesh=mesh, iters=3, device="cpu", **kw)
    return ms, SemanticHistogram(torch.from_numpy(x0), mesh=mesh, index=ms)


def _assert_probe_parity(hist, live_rows: dict, preds, thr, k, tag=""):
    """Counts and top-k of the mutable path against a fresh, index-free
    histogram over exactly the live rows: bitwise, batched and scalar."""
    xs = np.stack([live_rows[i] for i in sorted(live_rows)])
    oracle = SemanticHistogram(torch.from_numpy(xs))
    k = max(1, min(k, len(live_rows)))
    c, t = hist.probe_batch(preds, thr, k=k)
    co, to = oracle.probe_batch(preds, thr, k=k)
    assert torch.equal(c, co), f"{tag}: counts diverged"
    assert torch.equal(t, to), f"{tag}: top-k diverged"
    p0 = np.asarray(preds[0])
    t0 = float(np.asarray(thr).reshape(len(preds), -1)[0, 0])
    assert hist.count_within(p0, t0) == oracle.count_within(p0, t0), tag
    assert hist.kth_smallest_distance(p0, k) == \
        oracle.kth_smallest_distance(p0, k), tag
    assert np.array_equal(np.sort(hist.distances(p0)),
                          np.sort(oracle.distances(p0))), tag


# ------------------------------------------------- stateful parity machine


class MutationParityMachine(RuleBasedStateMachine):
    """Random insert / delete / probe / rebuild interleavings; every probe
    is checked against a fresh full scan of the live rows."""

    N0, D, K = 160, 24, 5

    def __init__(self):
        super().__init__()
        x0 = _unit(np.random.default_rng(1234), self.N0, self.D)
        self.ms, self.hist = _mutable(x0, self.K)
        self.live = {i: x0[i] for i in range(self.N0)}

    @rule(n=st.integers(1, 12), seed=st.integers(0, 2**16))
    def insert(self, n, seed):
        x = _unit(np.random.default_rng(seed), n, self.D)
        for i, row in zip(self.ms.insert(x), x):
            self.live[int(i)] = row

    @precondition(lambda m: m.ms.n_live > 8)
    @rule(n=st.integers(1, 6), seed=st.integers(0, 2**16))
    def delete(self, n, seed):
        rng = np.random.default_rng(seed)
        ids = sorted(self.live)
        picks = rng.choice(len(ids), size=min(n, len(ids) - 8),
                           replace=False)
        victims = [ids[i] for i in picks]
        if not victims:
            return
        self.ms.delete(victims)
        for v in victims:
            del self.live[v]

    @rule(seed=st.integers(0, 2**16), k=st.integers(1, 9),
          wide=st.booleans())
    def probe(self, seed, k, wide):
        rng = np.random.default_rng(seed)
        preds = _unit(rng, 2, self.D)
        hi = 1.9 if wide else 1.1
        thr = rng.uniform(0.5, hi, size=(2, 2)).astype(np.float32)
        _assert_probe_parity(self.hist, self.live, preds, thr, k,
                             tag=f"probe seed={seed}")

    @precondition(lambda m: m.ms.n_live >= m.K)
    @rule()
    def rebuild(self):
        gen = self.ms.generation
        assert self.ms.rebuild(wait=True)
        assert self.ms.generation == gen + 1

    @invariant()
    def live_count_matches(self):
        assert self.ms.n_live == len(self.live) == self.hist.n


def test_mutation_parity_stateful():
    run_state_machine_as_test(
        MutationParityMachine,
        settings=settings(max_examples=3, stateful_step_count=12,
                          deadline=None))


class ShardedMutationParityMachine(MutationParityMachine):
    """The same interleavings over the 4-shard store: a boundary-balanced
    sharded base probed shard by shard, the unsharded tail, remainder rows
    held back at every rebuild."""

    def __init__(self):
        RuleBasedStateMachine.__init__(self)
        x0 = _unit(np.random.default_rng(4321), self.N0, self.D)
        self.ms, self.hist = _mutable(x0, self.K,
                                      mesh=make_probe_mesh(4, device="cpu"))
        self.live = {i: x0[i] for i in range(self.N0)}

    @invariant()
    def shards_hold_equal_rows(self):
        st_ = self.ms.stats()
        assert st_["base_rows"] % 4 == 0
        assert st_["base_stats"]["per_shard"] is not None


def test_sharded_mutation_parity_stateful():
    run_state_machine_as_test(
        ShardedMutationParityMachine,
        settings=settings(max_examples=2, stateful_step_count=10,
                          deadline=None))


# ------------------------------------------------------- directed parity


def _gap_thresholds(rows, preds, ranks):
    d = np.sort(1.0 - preds.astype(np.float64) @ rows.astype(np.float64).T,
                axis=1)
    out = np.empty((len(preds), len(ranks)), np.float32)
    for b in range(len(preds)):
        ok = np.nonzero(np.diff(d[b]) > 2e-6)[0]
        for j, r in enumerate(ranks):
            i = ok[np.argmin(np.abs(ok - r))]
            out[b, j] = 0.5 * (d[b, i] + d[b, i + 1])
    return out


def test_insert_delete_probe_matches_fresh_scans_and_the_reference():
    """One mutation sequence on the port's store and the reference's:
    bitwise a fresh port scan after every step, and the reference's counts
    exactly (top-k within 1e-4), before and after a rebuild."""
    rng = np.random.default_rng(0)
    x0 = _unit(rng, 600, 64)
    ms, hist = _mutable(x0, 8)
    ref = JaxMutable(x0, 8, impl="xla", iters=3, auto_rebuild=False)
    live = {i: x0[i] for i in range(600)}
    preds = _unit(rng, 3, 64)
    for step in range(4):
        x = _unit(rng, 40, 64)
        ids = ms.insert(x)
        assert np.array_equal(ids, ref.insert(x))
        live.update({int(i): r for i, r in zip(ids, x)})
        victims = [int(v) for v in rng.choice(sorted(live), 30,
                                              replace=False)]
        ms.delete(victims)
        ref.delete(victims)
        for v in victims:
            del live[v]
        if step == 2:
            assert ms.rebuild(wait=True) and ref.rebuild(wait=True)
        rows = np.stack([live[i] for i in sorted(live)])
        thr = _gap_thresholds(rows, preds, [5, 120])
        _assert_probe_parity(hist, live, preds, thr, 9, tag=f"step {step}")
        c, t = ms.probe(preds, thr, k=9)
        rc, rt = ref.probe(preds, thr, k=9)
        assert np.array_equal(c, np.asarray(rc))
        np.testing.assert_allclose(t, np.asarray(rt), rtol=0, atol=TOL)
        assert ms.n_live == ref.n_live == len(live)
    assert ms.generation == 1 and ms.version == ref.version


def test_rebuild_reconciles_mid_build_mutations():
    """Inserts and deletes landing while the rebuild runs are reconciled at
    the swap: deletes of snapshotted rows become tombstones in the new base,
    fresh inserts stay in the new tail."""
    rng = np.random.default_rng(1)
    x0 = _unit(rng, 220, 24)
    ms, hist = _mutable(x0, 6)
    live = {i: x0[i] for i in range(220)}
    mid = {}

    def mutate_mid_build():
        fresh = _unit(np.random.default_rng(99), 9, 24)
        ids = ms.insert(fresh)
        mid.update({int(i): r for i, r in zip(ids, fresh)})
        mid["dels"] = [3, 11, int(ids[0])]
        ms.delete(mid["dels"])

    ms._pre_swap_hook = mutate_mid_build
    try:
        assert ms.rebuild(wait=True)
    finally:
        ms._pre_swap_hook = None
    dels = mid.pop("dels")
    live.update(mid)
    for i in dels:
        live.pop(i)
    assert ms.n_live == len(live)
    st_ = ms.stats()
    assert st_["base_dead"] == 2, "mid-build deletes must tombstone"
    assert st_["tail_live"] == 8
    preds = _unit(rng, 2, 24)
    thr = np.asarray([[0.8, 1.3]] * 2, np.float32)
    _assert_probe_parity(hist, live, preds, thr, 6)


def test_background_rebuild_never_blocks_serving():
    """While the rebuild thread waits before its swap, probes and mutations
    complete; after it, the new generation gives the same answers."""
    rng = np.random.default_rng(2)
    x0 = _unit(rng, 240, 24)
    ms, hist = _mutable(x0, 6)
    live = {i: x0[i] for i in range(240)}
    gate, entered = threading.Event(), threading.Event()

    def stall():
        entered.set()
        assert gate.wait(timeout=30.0)

    ms._pre_swap_hook = stall
    try:
        assert ms.rebuild(wait=False)
        assert entered.wait(timeout=30.0)
        t0 = time.monotonic()
        x = _unit(rng, 5, 24)
        live.update({int(i): r for i, r in zip(ms.insert(x), x)})
        ms.delete([1, 2])
        del live[1], live[2]
        preds = _unit(rng, 2, 24)
        thr = np.asarray([[0.9, 1.2]] * 2, np.float32)
        _assert_probe_parity(hist, live, preds, thr, 5, tag="gated")
        assert time.monotonic() - t0 < 20.0
        assert ms.generation == 0, "the swap must wait for the gate"
    finally:
        gate.set()
        ms._pre_swap_hook = None
    ms.drain_rebuild(timeout=60.0)
    assert not ms._rebuild_thread.is_alive()
    assert ms.generation == 1 and ms.last_rebuild_incremental
    _assert_probe_parity(hist, live, preds, thr, 5, tag="post-swap")


def test_rebuild_triggers():
    """The tail-fraction and dead-fraction triggers fire when due."""
    rng = np.random.default_rng(3)
    x0 = _unit(rng, 200, 16)
    ms, _ = _mutable(x0, 4, rebuild_tail_frac=0.2, rebuild_dead_frac=0.3,
                     auto_rebuild=True)
    assert not ms._due_locked()
    ms.insert(_unit(rng, 60, 16))     # tail 60/260 > 0.2 -> due
    ms.drain_rebuild(timeout=60.0)
    assert ms.rebuilds >= 1 and ms.stats()["tail_rows"] == 0
    ms.auto_rebuild = False
    ms.delete(list(range(80)))        # dead 80/260 > 0.3 -> due
    assert ms._due_locked()


def test_radius_inflation_tracked_on_delete():
    """Deleting a cluster's far rows shrinks its live extent: the tracked
    inflation (built radius / live tight radius) grows and can trigger."""
    rng0 = np.random.default_rng(5)
    a = _unit(rng0, 100, 16)
    c = _unit(rng0, 1, 16)[0]
    tight = (c[None] + 0.01 * rng0.standard_normal((100, 16))
             ).astype(np.float32)
    tight /= np.linalg.norm(tight, axis=1, keepdims=True)
    ms, _ = _mutable(np.concatenate([a, tight]), 2, rebuild_inflation=3.0)
    infl0 = ms.stats()["max_inflation"]
    order = np.argsort(-ms._cdist)
    ms.delete([int(ms._base_ids[p]) for p in order[:120]])
    assert ms.stats()["max_inflation"] > max(infl0, 1.5)


def test_delete_validates_before_applying():
    x0 = _unit(np.random.default_rng(6), 64, 8)
    ms, _ = _mutable(x0, 2)
    with pytest.raises(KeyError):
        ms.delete([0, 1, 10**9])          # unknown id: nothing applied
    with pytest.raises(KeyError):
        ms.delete([4, 4])                 # repeated id: nothing applied
    assert ms.n_live == 64
    ms.delete([3])
    with pytest.raises(KeyError):
        ms.delete([3])                    # double delete
    assert ms.n_live == 63


def test_count_bounds_contain_truth_under_mutation():
    rng = np.random.default_rng(7)
    x0 = _unit(rng, 300, 16)
    ms, hist = _mutable(x0, 6)
    ms.insert(_unit(rng, 40, 16))
    ms.delete(list(range(0, 300, 7)))
    preds = _unit(rng, 4, 16)
    thr = np.full(4, 0.9, np.float32)
    lo, hi = ms.count_bounds(preds, thr)
    c, _ = ms.probe(preds, thr)
    assert (lo <= c).all() and (c <= hi).all()
    slo, shi = hist.selectivity_bounds(preds, thr)
    assert np.array_equal(slo, lo[:, 0] / hist.n)


def test_cache_never_serves_stale_count_after_insert():
    rng = np.random.default_rng(8)
    x0 = _unit(rng, 200, 16)
    cache = PredicateCache(64)
    ms = MutableClusteredStore(x0, 4, iters=2, auto_rebuild=False,
                               device="cpu")
    hist = SemanticHistogram(torch.from_numpy(x0), cache=cache, index=ms)
    p = _unit(rng, 1, 16)
    before = hist.selectivity_batch(p, np.array([0.7], np.float32))
    ms.insert(np.repeat(p, 20, axis=0))   # 20 rows at distance 0
    after = hist.selectivity_batch(p, np.array([0.7], np.float32))
    assert hist.version == ms.version > 0
    assert after[0] * hist.n == before[0] * 200 + 20


def test_sharded_mutable_store_is_not_ported():
    """Once unported, the 4-shard mutable store now builds, and through
    inserts, deletes and rebuilds every probe is bitwise a fresh unsharded
    scan of the live rows. Each rebuild holds ``n_live % 4`` remainder rows
    back in the tail, as the reference does, and a remainder row deleted
    mid-rebuild stays deleted."""
    rng = np.random.default_rng(12)
    x0 = _unit(rng, 400, 32)
    mesh = make_probe_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="divide the mesh"):
        MutableClusteredStore(x0[:398], 4, mesh=mesh, device="cpu")
    ms, hist = _mutable(x0, 4, mesh=mesh)
    with pytest.raises(ValueError, match="carries its own mesh"):
        SemanticHistogram(torch.from_numpy(x0), index=ms)
    assert ms._base.n_shards == 4 and ms._base.balance == "boundary"
    live = {i: x0[i] for i in range(400)}
    preds = _unit(rng, 3, 32)
    thr = np.asarray([[0.5, 0.9], [0.7, 1.1], [0.9, 1.4]], np.float32)
    _assert_probe_parity(hist, live, preds, thr, 9, tag="built")
    x = _unit(rng, 23, 32)
    live.update({int(i): r for i, r in zip(ms.insert(x), x)})
    victims = [int(v) for v in rng.choice(sorted(live), 30, replace=False)]
    ms.delete(victims)
    for v in victims:
        del live[v]
    _assert_probe_parity(hist, live, preds, thr, 150, tag="mutated")
    for mode in ("and", "or"):
        rows = torch.from_numpy(np.stack([live[i] for i in sorted(live)]))
        fresh = SemanticHistogram(rows)
        assert hist.count_compound(preds, thr[:, 0], mode=mode) == \
            fresh.count_compound(preds, thr[:, 0], mode=mode)
    n_live = len(live)                      # 393: 1 remainder row
    last = max(live)

    def delete_the_remainder_row():
        ms.delete([last])

    ms._pre_swap_hook = delete_the_remainder_row
    try:
        assert ms.rebuild(wait=True)
    finally:
        ms._pre_swap_hook = None
    del live[last]
    st_ = ms.stats()
    assert st_["base_rows"] == n_live - n_live % 4
    assert st_["tail_rows"] == n_live % 4 - 1 == 0
    assert st_["last_rebuild_incremental"]
    _assert_probe_parity(hist, live, preds, thr, 9, tag="rebuilt")
    x = _unit(rng, 6, 32)
    live.update({int(i): r for i, r in zip(ms.insert(x), x)})
    assert ms.rebuild(wait=True)
    st_ = ms.stats()
    assert (st_["base_rows"], st_["tail_rows"]) == (396, 2)
    _assert_probe_parity(hist, live, preds, thr, 9, tag="rebuilt twice")
    lo, hi = ms.count_bounds(preds, thr[:, 0])
    true = hist.probe_batch(preds, thr[:, 0], k=1)[0][:, 0].numpy()
    assert (lo[:, 0] <= true).all() and (true <= hi[:, 0]).all()


def test_build_stack_with_ingest_puts_the_mutable_store_behind_the_histogram():
    from repro_torch.core.optimizer import generate_queries, plan_query
    from repro_torch.launch.serve import build_stack

    with pytest.raises(ValueError, match="index-clusters"):
        build_stack("wildlife", n_images=600, device="cpu", ingest=True)
    with pytest.raises(ValueError, match="index-clusters"):
        build_stack("wildlife", n_images=600, device="cpu", split_radius=0.3)
    corpus, est = build_stack("wildlife", n_images=600, vlm_smoke=True,
                              device="cpu", index_clusters=8, ingest=True,
                              rebuild_tail_frac=0.5)
    hist = est["ensemble"].hist
    assert isinstance(hist.index, MutableClusteredStore)
    assert hist.index.rebuild_tail_frac == 0.5
    q = generate_queries(corpus, n_queries=1, n_filters=2)[0]
    before = plan_query(q, est["ensemble"], compound=True)
    hist.index.insert(corpus.images[:50])
    assert hist.n == 650 and hist.version == 1
    after = plan_query(q, est["ensemble"], compound=True)
    sel = dict(zip(before.filter_order, before.estimates))
    for node, e in zip(after.filter_order, after.estimates):
        # 50 copies of stored rows joined: no count can drop
        assert round(e.selectivity * 650) >= round(sel[node].selectivity * 600)

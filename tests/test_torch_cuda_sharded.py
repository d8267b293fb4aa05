"""The port's sharded probes and fleet on the card: at S = 4 shards on one
device, the sharded full scan, the pruned scan over contiguous and
boundary-balanced indexes and the sharded mutable store are bitwise the
unsharded kernel probe, and a three-replica fleet over the sharded index
answers bitwise as a lone unsharded replica. Free of JAX, so it runs on a
machine with a card and no JAX; the CPU path is held to the reference by
``test_torch_sharded_index.py``, ``test_torch_mutable_index.py`` and
``test_torch_fleet.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro_torch.index import (  # noqa: E402
    MutableClusteredStore,
    build_sharded_clustered_store,
)
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCoalescer,
)
from repro_torch.launch.fleet import FleetConfig, ReplicaSet  # noqa: E402
from repro_torch.launch.mesh import make_probe_mesh  # noqa: E402

N, D, S = 8192, 256, 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")


def _store():
    x, _ = clustered_unit_vectors(N, D, n_centers=24, spread=0.25, seed=7,
                                  skew=1.2, grouped=True)
    return x


def _preds(x, seed, b):
    rng = np.random.default_rng(seed)
    p = x[rng.choice(len(x), b, replace=False)] \
        + 0.02 * rng.standard_normal((b, x.shape[1])).astype(np.float32)
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_sharded_full_and_pruned_probes_are_the_unsharded_probe():
    _card()
    x = _store()
    xt = torch.from_numpy(x).cuda()
    mesh = make_probe_mesh(S)
    bare = SemanticHistogram(xt)
    hists = {"full": SemanticHistogram(xt, mesh=mesh)}
    for balance in ("contiguous", "boundary"):
        idx = build_sharded_clustered_store(
            xt, 16, S, iters=4, balance=balance,
            split_radius=0.5 if balance == "boundary" else None)
        hists[balance] = SemanticHistogram(xt, mesh=mesh, index=idx)
    for b, k in ((1, 1), (3, 16), (27, 8), (200, 8), (3, N // S + 7)):
        preds = _preds(x, b + k, b)
        thr = np.stack([np.quantile(1.0 - x @ p, [0.002, 0.05])
                        for p in preds]).astype(np.float32)
        want = bare.probe_batch(preds, thr, k=k)
        for name, h in hists.items():
            assert _same(h.probe_batch(preds, thr, k=k), want), (name, b, k)
    p = _preds(x, 1, 1)[0]
    for name, h in hists.items():
        for k in (1, 100, N // S + 1, N):
            assert h.kth_smallest_distance(p, k) == \
                bare.kth_smallest_distance(p, k), (name, k)
        for mode in ("and", "or"):
            preds = _preds(x, 5, 3)
            thr = np.full(3, 0.3, np.float32)
            assert h.count_compound(preds, thr, mode=mode) == \
                bare.count_compound(preds, thr, mode=mode), (name, mode)


@pytest.mark.cuda
def test_sharded_mutable_store_is_a_fresh_scan_on_the_card():
    _card()
    rng = np.random.default_rng(3)
    x0 = _store()
    mesh = make_probe_mesh(S)
    ms = MutableClusteredStore(x0, 8, mesh=mesh, iters=3,
                               auto_rebuild=False)
    hist = SemanticHistogram(torch.from_numpy(x0).cuda(), mesh=mesh,
                             index=ms)
    live = {i: x0[i] for i in range(N)}
    preds = _preds(x0, 4, 5)
    thr = np.full((5, 1), 0.2, np.float32)

    def check(tag):
        xs = np.stack([live[i] for i in sorted(live)])
        fresh = SemanticHistogram(torch.from_numpy(xs).cuda())
        assert _same(hist.probe_batch(preds, thr, k=9),
                     fresh.probe_batch(preds, thr, k=9)), tag
        assert hist.count_compound(preds[:3], thr[:3, 0]) == \
            fresh.count_compound(preds[:3], thr[:3, 0]), tag

    check("built")
    x = _preds(x0, 8, 301)
    live.update({int(i): r for i, r in zip(ms.insert(x), x)})
    dead = [int(v) for v in rng.choice(sorted(live), 500, replace=False)]
    ms.delete(dead)
    for v in dead:
        del live[v]
    check("mutated")
    assert ms.rebuild(wait=True)
    assert ms.stats()["base_rows"] % S == 0
    check("rebuilt")


@pytest.mark.cuda
def test_fleet_over_the_sharded_index_is_a_lone_replica():
    """Three replicas' flushers and hedges launch from their own threads
    over one sharded index: every answer bitwise a lone unsharded
    coalescer's."""
    _card()
    x = _store()
    xt = torch.from_numpy(x).cuda()
    mesh = make_probe_mesh(S)
    idx = build_sharded_clustered_store(xt, 16, S, iters=4,
                                        balance="boundary")
    preds = _preds(x, 11, 48)
    thrs = np.quantile(1.0 - preds @ x.T, 0.01, axis=1).astype(np.float32)
    with PredicateCoalescer(SemanticHistogram(xt),
                            CoalescerConfig(window_ms=1.0)) as lone:
        want = [o.sel for o in lone.probe_outcomes(preds, thrs)]
    hists = [SemanticHistogram(xt, mesh=mesh, index=idx) for _ in range(3)]
    with ReplicaSet(hists, CoalescerConfig(window_ms=1.0),
                    fleet=FleetConfig(replicas=3, hedge_ms=1.0)) as fleet:
        got = [o.sel for o in fleet.probe_outcomes(preds, thrs)]
        st = fleet.stats()
    assert got == want
    assert st["reconciles"]
    assert st["requests"] == 48 + st["hedge_cancelled"]

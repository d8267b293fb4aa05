"""The port's sharded probes (``repro_torch.launch.mesh``,
``repro_torch.index.sharded`` and the sharded paths of
``repro_torch.core.histogram``) on the CPU.

Against the reference: the contiguous and boundary-balanced builds give the
reference's partition exactly (the shard of every row, each shard's perm
and offsets, the boundary masses); counts are exactly the reference's
unsharded histogram's (every threshold sits in a gap between two adjacent
row distances) and top-k within 1e-4; a probe sequence leaves the
reference's per-shard scan statistics, on the reference's own partition
carried over (``ShardedClusteredStore.from_partition``), held in one
4-device subprocess that also gives the reference's shard order on a
("pod", "data") mesh. Within the port everything is bitwise: a sharded
full scan, pruned or not, contiguous or balanced, equals the unsharded
probe — a row's distance does not depend on the shard it sits in."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.histogram import SemanticHistogram as JaxHistogram  # noqa: E402
from repro.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro.index import build_sharded_clustered_store as jax_build  # noqa: E402
from repro_torch.core.histogram import (  # noqa: E402
    SemanticHistogram,
    make_sharded_probe,
    make_sharded_pruned_probe,
)
from repro_torch.index import (  # noqa: E402
    ShardedClusteredStore,
    build_clustered_store,
    build_sharded_clustered_store,
)
from repro_torch.launch.mesh import (  # noqa: E402
    ProbeMesh,
    data_axes,
    make_probe_mesh,
    mesh_axis_sizes,
)

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see test_torch_cluster_index.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gap_thresholds(rows, preds, ranks):
    """(B, len(ranks)) f32 thresholds at the midpoint of a gap > 2e-6
    between adjacent float64 row distances, near each rank."""
    d = 1.0 - preds.astype(np.float64) @ rows.astype(np.float64).T
    out = np.empty((len(preds), len(ranks)), np.float32)
    for b in range(len(preds)):
        s = np.sort(d[b])
        ok = np.nonzero(np.diff(s) > 2e-6)[0]
        for j, r in enumerate(ranks):
            i = ok[np.argmin(np.abs(ok - min(r, len(s) - 2)))]
            out[b, j] = 0.5 * (s[i] + s[i + 1])
    return out


# the two corpora: uniform clumps at a small width, and Zipf-skewed clumps
# in concept order (the case boundary balancing is for) at the presets'
# embedding width
CORPORA = {
    "uniform": dict(n=1200, dim=48, n_centers=10, spread=0.22, seed=1),
    "skewed": dict(n=1200, dim=1152, n_centers=10, spread=0.22, seed=2,
                   skew=1.3, grouped=True),
}


@functools.lru_cache(maxsize=2)
def _corpus(name):
    kw = dict(CORPORA[name])
    x, _ = clustered_unit_vectors(kw.pop("n"), kw.pop("dim"), **kw)
    return x


@functools.lru_cache(maxsize=8)
def _built(name, shards, balance):
    x = _corpus(name)
    sr = 0.35 if balance == "boundary" else None
    ref = jax_build(x, 10, shards, iters=4, impl="xla", balance=balance,
                    split_radius=sr)
    port = build_sharded_clustered_store(x, 10, shards, iters=4,
                                         balance=balance, split_radius=sr,
                                         device="cpu")
    return ref, port


def _preds(x, seed, b):
    """Predicates near store rows (so every selectivity is reachable)."""
    rng = np.random.default_rng(seed)
    p = x[rng.choice(len(x), b, replace=False)] \
        + 0.3 * rng.standard_normal((b, x.shape[1])).astype(np.float32) \
        / np.sqrt(x.shape[1])
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


# -------------------------------------------------------------- the mesh


def test_probe_mesh_shapes_and_validation(monkeypatch):
    mesh = make_probe_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4} and mesh.size == 4
    assert mesh_axis_sizes(mesh) == {"data": 4}
    assert data_axes(mesh) == ("data",)
    assert mesh.shard_devices == (torch.device("cpu"),) * 4
    pod = ProbeMesh([torch.device("cuda", i) for i in range(8)],
                    {"pod": 2, "data": 4})
    assert data_axes(pod) == ("pod", "data")
    with pytest.raises(ValueError, match="devices for a mesh"):
        ProbeMesh([torch.device("cpu")] * 3, {"data": 4})
    with pytest.raises(ValueError, match="shards over"):
        ProbeMesh([torch.device("cpu")] * 4, {"data": 2, "model": 2})
    with pytest.raises(ValueError, match="n_shards"):
        make_probe_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_probe_mesh(4)
    assert make_probe_mesh(2, device="cpu").devices == \
        (torch.device("cpu"),) * 2


# --------------------------------------------------------- the partition


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("balance", ["contiguous", "boundary"])
def test_builds_give_the_references_partition(corpus, shards, balance):
    """The port's own build (k-means through the port's assignment, the
    reference's host packers) lands every row on the reference's shard, in
    the reference's order within it. A k-means near-tie (two centroids'
    scores within ~1e-7, which the two float32 matmul orders may break
    differently) would move one row; these corpora hold none, and a probe
    does not depend on the partition either way."""
    ref, port = _built(corpus, shards, balance)
    x = _corpus(corpus)
    assert (port.n_shards, port.shard_rows, port.balance) == \
        (ref.n_shards, ref.shard_rows, ref.balance)
    assert np.array_equal(port.perm, ref.perm)
    for a, b in zip(ref.shards, port.shards):
        assert np.array_equal(a.perm, b.perm)
        assert np.array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(b.radii, a.radii, rtol=1e-9, atol=0)
    np.testing.assert_allclose(port.boundary_mass(), ref.boundary_mass(),
                               rtol=1e-9, atol=0)
    if balance == "boundary":
        np.testing.assert_allclose(port.contiguous_mass, ref.contiguous_mass,
                                   rtol=1e-9, atol=0)
        if corpus == "skewed":
            # the packer's objective: on a store in concept order the max
            # per-shard mass shrinks against the contiguous build's
            contig = _built(corpus, shards, "contiguous")[1]
            assert port.boundary_mass().max() < contig.boundary_mass().max()
    else:
        assert port.contiguous_mass is None
    # one reordered store: the shards are views of its blocks
    assert np.array_equal(port.embeddings.numpy(), x[port.perm])
    for s, cs in enumerate(port.shards):
        assert cs.embeddings.data_ptr() == \
            port.embeddings[s * port.shard_rows].data_ptr()
    st = port.stats()
    assert st["spread"] == 0.0 and st["max_shard_rows_scanned"] == 0


def test_from_partition_carries_the_references_state():
    ref, _ = _built("uniform", 4, "boundary")
    x = _corpus("uniform")
    parts = [dict(perm=ref.perm[s * ref.shard_rows:(s + 1) * ref.shard_rows],
                  offsets=cs.offsets, centroids=cs.centroids, radii=cs.radii,
                  max_row_norm=cs.max_row_norm)
             for s, cs in enumerate(ref.shards)]
    port = ShardedClusteredStore.from_partition(
        x, parts, balance="boundary", contiguous_mass=ref.contiguous_mass,
        device="cpu")
    assert np.array_equal(port.perm, ref.perm)
    assert np.array_equal(port.embeddings.numpy(), np.asarray(ref.embeddings))
    assert np.array_equal(port.boundary_mass(), ref.boundary_mass())
    preds = _preds(x, 3, 4)
    thr = gap_thresholds(x, preds, [5, 200])
    for a, b in zip(ref.plan_shards(preds, thr, k=7),
                    port.plan_shards(preds, thr, k=7)):
        assert np.array_equal(a.scan_ids, b.scan_ids)
        assert (a.m, a.boundary_clusters) == (b.m, b.boundary_clusters)
        assert np.array_equal(a.extra, b.extra)
    for a, b in zip(ref.count_bounds(preds, thr),
                    port.count_bounds(preds, thr)):
        assert np.array_equal(a, b)


# -------------------------------------------------- the sharded probes


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_full_scan_is_the_unsharded_probe(shards):
    """Bitwise the port's unsharded probe (counts, top-k, k past a shard's
    rows, scalar and batched, compound); the reference's unsharded
    histogram under the parity contract."""
    x = _corpus("uniform")
    xt = torch.from_numpy(x)
    mesh = make_probe_mesh(shards, device="cpu")
    full = SemanticHistogram(xt, mesh=mesh)
    bare = SemanticHistogram(xt)
    ref = JaxHistogram(jnp.asarray(x), impl="xla")
    preds = _preds(x, shards, 5)
    thr = gap_thresholds(x, preds, [3, 60, 700])
    rows = len(x) // shards
    for k in (1, 7, rows + 5):
        c, t = full.probe_batch(preds, thr, k=k)
        cb, tb = bare.probe_batch(preds, thr, k=k)
        assert torch.equal(c, cb) and torch.equal(t, tb), k
        cr, tr = ref.probe_batch(preds, thr, k=k)
        assert np.array_equal(c.numpy(), np.asarray(cr))
        np.testing.assert_allclose(t.numpy(), np.asarray(tr), rtol=0,
                                   atol=TOL)
    for j in range(3):
        assert full.count_within(preds[j], float(thr[j, 1])) == \
            bare.count_within(preds[j], float(thr[j, 1])) == \
            ref.count_within(preds[j], float(thr[j, 1]))
        for k in (1, rows, rows + 1, len(x)):
            assert full.kth_smallest_distance(preds[j], k) == \
                bare.kth_smallest_distance(preds[j], k)
    assert np.array_equal(full.kth_smallest_batch(preds, rows + 3),
                          bare.kth_smallest_batch(preds, rows + 3))
    for mode in ("and", "or"):
        assert full.count_compound(preds[:3], thr[:3, 1], mode=mode) == \
            bare.count_compound(preds[:3], thr[:3, 1], mode=mode) == \
            ref.count_compound(preds[:3], thr[:3, 1], mode=mode)
    # the factory itself, scalar, on the store or on placed blocks
    probe = make_sharded_probe(mesh, k=9)
    pc, pt = probe(xt, torch.from_numpy(preds[0]), torch.from_numpy(thr[0]))
    bc, bt = bare.probe_batch(preds[:1], thr[:1], k=9)
    assert torch.equal(pc, bc[0]) and torch.equal(pt, bt[0])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("balance", ["contiguous", "boundary"])
def test_sharded_pruned_is_bitwise_the_sharded_full_scan(shards, balance):
    """Scalar, batched, B > 128, count-only (``need_topk=False``), k-th
    distances past a shard's rows and compound and/or: the pruned sharded
    probe is bitwise the full-scan sharded probe, and reads fewer rows at
    low selectivity."""
    x = _corpus("uniform")
    xt = torch.from_numpy(x)
    mesh = make_probe_mesh(shards, device="cpu")
    idx = build_sharded_clustered_store(
        x, 10, shards, iters=4, balance=balance, device="cpu",
        split_radius=0.35 if balance == "boundary" else None)
    full = SemanticHistogram(xt, mesh=mesh)
    pruned = SemanticHistogram(xt, mesh=mesh, index=idx)
    preds = _preds(x, 10 + shards, 6)
    thr = gap_thresholds(x, preds, [2, 40, 600])
    for k in (1, 9, idx.shard_rows + 2):
        a, b = pruned.probe_batch(preds, thr, k=k), \
            full.probe_batch(preds, thr, k=k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), k
    wide = _preds(x, 99, 130)                 # past the reference's block_b
    wthr = gap_thresholds(x, wide, [30])
    a, b = pruned.probe_batch(wide, wthr, k=4), full.probe_batch(wide, wthr,
                                                                 k=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert np.array_equal(pruned.selectivity_batch(preds, thr[:, 0]),
                          full.selectivity_batch(preds, thr[:, 0]))
    for j in range(3):
        for t in (*thr[j], -0.1, 2.5):
            assert pruned.count_within(preds[j], float(t)) == \
                full.count_within(preds[j], float(t))
        for k in (1, 30, idx.shard_rows + 1, len(x)):
            assert pruned.kth_smallest_distance(preds[j], k) == \
                full.kth_smallest_distance(preds[j], k)
    for mode in ("and", "or"):
        for b in (2, 4):
            assert pruned.count_compound(preds[:b], thr[:b, 1], mode=mode) \
                == full.count_compound(preds[:b], thr[:b, 1], mode=mode)
    lo, hi = pruned.selectivity_bounds(preds, thr[:, 1])
    true = full.selectivity_batch(preds, thr[:, 1])
    assert (lo <= true).all() and (true <= hi).all()
    idx.reset_stats()
    pruned.count_within(preds[0], float(thr[0, 0]))
    st = idx.stats()
    assert st["probes"] == 1 and len(st["per_shard"]) == shards
    assert st["rows_full_equiv"] == len(x)
    assert st["rows_scanned"] == sum(p["rows_scanned"]
                                     for p in st["per_shard"])
    assert st["scan_fraction"] < 0.5


def test_a_fully_resolved_count_launches_nothing():
    x = _corpus("uniform")
    mesh = make_probe_mesh(4, device="cpu")
    idx = build_sharded_clustered_store(x, 10, 4, iters=4, device="cpu")
    hist = SemanticHistogram(torch.from_numpy(x), mesh=mesh, index=idx)
    assert hist.count_within(x[3], 2.5) == len(x)
    assert hist.count_within(x[3], -0.1) == 0
    st = idx.stats()
    assert (st["launches"], st["rows_scanned"], st["probes"]) == (0, 0, 2)
    probe = make_sharded_pruned_probe(mesh, idx, k=5, batched=True)
    c, t = probe(x[:2], np.full((2, 1), 2.5, np.float32), need_topk=False)
    assert (c == len(x)).all() and np.isinf(t).all()


def test_build_and_histogram_validation():
    """The reference's ``test_build_and_histogram_validation`` messages."""
    x, _ = clustered_unit_vectors(400, 32, n_centers=4, spread=0.2, seed=1)
    with pytest.raises(ValueError, match="divide evenly"):
        build_sharded_clustered_store(x, 4, 3, device="cpu")
    with pytest.raises(ValueError, match=r"shard_rows=200"):
        build_sharded_clustered_store(x, 201, 2, device="cpu")
    with pytest.raises(ValueError, match="k_clusters=0"):
        build_sharded_clustered_store(x, 0, 2, device="cpu")
    with pytest.raises(ValueError, match="balance="):
        build_sharded_clustered_store(x, 4, 2, balance="bogus", device="cpu")
    with pytest.raises(ValueError, match="warm-start requires"):
        build_sharded_clustered_store(x, 4, 2, shard_hint=np.zeros(400),
                                      device="cpu")
    xt = torch.from_numpy(x)
    sidx = build_sharded_clustered_store(x, 4, 2, iters=2, device="cpu")
    with pytest.raises(ValueError, match="needs mesh"):
        SemanticHistogram(xt, index=sidx)
    mesh1 = make_probe_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="rebuild the index"):
        SemanticHistogram(xt, mesh=mesh1, index=sidx)
    flat = build_clustered_store(x, 4, iters=2, device="cpu")
    with pytest.raises(ValueError, match="ShardedClusteredStore"):
        SemanticHistogram(xt, mesh=mesh1, index=flat)
    with pytest.raises(ValueError, match="divide the mesh"):
        SemanticHistogram(xt[:399], mesh=make_probe_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="rebuild the index"):
        make_sharded_pruned_probe(mesh1, sidx)


# -------------------------------- against the reference, on 4 devices

REF_SCRIPT = """
    from jax.sharding import Mesh
    from repro.core.histogram import SemanticHistogram
    from repro.core.synthetic import clustered_unit_vectors
    from repro.index import build_sharded_clustered_store
    from repro.launch.mesh import make_probe_mesh

    out = {"order": {}, "runs": {}}
    devs = np.asarray(jax.devices()[:4])
    for axes in (("pod", "data"), ("data", "pod")):
        mesh = Mesh(devs.reshape(2, 2), axes)
        pos = {d.id: i for i, d in enumerate(mesh.devices.flat)}
        arr = jax.device_put(jnp.arange(8.0).reshape(8, 1),
                             NamedSharding(mesh, P(("pod", "data"))))
        order = [None] * 4
        for sh in arr.addressable_shards:
            order[sh.index[0].start // 2] = pos[sh.device.id]
        out["order"]["".join(a[0] for a in axes)] = order

    x, _ = clustered_unit_vectors(800, 32, n_centers=8, spread=0.25, seed=4,
                                  skew=1.2, grouped=True)
    mesh = make_probe_mesh(4)
    preds = x[[3, 250, 611]]
    d = 1.0 - preds.astype(np.float64) @ x.astype(np.float64).T
    thr = []                        # midpoints of gaps > 2e-6, near ranks
    for b, rank in enumerate((10, 80, 300)):
        s = np.sort(d[b])
        ok = np.nonzero(np.diff(s) > 2e-6)[0]
        i = ok[np.argmin(np.abs(ok - rank))]
        thr.append(float(np.float32(0.5 * (s[i] + s[i + 1]))))
    thr3 = np.asarray(thr, np.float32)
    thr_low = thr[0]
    for balance in ("contiguous", "boundary"):
        sidx = build_sharded_clustered_store(
            x, 6, 4, iters=3, impl="xla", balance=balance,
            split_radius=0.4 if balance == "boundary" else None)
        hist = SemanticHistogram(jnp.asarray(x), mesh=mesh, index=sidx)
        res = {"counts": [], "topk": [], "stats": []}
        res["counts"].append(hist.count_within(x[3], thr_low))
        res["stats"].append(sidx.stats())
        c, t = hist.probe_batch(preds, thr3, k=5)
        res["counts"].append(np.asarray(c).tolist())
        res["topk"].append(np.asarray(t).tolist())
        res["stats"].append(sidx.stats())
        res["topk"].append(hist.kth_smallest_distance(x[250], 300))
        res["stats"].append(sidx.stats())
        res["counts"].append(hist.count_compound(preds, thr3, mode="or"))
        res["stats"].append(sidx.stats())
        res["parts"] = [
            {"perm": sidx.perm[s * 200:(s + 1) * 200].tolist(),
             "offsets": cs.offsets.tolist(),
             "centroids": cs.centroids.tolist(),
             "radii": cs.radii.tolist(), "max_row_norm": cs.max_row_norm}
            for s, cs in enumerate(sidx.shards)]
        res["thr"] = thr
        out["runs"][balance] = res
    print(json.dumps(out))
"""


def test_stats_and_shard_order_match_the_reference(run_multidevice):
    """One 4-device subprocess of the reference: on its own partition
    (carried over), the port's pruned sharded probes give its counts and
    leave its per-shard scan statistics after every probe; a
    ("pod", "data") mesh orders its shards as ``P(("pod", "data"))``
    does, whichever order the mesh lists its axes in."""
    out = run_multidevice(REF_SCRIPT, devices=4, timeout=300)
    cuda = [torch.device("cuda", i) for i in range(4)]
    for tag, shape in (("pd", {"pod": 2, "data": 2}),
                       ("dp", {"data": 2, "pod": 2})):
        mesh = ProbeMesh(cuda, shape)
        assert [d.index for d in mesh.shard_devices] == out["order"][tag]
    x, _ = clustered_unit_vectors(800, 32, n_centers=8, spread=0.25, seed=4,
                                  skew=1.2, grouped=True)
    mesh = make_probe_mesh(4, device="cpu")
    preds = x[[3, 250, 611]]
    for balance, res in out["runs"].items():
        parts = [{k: np.asarray(v) if isinstance(v, list) else v
                  for k, v in p.items()} for p in res["parts"]]
        sidx = ShardedClusteredStore.from_partition(x, parts,
                                                    balance=balance,
                                                    device="cpu")
        hist = SemanticHistogram(torch.from_numpy(x), mesh=mesh, index=sidx)
        thr3 = np.asarray(res["thr"], np.float32)
        stats = []
        assert hist.count_within(x[3], res["thr"][0]) == res["counts"][0]
        stats.append(sidx.stats())
        c, t = hist.probe_batch(preds, thr3, k=5)
        assert c.tolist() == res["counts"][1]
        np.testing.assert_allclose(t.numpy(), res["topk"][0], rtol=0,
                                   atol=TOL)
        stats.append(sidx.stats())
        assert abs(hist.kth_smallest_distance(x[250], 300)
                   - res["topk"][1]) < TOL
        stats.append(sidx.stats())
        assert hist.count_compound(preds, thr3, mode="or") == \
            res["counts"][2]
        stats.append(sidx.stats())
        for mine, ref in zip(stats, res["stats"]):
            assert mine == ref, balance

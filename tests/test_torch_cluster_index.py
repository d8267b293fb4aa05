"""The port's cluster-pruned index (``repro_torch.index.clustered``) and the
masked / rowmask probes it and the mutable store scan through.

Against the reference (``impl="xla"``): counts exactly equal — every
threshold sits in a gap between two adjacent row distances — and distances
within 1e-4. The partition is the reference's own (``_assemble_store`` on
its centroids and assignment), so no k-means near-tie can make the two
disagree. Within the port everything is bitwise: a row's distance does not
depend on where it sits, so a pruned probe equals the full scan."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.index import clustered as jax_clustered  # noqa: E402
from repro.kernels.cosine_topk import ref as jax_ref  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro_torch.index import clustered  # noqa: E402
from repro_torch.kernels.cosine_topk import ops, ref  # noqa: E402

N, D = 2048, 1152      # the corpus presets' embedding width
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


@functools.lru_cache(maxsize=1)
def _store():
    x, _ = clustered_unit_vectors(N, D, n_centers=16, spread=0.25, seed=0)
    return x


@functools.lru_cache(maxsize=4)
def _pair(k):
    """(reference ClusteredStore, the port's on the same partition)."""
    x = _store()
    cs = jax_clustered.build_clustered_store(x, k, iters=6, seed=0,
                                             impl="xla")
    assign = np.empty(N, np.int64)
    assign[cs.perm] = np.repeat(np.arange(cs.k_clusters), cs.sizes)
    port = clustered._assemble_store(torch.from_numpy(x), cs.centroids,
                                     assign, eps=cs.eps,
                                     chunk_rows=cs.chunk_rows)
    return cs, port


def _preds(seed, b):
    """Predicates near store rows (so every selectivity is reachable)."""
    rng = np.random.default_rng(seed)
    x = _store()
    p = x[rng.choice(N, b, replace=False)] + 0.3 * _unit(rng, b, D)
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------- the probes


@pytest.mark.parametrize("m,b,t,k", [
    (300, 5, 2, 7), (2048, 3, 1, 16), (100, 1, 3, 128), (0, 2, 1, 4),
    (1500, 37, 2, 9)])
def test_masked_and_rowmask_ops_match_the_reference(m, b, t, k):
    rng = np.random.default_rng(m + b)
    x = _unit(rng, 2048, D)
    preds = _unit(rng, b, D)
    live = max(m, 2)
    thr = gap_thresholds(x[:live], preds,
                         sorted(rng.integers(0, live - 1, t)))
    k_eff = min(k, len(x))
    want = jax_ref.cosine_probe_batch_masked_ref(
        jnp.asarray(x), m, jnp.asarray(preds), jnp.asarray(thr), k_eff)
    got = ops.cosine_probe_batch_masked(torch.from_numpy(x), m,
                                        torch.from_numpy(preds),
                                        torch.from_numpy(thr), k=k)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=TOL)
    c1, t1 = ops.cosine_probe_masked(torch.from_numpy(x), m,
                                     torch.from_numpy(preds[0]),
                                     torch.from_numpy(thr[0]), k=k)
    assert torch.equal(c1, got[0][0]) and torch.equal(t1, got[1][0])

    mask = (rng.random(len(x)) < 0.3).astype(np.int32)
    if m:
        mask[m:] = 0
    thr = gap_thresholds(x[mask != 0], preds,
                         sorted(rng.integers(0, int(mask.sum()) - 1, t)))
    want = jax_ref.cosine_probe_batch_rowmask_ref(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(preds),
        jnp.asarray(thr), k_eff)
    got = ops.cosine_probe_batch_rowmask(
        torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(preds),
        torch.from_numpy(thr), k=k)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=TOL)
    c1, t1 = ops.cosine_probe_rowmask(
        torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(preds[0]), torch.from_numpy(thr[0]), k=k)
    assert torch.equal(c1, got[0][0]) and torch.equal(t1, got[1][0])
    dead = ops.cosine_probe_batch_rowmask(
        torch.from_numpy(x), torch.zeros(len(x), dtype=torch.int32),
        torch.from_numpy(preds), torch.from_numpy(thr), k=k)
    assert not dead[0].any() and torch.isinf(dead[1]).all()


def test_a_rows_distance_does_not_depend_on_where_it_sits():
    """The plain probe's row-locality: a row scores the same bits in a full
    scan, a shifted slice, a gathered subset and at any B — what keeps the
    pruned, masked and mutable paths bitwise the full scan on the CPU."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_unit(rng, 8192, D))
    p = torch.from_numpy(_unit(rng, 37, D))
    full = ref.cosine_distances(x, p)
    for b in (1, 3, 8, 37):
        for off, size in ((0, 1), (5, 7), (333, 4096), (8191, 1)):
            part = ref.cosine_distances(x[off:off + size], p[:b])
            assert torch.equal(part, full[:b, off:off + size]), (b, off, size)
    idx = torch.from_numpy(rng.choice(8192, 700, replace=False))
    for j in (0, 17, 36):
        assert torch.equal(ref.cosine_distances(x[idx], p[j:j + 1]),
                           full[j:j + 1, idx])
    # and the probes built on it: a masked buffer, a rowmask buffer and a
    # gathered subset give the full scan's counts and top-k bitwise
    thr = torch.full((37, 1), 0.95)
    mask = torch.zeros(8192, dtype=torch.int32)
    mask[idx] = 1
    sub = ops.cosine_probe_batch(x[idx], p, thr, k=50)
    masked = ops.cosine_probe_batch_rowmask(x, mask, p, thr, k=50)
    assert torch.equal(sub[0], masked[0]) and torch.equal(sub[1], masked[1])
    prefix = ops.cosine_probe_batch_masked(x, 4000, p, thr, k=50)
    head = ops.cosine_probe_batch(x[:4000], p, thr, k=50)
    assert torch.equal(prefix[0], head[0]) and torch.equal(prefix[1], head[1])


# -------------------------------------------------------- the partition


@pytest.mark.parametrize("k", [1, 16, 64])
def test_assemble_store_matches_the_reference(k):
    cs, port = _pair(k)
    assert np.array_equal(port.offsets, cs.offsets)
    assert np.array_equal(port.sizes, cs.sizes)
    assert np.array_equal(port.perm, cs.perm)
    np.testing.assert_allclose(port.radii, cs.radii, rtol=1e-12, atol=0)
    assert abs(port.max_row_norm - cs.max_row_norm) < 1e-12
    assert np.array_equal(port.embeddings.numpy(), np.asarray(cs.embeddings))


@pytest.mark.parametrize("k", [16, 64])
def test_plans_and_bounds_match_the_reference(k):
    cs, port = _pair(k)
    preds = _preds(k, 6)
    for ranks in ([2], [20, 400], [1000]):
        thr = gap_thresholds(_store(), preds, ranks)
        for need_topk, kk in ((False, 1), (True, 1), (True, 50)):
            a = cs.plan_scan(preds, thr, k=kk, need_topk=need_topk)
            b = port.plan_scan(preds, thr, k=kk, need_topk=need_topk)
            assert np.array_equal(a.scan_ids, b.scan_ids)
            assert (a.m, a.boundary_clusters) == (b.m, b.boundary_clusters)
            assert np.array_equal(a.extra, b.extra)
        for x, y in zip(cs.count_bounds(preds, thr),
                        port.count_bounds(preds, thr)):
            assert np.array_equal(x, y)
        for mode in ("and", "or"):
            a = cs.plan_compound(preds[:3], thr[:3, 0], mode=mode)
            b = port.plan_compound(preds[:3], thr[:3, 0], mode=mode)
            assert np.array_equal(a.scan_ids, b.scan_ids)
            assert np.array_equal(a.extra, b.extra)


@pytest.mark.parametrize("k", [1, 16, 64])
def test_probe_pruned_and_kth_match_the_reference(k):
    cs, port = _pair(k)
    preds = _preds(100 + k, 5)
    thr = gap_thresholds(_store(), preds, [3, 60, 900])
    for kk in (1, 40):
        c1, t1, _ = cs.probe_pruned(preds, thr, k=kk, impl="xla")
        c2, t2, _ = port.probe_pruned(preds, thr, k=kk)
        assert np.array_equal(c1, c2)
        np.testing.assert_allclose(t2, np.asarray(t1), rtol=0, atol=TOL)
    for j in range(3):
        for kk in (1, 25, N):
            assert abs(port.kth_smallest(preds[j], kk)
                       - cs.kth_smallest(preds[j], kk, impl="xla")) < TOL


# ------------------------------------------- within the port: bitwise


@pytest.mark.parametrize("k", [1, 16, 64])
def test_pruned_is_bitwise_the_full_scan(k):
    _, port = _pair(k)
    x = torch.from_numpy(_store())
    port.reset_stats()
    for sel in (0.001, 0.01, 0.1, 0.5):
        preds = _preds(int(sel * 1e4) + k, 4)
        thr = np.asarray([[np.sort(1.0 - _store() @ p)[int(sel * N)]]
                          for p in preds], np.float32)
        for kk in (1, 30):
            c, t, st = port.probe_pruned(preds, thr, k=kk)
            fc, ft = ops.cosine_probe_batch(x, torch.from_numpy(preds),
                                            torch.from_numpy(thr), k=kk)
            assert np.array_equal(c, fc.numpy()), (sel, kk)
            assert np.array_equal(t, ft.numpy()), (sel, kk)
            c1, t1, _ = port.probe_pruned(preds[:1], thr[:1], k=kk)
            f1 = ops.cosine_probe(x, torch.from_numpy(preds[0]),
                                  torch.from_numpy(thr[0]), k=kk)
            assert np.array_equal(c1[0], f1[0].numpy())
            assert np.array_equal(t1[0], f1[1].numpy())
            assert np.array_equal(c1[0], c[0]) and np.array_equal(t1[0], t[0])
        for kk in (1, 7, 300):
            want = ops.cosine_probe(x, torch.from_numpy(preds[1]),
                                    torch.zeros(1), k=kk)[1][kk - 1]
            assert port.kth_smallest(preds[1], kk) == float(want)
    if k > 1:
        assert port.stats()["scan_fraction"] < 1.0


def test_histogram_routes_through_the_index():
    cs, port = _pair(16)
    x = torch.from_numpy(_store())
    bare = SemanticHistogram(x)
    hist = SemanticHistogram(x, index=port)
    preds = _preds(5, 6)
    thr = gap_thresholds(_store(), preds, [10, 300])
    for kk in (1, 12):
        a, b = bare.probe_batch(preds, thr, k=kk), hist.probe_batch(
            preds, thr, k=kk)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert np.array_equal(bare.selectivity_batch(preds, thr[:, 0]),
                          hist.selectivity_batch(preds, thr[:, 0]))
    for j in range(3):
        assert bare.count_within(preds[j], float(thr[j, 1])) == \
            hist.count_within(preds[j], float(thr[j, 1]))
        assert bare.kth_smallest_distance(preds[j], 33) == \
            hist.kth_smallest_distance(preds[j], 33)
    ref_lo, ref_hi = cs.count_bounds(preds, thr[:, 0])
    lo, hi = hist.selectivity_bounds(preds, thr[:, 0])
    assert np.array_equal(lo, ref_lo[:, 0] / N)
    assert np.array_equal(hi, ref_hi[:, 0] / N)
    true = hist.selectivity_batch(preds, thr[:, 0])
    assert (lo <= true).all() and (true <= hi).all()


def test_mismatched_index_rejected():
    _, port = _pair(16)
    x = _store()
    with pytest.raises(ValueError, match="rows"):
        SemanticHistogram(torch.from_numpy(x[:100]), index=port)
    with pytest.raises(ValueError, match="disagree"):
        SemanticHistogram(torch.from_numpy(x[::-1].copy()), index=port)


def test_split_fat_clusters_matches_the_reference():
    """The splitter is the reference's host numpy: the same inputs give the
    same centroids and assignment, and a split build stays exact."""
    x = _store()
    cs, _ = _pair(16)
    assign = np.empty(N, np.int64)
    assign[cs.perm] = np.repeat(np.arange(cs.k_clusters), cs.sizes)
    kw = dict(split_radius=0.3, max_clusters=40)
    c1, a1 = jax_clustered._split_fat_clusters(x, cs.centroids, assign, **kw)
    c2, a2 = clustered._split_fat_clusters(x, cs.centroids, assign, **kw)
    assert np.array_equal(c1, c2) and np.array_equal(a1, a2)
    assert len(c2) > cs.k_clusters
    split = clustered.build_clustered_store(x, 16, iters=4, split_radius=0.3,
                                            device="cpu")
    plain = clustered.build_clustered_store(x, 16, iters=4, device="cpu")
    assert split.k_clusters > plain.k_clusters
    assert split.radii.max() < plain.radii.max()
    preds = _preds(9, 3)
    thr = gap_thresholds(x, preds, [40])
    full = ops.cosine_probe_batch(torch.from_numpy(x),
                                  torch.from_numpy(preds),
                                  torch.from_numpy(thr), k=5)
    c, t, _ = split.probe_pruned(preds, thr, k=5)
    assert np.array_equal(c, full[0].numpy())
    assert np.array_equal(t, full[1].numpy())


def test_store_from_fragments_matches_the_reference():
    x = _store()
    rng = np.random.default_rng(3)
    rows = rng.permutation(N)[:1500]
    frags = [(rows[i::3], x[rows[i::3]].mean(axis=0).astype(np.float64))
             for i in range(3)]
    a = jax_clustered.store_from_fragments(x, frags)
    b = clustered.store_from_fragments(x, frags, device="cpu")
    assert np.array_equal(a.perm, b.perm)
    assert np.array_equal(a.offsets, b.offsets)
    np.testing.assert_allclose(b.radii, a.radii, rtol=1e-12, atol=0)


def test_build_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clustered.build_clustered_store(_store()[:64], 2)

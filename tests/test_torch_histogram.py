"""Every ported public method of the port's ``SemanticHistogram`` against the
reference's (``impl="xla"``) on a ``make_corpus`` store: counts exactly
equal (thresholds sit in gaps between adjacent row distances), distances
within 1e-4."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.histogram import SemanticHistogram as JaxHistogram  # noqa: E402
from repro.core.synthetic import make_corpus  # noqa: E402
from repro.launch.coalescer import PredicateCache  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.launch.mesh import make_probe_mesh  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    corpus = make_corpus("wildlife", n_images=700, seed=0)
    nodes = corpus.predicate_nodes()[:6]
    preds = np.stack([corpus.text_embedding(n) for n in nodes])
    d = 1.0 - preds.astype(np.float64) @ corpus.images.astype(np.float64).T
    thr = np.empty((len(preds), 3), np.float32)
    for b in range(len(preds)):          # midpoints of gaps > 2e-6
        s = np.sort(d[b])
        ok = np.nonzero(np.diff(s) > 2e-6)[0]
        for j, rank in enumerate((5, 100, 400)):
            i = ok[np.argmin(np.abs(ok - rank))]
            thr[b, j] = 0.5 * (s[i] + s[i + 1])
    ref = JaxHistogram(jnp.asarray(corpus.images), impl="xla")
    port = SemanticHistogram(torch.from_numpy(corpus.images))
    return corpus, preds, thr, ref, port


def test_size_and_version(setup):
    corpus, _, _, ref, port = setup
    assert port.n == ref.n == len(corpus.images)
    assert port.version == ref.version == 0


def test_scalar_methods(setup):
    _, preds, thr, ref, port = setup
    for b in range(len(preds)):
        for j in range(thr.shape[1]):
            t = float(thr[b, j])
            assert port.count_within(preds[b], t) == ref.count_within(
                preds[b], t)
            assert port.selectivity(preds[b], t) == ref.selectivity(
                preds[b], t)
        for k in (1, 17, port.n, port.n + 5):
            assert abs(port.kth_smallest_distance(preds[b], k)
                       - ref.kth_smallest_distance(preds[b], k)) < TOL
        np.testing.assert_allclose(port.distances(preds[b]),
                                   ref.distances(preds[b]), rtol=0, atol=TOL)


def test_batched_methods(setup):
    _, preds, thr, ref, port = setup
    for k in (1, 9, 700):
        c1, t1 = ref.probe_batch(preds, thr, k=k)
        c2, t2 = port.probe_batch(preds, thr, k=k)
        assert np.array_equal(np.asarray(c1), c2.numpy())
        np.testing.assert_allclose(t2.numpy(), np.asarray(t1), rtol=0,
                                   atol=TOL)
    assert np.array_equal(port.selectivity_batch(preds, thr[:, 1]),
                          ref.selectivity_batch(preds, thr[:, 1]))
    np.testing.assert_allclose(port.kth_smallest_batch(preds, 33),
                               ref.kth_smallest_batch(preds, 33), rtol=0,
                               atol=TOL)
    lo, hi = port.selectivity_bounds(preds, thr[:, 0])
    rlo, rhi = ref.selectivity_bounds(preds, thr[:, 0])
    assert np.array_equal(lo, rlo) and np.array_equal(hi, rhi)


def _cached_probes(corpus, preds, thr, device):
    cache = PredicateCache(64)
    hist = SemanticHistogram(torch.from_numpy(corpus.images).to(device),
                             cache=cache)
    fresh = hist.probe_batch(preds, thr, k=4, use_cache=False)
    first = hist.probe_batch(preds[:3], thr[:3], k=4)       # 3 misses
    assert (cache.hits, cache.misses) == (0, 3)
    second = hist.probe_batch(preds, thr, k=4)              # 3 hits, 3 misses
    assert (cache.hits, cache.misses) == (3, 6)
    third = hist.probe_batch(preds, thr, k=4)               # all hits
    assert cache.hits == 9
    return fresh, first, second, third


def test_cache_hit_is_bitwise_the_fresh_probe(setup):
    """A hit returns exactly what the probe that filled it returned, and
    that is bitwise the fresh probe of the whole batch: the plain version's
    distances are row-local, so the misses probed alone score as they do
    inside the batch (the kernel does the same on the card:
    ``test_torch_cuda_histogram.py``)."""
    corpus, preds, thr, _, _ = setup
    fresh, first, second, third = _cached_probes(corpus, preds, thr, "cpu")
    for c, t in (second, third):
        assert torch.equal(c[:3], first[0]) and torch.equal(t[:3], first[1])
        assert torch.equal(third[0], c) and torch.equal(third[1], t)
        assert torch.equal(c, fresh[0]) and torch.equal(t, fresh[1])


def test_unported_paths_raise(setup):
    """Sharding, once the one histogram path not ported, now routes: with
    ``mesh=`` every public method probes shard by shard and answers
    bitwise as the unsharded histogram (the reference's counts exactly),
    and the wiring is validated with the reference's messages. The
    compound probe matches the reference."""
    corpus, preds, thr, ref, port = setup
    x = torch.from_numpy(corpus.images)
    mesh = make_probe_mesh(4, device="cpu")
    sharded = SemanticHistogram(x, mesh=mesh)
    for k in (1, 9, 200):
        c, t = sharded.probe_batch(preds, thr, k=k)
        cp, tp = port.probe_batch(preds, thr, k=k)
        assert torch.equal(c, cp) and torch.equal(t, tp), k
        assert np.array_equal(c.numpy(), np.asarray(
            ref.probe_batch(preds, thr, k=k)[0]))
    assert np.array_equal(sharded.selectivity_batch(preds, thr[:, 1]),
                          port.selectivity_batch(preds, thr[:, 1]))
    assert sharded.count_within(preds[0], float(thr[0, 0])) == \
        ref.count_within(preds[0], float(thr[0, 0]))
    assert sharded.kth_smallest_distance(preds[1], 300) == \
        port.kth_smallest_distance(preds[1], 300)
    for mode in ("and", "or"):
        assert port.count_compound(preds[:2], thr[:2, 2], mode=mode) == \
            sharded.count_compound(preds[:2], thr[:2, 2], mode=mode) == \
            ref.count_compound(preds[:2], thr[:2, 2], mode=mode)
    with pytest.raises(ValueError, match="divide the mesh"):
        SemanticHistogram(x[:-1], mesh=mesh)
    with pytest.raises(ValueError, match="no 'pod'/'data' axis"):
        SemanticHistogram(x, mesh=SimpleNamespace(shape={"model": 4}))

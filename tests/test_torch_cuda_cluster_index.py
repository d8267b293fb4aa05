"""The port's cluster-pruned index on the card: a pruned probe is bitwise
the full-scan kernel's answer, because the probe kernel gives a row the
same distance in a gathered buffer as in the store. Free of JAX, so it
runs on a machine with a card and no JAX; the CPU path is held to the
reference by ``test_torch_cluster_index.py``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.synthetic import clustered_unit_vectors  # noqa: E402
from repro_torch.index import clustered  # noqa: E402
from repro_torch.kernels.cosine_topk import ops  # noqa: E402

N, D = 2048, 1152      # the corpus presets' embedding width


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


def _preds(seed, b):
    """Predicates near store rows (so every selectivity is reachable)."""
    rng = np.random.default_rng(seed)
    x = _store()
    p = x[rng.choice(N, b, replace=False)] + 0.3 * _unit(rng, b, D)
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.cuda
def test_pruned_is_bitwise_the_full_scan_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    x = torch.from_numpy(_store()).cuda()
    idx = clustered.build_clustered_store(x, 16, iters=4)
    preds = _preds(11, 5)
    thr = gap_thresholds(_store(), preds, [5, 200])
    c, t, _ = idx.probe_pruned(preds, thr, k=20)
    fc, ft = ops.cosine_probe_batch(x, torch.from_numpy(preds).cuda(),
                                    torch.from_numpy(thr).cuda(), k=20)
    assert np.array_equal(c, fc.cpu().numpy())
    assert np.array_equal(t, ft.cpu().numpy())

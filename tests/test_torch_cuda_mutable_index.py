"""The port's mutable store on the card: after inserts and deletes, counts,
top-k and a compound count through ``SemanticHistogram(index=...)`` are
bitwise a fresh kernel scan of exactly the live rows. Free of JAX, so it
runs on a machine with a card and no JAX; the CPU path is held to the
reference by ``test_torch_mutable_index.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.index import MutableClusteredStore  # noqa: E402


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.cuda
def test_mutable_probe_is_bitwise_a_fresh_scan_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    rng = np.random.default_rng(9)
    x0 = _unit(rng, 3000, 96)
    ms = MutableClusteredStore(x0, 8, iters=3, auto_rebuild=False)
    hist = SemanticHistogram(torch.from_numpy(x0).cuda(), index=ms)
    live = {i: x0[i] for i in range(3000)}
    x = _unit(rng, 100, 96)
    live.update({int(i): r for i, r in zip(ms.insert(x), x)})
    ms.delete([0, 5, 3001])
    for v in (0, 5, 3001):
        del live[v]
    xs = np.stack([live[i] for i in sorted(live)])
    oracle = SemanticHistogram(torch.from_numpy(xs).cuda())
    preds = _unit(rng, 3, 96)
    thr = np.full((3, 1), 0.9, np.float32)
    c, t = hist.probe_batch(preds, thr, k=7)
    co, to = oracle.probe_batch(preds, thr, k=7)
    assert torch.equal(c, co) and torch.equal(t, to)
    assert hist.count_compound(preds, thr[:, 0]) == \
        oracle.count_compound(preds, thr[:, 0])

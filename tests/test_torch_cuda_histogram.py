"""A cache hit of the port's ``SemanticHistogram`` is bitwise the fresh
probe on the card: the probe kernel gives a row the same distance inside
any batch, so misses probed alone score as they do inside the batch. Free
of JAX (the corpus is the port's ``make_corpus``; the cache a small LRU
with the reference ``PredicateCache``'s key/get/put), so it runs on a
machine with a card and no JAX; the CPU path is held to the reference by
``test_torch_histogram.py``."""

from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.synthetic import make_corpus  # noqa: E402


class LRUCache:
    """The probe-cache interface ``SemanticHistogram(cache=)`` uses: a key
    of the quantized embedding, thresholds, k and store version; counted
    hits and misses; least recently used entries evicted past capacity."""

    def __init__(self, capacity: int, bits: int = 12):
        self.capacity, self.bits = capacity, bits
        self._od: OrderedDict = OrderedDict()
        self.hits = self.misses = 0

    def key(self, emb, thresholds, k, version=0):
        scale = float(1 << self.bits)
        q = np.round(np.asarray(emb, np.float64) * scale).astype(np.int32)
        t = np.round(np.atleast_1d(np.asarray(thresholds, np.float64))
                     * scale).astype(np.int32)
        return (q.tobytes(), t.tobytes(), int(k), int(version))

    def get(self, key):
        val = self._od.get(key)
        if val is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return val

    def put(self, key, value):
        self._od[key] = value
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)


def _setup():
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
    return corpus, preds, thr


def _cached_probes(corpus, preds, thr, device):
    cache = LRUCache(64)
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


@pytest.mark.cuda
def test_cache_hit_is_bitwise_the_fresh_probe_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    corpus, preds, thr = _setup()
    fresh, first, second, third = _cached_probes(corpus, preds, thr, "cuda")
    for c, t in (second, third):
        assert torch.equal(c, fresh[0]) and torch.equal(t, fresh[1])
    assert torch.equal(first[1], fresh[1][:3])

"""The port's corpus, predicates, oracle answers, training data and queries
are bitwise the reference's for the same seed."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import optimizer as ref_opt  # noqa: E402
from repro.core import synthetic as ref_syn  # noqa: E402
from repro_torch.core import optimizer as port_opt  # noqa: E402
from repro_torch.core import synthetic as port_syn  # noqa: E402


@pytest.mark.parametrize("name", ["wildlife", "artwork", "ecommerce"])
def test_corpus_bitwise(name, monkeypatch):
    a = ref_syn.make_corpus(name, n_images=700, dim=96, seed=3)
    b = port_syn.make_corpus(name, n_images=700, dim=96, seed=3)
    assert np.array_equal(a.images, b.images)
    assert a.images.dtype == b.images.dtype == np.float32
    assert np.array_equal(a.image_leaf, b.image_leaf)
    assert sorted(a.concepts) == sorted(b.concepts)
    for nid, ca in a.concepts.items():
        cb = b.concepts[nid]
        assert np.array_equal(ca.direction, cb.direction)
        assert np.array_equal(ca.leaf_image_ids, cb.leaf_image_ids)
        assert (ca.depth, ca.parent, ca.children) == (cb.depth, cb.parent,
                                                      cb.children)
    for nid in list(a.concepts)[:12]:
        assert np.array_equal(a.text_embedding(nid, seed=5),
                              b.text_embedding(nid, seed=5))
        ids = np.arange(0, 700, 3)
        assert np.array_equal(a.vlm_answer(nid, ids, seed=2),
                              b.vlm_answer(nid, ids, seed=2))
    # the KV-batch sample's 32 rows, on the port's binary search and on its
    # dense mask
    sample = np.sort(np.random.default_rng(6).choice(700, 32, replace=False))
    for lookup in (True, False):
        with monkeypatch.context() as m:
            m.setattr(port_syn, "_lookup_wins", lambda k, mm, n: lookup)
            for nid in a.concepts:
                assert np.array_equal(a.vlm_answer(nid, sample, seed=7),
                                      b.vlm_answer(nid, sample, seed=7))
    Xa, ya = ref_syn.specificity_dataset(a, n_samples=60, subset=128, seed=1)
    Xb, yb = port_syn.specificity_dataset(b, n_samples=60, subset=128, seed=1)
    assert np.array_equal(Xa, Xb) and np.array_equal(ya, yb)
    qa = ref_opt.generate_queries(a, n_queries=6, n_filters=3, seed=4)
    qb = port_opt.generate_queries(b, n_queries=6, n_filters=3, seed=4)
    assert [list(map(int, q)) for q in qa] == [list(map(int, q)) for q in qb]


def test_corpus_bitwise_full_width():
    """The default 1152-wide embeddings, the width the store holds."""
    a = ref_syn.make_corpus("wildlife", n_images=300, seed=0)
    b = port_syn.make_corpus("wildlife", n_images=300, seed=0)
    assert a.images.shape == (300, 1152)
    assert np.array_equal(a.images, b.images)
    node = a.predicate_nodes()[0]
    assert np.array_equal(a.text_embedding(node), b.text_embedding(node))

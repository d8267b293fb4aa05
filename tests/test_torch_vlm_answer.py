"""``Corpus.vlm_answer``'s two paths, the binary search of a node's match
list and the dense mask of every row, give bitwise the answers of a plain
dense oracle, on a ``make_corpus`` corpus and on one whose match lists are
contiguous ``np.arange`` ranges (as a store laid out by subtree has them),
for any requested ids; a list out of order still answers right; the sizes
pick the path, and a bound phase clock counts the calls and the dense ones."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import phases  # noqa: E402
from repro_torch.core import synthetic as syn  # noqa: E402

N_BIG = 1 << 20


def oracle(corpus, node_id, image_ids, seed):
    truth = np.zeros(len(corpus.images), bool)
    truth[corpus.concepts[node_id].leaf_image_ids] = True
    ans = truth[np.asarray(image_ids, np.int64)]
    u = np.random.default_rng(node_id * 104729 + seed).random(len(image_ids))
    fn = ans & (u < corpus.vlm_error)
    fp = (~ans) & (u < corpus.vlm_error / 8.0)
    return np.where(fn, False, np.where(fp, True, ans))


def _made():
    return syn.make_corpus("wildlife", n_images=700, dim=16, seed=3)


def _contiguous(base=None):
    """``base``'s tree with its images laid out leaf by leaf in depth-first
    order, every node's matches the ``np.arange`` of its subtree's rows."""
    base = base or _made()
    order, span = [], {}

    def walk(nid):
        lo = len(order)
        c = base.concepts[nid]
        if not c.children:
            order.extend(np.flatnonzero(base.image_leaf == nid).tolist())
        for ch in c.children:
            walk(ch)
        span[nid] = (lo, len(order))

    walk(0)
    concepts = {
        nid: syn.Concept(c.node_id, c.depth, c.parent, list(c.children),
                         c.direction, c.name,
                         np.arange(*span[nid], dtype=np.int64))
        for nid, c in base.concepts.items()}
    order = np.asarray(order)
    return syn.Corpus(base.name, base.dim, base.images[order],
                      base.image_leaf[order], concepts, base.text_noise,
                      base.vlm_error, np.random.default_rng(0))


def _with_empty(corpus):
    """``corpus`` with one more leaf under the root that matches nothing."""
    nid = max(corpus.concepts) + 1
    corpus.concepts[nid] = syn.Concept(nid, 1, 0, [], corpus.concepts[0]
                                       .direction, "empty",
                                       np.array([], np.int64))
    corpus.concepts[0].children.append(nid)
    return corpus


def _nodes(corpus):
    """The root, a leaf, a middle node and the node with no matches."""
    leaf = next(n for n, c in corpus.concepts.items() if not c.children
                and len(c.leaf_image_ids))
    mid = next(n for n, c in corpus.concepts.items() if c.depth == 2)
    empty = next(n for n, c in corpus.concepts.items()
                 if not len(c.leaf_image_ids))
    return {"root": 0, "leaf": leaf, "middle": mid, "empty": empty}


def _ids(n):
    rng = np.random.default_rng(11)
    sorted32 = np.sort(rng.choice(n, 32, replace=False))
    return {"empty": np.array([], np.int64),
            "sorted32": sorted32,
            "unsorted32": rng.permutation(sorted32),
            "duplicates": np.concatenate([sorted32[:10], sorted32[:10],
                                          sorted32[5:7]]),
            "all": np.arange(n)}


CORPORA = {"make_corpus": lambda: _with_empty(_made()),
           "contiguous": lambda: _with_empty(_contiguous())}


@pytest.mark.parametrize("path", ["lookup", "dense", "chosen"])
@pytest.mark.parametrize("kind", sorted(CORPORA))
def test_both_paths_match_the_dense_oracle(kind, path, monkeypatch):
    corpus = CORPORA[kind]()
    if path != "chosen":
        monkeypatch.setattr(syn, "_lookup_wins",
                            lambda k, m, n: path == "lookup")
    for node_name, nid in _nodes(corpus).items():
        for ids_name, ids in _ids(len(corpus.images)).items():
            got = corpus.vlm_answer(nid, ids, seed=4)
            want = oracle(corpus, nid, ids, seed=4)
            assert got.dtype == want.dtype == np.bool_, (node_name, ids_name)
            assert got.shape == want.shape, (node_name, ids_name)
            assert np.array_equal(got, want), (node_name, ids_name)


@pytest.mark.parametrize("path", ["lookup", "dense"])
def test_a_list_out_of_order_still_answers_right(path, monkeypatch):
    corpus = _made()
    rng = np.random.default_rng(5)
    for c in corpus.concepts.values():
        ids = c.leaf_image_ids
        if len(ids):      # shuffled, and one match listed twice
            c.leaf_image_ids = rng.permutation(np.append(ids, ids[0]))
    monkeypatch.setattr(syn, "_lookup_wins", lambda k, m, n: path == "lookup")
    for nid in _nodes(_with_empty(corpus)).values():
        for ids in _ids(len(corpus.images)).values():
            assert np.array_equal(corpus.vlm_answer(nid, ids, seed=2),
                                  oracle(corpus, nid, ids, seed=2))


def test_the_order_check_is_made_once_a_node_and_follows_a_new_list(
        monkeypatch):
    corpus = _made()
    monkeypatch.setattr(syn, "_lookup_wins", lambda k, m, n: True)
    ids = _ids(len(corpus.images))["sorted32"]
    corpus.vlm_answer(0, ids)
    checked = corpus._sorted_matches[0]
    assert checked[1] is corpus.concepts[0].leaf_image_ids   # no copy
    for _ in range(3):
        corpus.vlm_answer(0, ids)
    assert corpus._sorted_matches[0] is checked               # no recheck
    rng = np.random.default_rng(1)
    corpus.concepts[0].leaf_image_ids = rng.permutation(
        corpus.concepts[0].leaf_image_ids)
    assert np.array_equal(corpus.vlm_answer(0, ids),
                          oracle(corpus, 0, ids, seed=0))
    again = corpus._sorted_matches[0]
    assert again[0] is corpus.concepts[0].leaf_image_ids
    assert np.array_equal(again[1], checked[1])


def _big():
    """2^20 rows of zero width: a root, a half, a leaf, an empty node."""
    d = np.zeros(1)
    lists = [np.arange(N_BIG), np.arange(N_BIG // 2, N_BIG),
             np.arange(1000, 1040), np.array([], np.int64)]
    concepts = {i: syn.Concept(i, min(i, 1), None if i == 0 else 0, [], d,
                               f"n{i}", ids.astype(np.int64))
                for i, ids in enumerate(lists)}
    concepts[0].children = [1, 2, 3]
    return syn.Corpus("big", 0, np.empty((N_BIG, 0), np.float32),
                      np.zeros(N_BIG, np.int64), concepts, 0.0, 0.08,
                      np.random.default_rng(0))


def test_a_sample_takes_the_lookup_and_every_row_the_dense_mask():
    corpus = _big()
    ids = _ids(N_BIG)
    clock = phases.PhaseClock()
    phases.bind(clock)
    try:
        for nid in corpus.concepts:
            corpus.vlm_answer(nid, ids["sorted32"])
        assert (clock.vlm_answer_calls, clock.vlm_answer_dense) == (4, 0)
        for nid in (0, 1, 2):
            got = corpus.vlm_answer(nid, ids["all"], seed=1)
            assert np.array_equal(got, oracle(corpus, nid, ids["all"], 1))
        assert (clock.vlm_answer_calls, clock.vlm_answer_dense) == (7, 3)
    finally:
        phases.bind(None)
    assert np.array_equal(corpus.vlm_answer(3, ids["all"]),    # unbound
                          oracle(corpus, 3, ids["all"], 0))
    assert (clock.vlm_answer_calls, clock.vlm_answer_dense) == (7, 3)


@pytest.mark.parametrize("m", [0, 1, 45, 1 << 10, 1 << 16, 1 << 20,
                               (1 << 23) // 3, 1 << 23])
def test_the_size_rule_at_the_benchmark_store(m):
    """At 2^23 rows the KV-batch sample's 32 ids always take the lookup;
    all the rows take the dense mask wherever the node matches anything."""
    n = 1 << 23
    assert syn._lookup_wins(32, m, n)
    assert syn._lookup_wins(n, m, n) == (m == 0)

"""The generator: the same seed gives the same corpus and traffic, another
seed other ones; open-loop schedules offer a fixed amount of work."""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from semhist_bench import corpus, traffic  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
SEED = 3_000_000_019          # past 31 bits, as the driver's seeds are


def _tree(seed, preset="wildlife", n=2048, shape_seed=0):
    return corpus.build_tree(preset, n, 64, seed, shape_seed)


def test_corpus_repeats_for_a_seed_and_changes_with_it():
    a, b, c = _tree(SEED), _tree(SEED), _tree(SEED + 1)
    assert np.array_equal(a.directions, b.directions)
    ia, ib = (corpus.make_images(t, SEED, "cpu") for t in (a, b))
    assert torch.equal(ia, ib)
    assert not np.array_equal(a.directions, c.directions)
    ic = corpus.make_images(c, SEED + 1, "cpu")
    assert not torch.equal(ia, ic)
    assert torch.allclose(ia.norm(dim=1), torch.ones(len(ia)), atol=1e-5)
    # every run seed has the configuration's shape: the same work
    assert np.array_equal(a.leaf_counts, c.leaf_counts)
    assert np.array_equal(a.lo, c.lo) and np.array_equal(a.hi, c.hi)
    d = _tree(SEED, shape_seed=1)
    assert not np.array_equal(a.leaf_counts, d.leaf_counts)


def test_every_node_matches_one_contiguous_row_range():
    t = _tree(SEED, "ecommerce", 4096)
    assert t.lo[0] == 0 and t.hi[0] == t.n
    for nid in range(t.nodes):
        ch = t.children[nid]
        if ch:
            assert t.lo[nid] == t.lo[ch[0]] and t.hi[nid] == t.hi[ch[-1]]
            assert sum(t.matches(c) for c in ch) == t.matches(nid)


# the committed mix, and leaf filters under 1% selectivity as a later
# closed-loop cell would draw them
LEAF_MIX = {"loop": "closed", "sessions": 64, "filters": [2, 3, 4],
            "pool": "leaves", "max_selectivity": 0.01}


@pytest.mark.parametrize("mix", ["open-mixed", "leaves"])
def test_queries_repeat_for_a_seed_and_change_with_it(mix, tmp_path):
    if mix == "leaves":
        path = tmp_path / "leaves.json"
        path.write_text(json.dumps(LEAF_MIX))
    else:
        path = BENCH / "traffic" / f"{mix}.json"
    m = traffic.load_mix(path)
    t = _tree(SEED, "ecommerce" if mix == "leaves" else "wildlife", 1 << 16)
    a = traffic.QueryStream(t, m, SEED).take(60)
    assert a == traffic.QueryStream(t, m, SEED).take(60)
    assert a != traffic.QueryStream(t, m, SEED + 1).take(60)
    sizes = [len(q) for q, _ in a]
    assert sorted(set(sizes)) == sorted(m["filters"])
    assert all(sizes.count(s) == 20 for s in m["filters"])
    assert all(len(set(q)) == len(q) for q, _ in a)
    # dealt like cards: no pool predicate twice before every one once
    pool = traffic.predicate_pool(t, m)
    seen = np.bincount([n for q, _ in a for n in q], minlength=t.nodes)
    assert seen[pool].max() - seen[pool].min() <= 2
    assert len({s for _, s in a}) == len(a)        # a text seed a query
    if m["pool"] == "leaves":
        leaves = set(t.leaves.tolist())
        for q, _ in a:
            for n in q:
                assert n in leaves
                assert 0 < t.matches(n) < m["max_selectivity"] * t.n


def test_open_schedule_offers_rate_times_window():
    mix = {"loop": "open", "rate_per_s": 37.0, "filters": [2]}
    a = traffic.open_schedule(mix, 20.0, SEED)
    assert len(a) == round(37.0 * 20.0)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 20.0
    assert np.array_equal(a, traffic.open_schedule(mix, 20.0, SEED))
    b = traffic.open_schedule(mix, 20.0, SEED + 1)
    assert not np.array_equal(a, b)
    # the same gaps in another order
    assert np.allclose(np.sort(np.diff(a, append=20.0)),
                       np.sort(np.diff(b, append=20.0)))

"""Synthetic hierarchical concept corpus with exact ground truth.

Mirrors the paper's evaluation setup (ImageNet/WordNet hierarchy, §3.1 and §4)
without external data: a random concept tree whose nodes carry direction
vectors in the embedding space; leaves emit images as von-Mises-Fisher-ish
clusters around the leaf direction. A *predicate* is any tree node: its text
embedding is the node direction plus a modality-gap offset and noise; its true
match set is every image in the node's subtree (plus optional label noise).

This yields, by construction:
  * exact selectivity at every hierarchy level (broad root -> specific leaf),
  * an oracle "VLM" with a configurable error rate (the sampling baseline and
    the KV-batch estimator see realistic noisy answers),
  * specificity-model training data exactly as the paper builds it
    (concept -> threshold such that the match count equals the label count).

Three dataset presets stand in for the paper's Artwork / Wildlife / E-commerce
(different tree shapes, cluster tightness, and modality gap — chosen so the
three estimators trade places across presets the way they do in the paper).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.configs.paper_stack import EMBED_DIM
from repro_torch.core import phases


@dataclasses.dataclass
class Concept:
    """A concept node. ``leaf_image_ids`` is built sorted ascending and
    without duplicates (``make_corpus`` sorts it; a contiguous store's
    ``np.arange`` is so by construction), which ``Corpus.vlm_answer``'s
    lookup relies on; it checks that once a node and answers any other
    list from a sorted unique copy."""

    node_id: int
    depth: int
    parent: int | None
    children: list[int]
    direction: np.ndarray          # unit vector
    name: str
    leaf_image_ids: np.ndarray     # all images in subtree (filled post-build)


@dataclasses.dataclass
class Corpus:
    name: str
    dim: int
    images: np.ndarray             # (N, d) unit vectors
    image_leaf: np.ndarray         # (N,) leaf node id per image
    concepts: dict[int, Concept]
    text_noise: float
    vlm_error: float
    rng: np.random.Generator
    # node id -> (its leaf_image_ids, that list sorted without duplicates):
    # the lookup's once-a-node check, made at the node's first lookup
    # (planners racing on it store equal entries)
    _sorted_matches: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    # ---------------- predicates ----------------

    def predicate_nodes(self, max_per_depth: int = 8) -> list[int]:
        """A spread of predicates across specificities (depths)."""
        by_depth: dict[int, list[int]] = {}
        for nid, c in self.concepts.items():
            by_depth.setdefault(c.depth, []).append(nid)
        out = []
        for depth in sorted(by_depth):
            nodes = sorted(by_depth[depth])
            self.rng.shuffle(nodes)
            out.extend(nodes[:max_per_depth])
        return out

    def text_embedding(self, node_id: int, seed: int = 0) -> np.ndarray:
        """Predicate text embedding: node direction + modality gap + noise."""
        c = self.concepts[node_id]
        g = np.random.default_rng((node_id + 1) * 7919 + seed)
        # noise scaled by 1/sqrt(d): ||noise|| ~= text_noise relative to the
        # unit signal direction (otherwise embeddings are pure noise at d=1152)
        v = c.direction + self.text_noise * g.standard_normal(self.dim) / np.sqrt(self.dim)
        return (v / np.linalg.norm(v)).astype(np.float32)

    def true_matches(self, node_id: int) -> np.ndarray:
        return self.concepts[node_id].leaf_image_ids

    def true_selectivity(self, node_id: int) -> float:
        return len(self.true_matches(node_id)) / len(self.images)

    # ---------------- oracle VLM ----------------

    def vlm_answer(self, node_id: int, image_ids: np.ndarray,
                   seed: int = 0) -> np.ndarray:
        """Noisy yes/no per image — the stand-in for Qwen2.5-VL answers.

        Asymmetric error profile: misses (yes->no) at ``vlm_error``, false
        positives at ``vlm_error/8`` — VLM precision on specific "Is X
        depicted?" prompts is much higher than recall (the paper observes
        exactly this miss-dominated behaviour on wildlife, §4.2).

        The truth of each requested id (in ``[0, N)``, in any order,
        repeats answered each time) comes from one of two paths that give
        the same array: a binary search of each id in the node's match list,
        O(k log M) for k ids and M matches, or a dense mask of all N rows,
        O(N + M). The sizes pick the cheaper (``_lookup_wins``). A bound
        ``phases.PhaseClock`` counts the calls and the dense ones."""
        matches = self.true_matches(node_id)
        dense = not _lookup_wins(len(image_ids), len(matches),
                                 len(self.images))
        clock = phases.current()
        if clock is not None:
            clock.vlm_answer_calls += 1
            clock.vlm_answer_dense += dense
        if dense:
            ans = dense_truth(matches, image_ids, len(self.images))
        else:
            ans = lookup_truth(self._sorted(node_id, matches), image_ids)
        g = np.random.default_rng(node_id * 104729 + seed)
        u = g.random(len(image_ids))
        fn = ans & (u < self.vlm_error)
        fp = (~ans) & (u < self.vlm_error / 8.0)
        return np.where(fn, False, np.where(fp, True, ans))

    def _sorted(self, node_id: int, matches: np.ndarray) -> np.ndarray:
        """``matches`` if it is sorted ascending without duplicates, else a
        sorted unique copy; checked once a node (O(M)) and kept while the
        node holds the same list object."""
        hit = self._sorted_matches.get(node_id)
        if hit is not None and hit[0] is matches:
            return hit[1]
        ok = bool(np.all(matches[1:] > matches[:-1]))
        out = matches if ok else np.unique(matches)
        self._sorted_matches[node_id] = (matches, out)
        return out


def _lookup_wins(k: int, m: int, n: int) -> bool:
    """Whether k binary searches in a list of m matches cost less than a
    dense mask over n rows. Timed on the host of an H100 machine at
    n = 2^23 (``python3 scripts/torch_planner_spans.py --vlm 1``): the mask
    costs about 0.06 ns a row (the zeroed allocation) and 2.3 ns a match
    (the scatter), a search 4–14 ns a level an id. The rule
    k·log2(m + 1) < n/64 + m picked the faster path at all 30 sizes timed:
    a 32-row sample always takes the lookup at n = 2^23, an empty list
    always does, and all n rows never do for a node with a match."""
    return k * math.log2(m + 1) < n / 64 + m


def dense_truth(matches: np.ndarray, image_ids, n: int) -> np.ndarray:
    """Membership of ``image_ids`` in ``matches`` through an n-row mask."""
    truth = np.zeros(n, bool)
    truth[matches] = True
    return truth[image_ids]


def lookup_truth(sorted_matches: np.ndarray, image_ids) -> np.ndarray:
    """Membership of ``image_ids`` in ``sorted_matches`` (ascending, no
    duplicates) by binary search: nothing of size n is allocated."""
    ids = np.asarray(image_ids)
    if not len(sorted_matches):
        return np.zeros(len(ids), bool)
    pos = np.searchsorted(sorted_matches, ids)
    np.minimum(pos, len(sorted_matches) - 1, out=pos)
    return sorted_matches[pos] == ids


def _build_tree(rng, dim, depth, branching, jitter):
    scale = 1.0 / np.sqrt(dim)  # per-dim -> unit-norm noise scaling
    concepts: dict[int, Concept] = {}
    root_dir = rng.standard_normal(dim)
    root_dir /= np.linalg.norm(root_dir)
    concepts[0] = Concept(0, 0, None, [], root_dir, "root", np.array([], np.int64))
    frontier = [0]
    next_id = 1
    for d in range(1, depth + 1):
        new_frontier = []
        for pid in frontier:
            nb = rng.integers(branching[0], branching[1] + 1)
            for _ in range(nb):
                v = concepts[pid].direction + jitter[d - 1] * scale * rng.standard_normal(dim)
                v /= np.linalg.norm(v)
                concepts[next_id] = Concept(next_id, d, pid, [], v,
                                            f"n{next_id}", np.array([], np.int64))
                concepts[pid].children.append(next_id)
                new_frontier.append(next_id)
                next_id += 1
        frontier = new_frontier
    return concepts, frontier


def make_corpus(
    name: str = "wildlife",
    *,
    n_images: int = 1000,
    dim: int = EMBED_DIM,
    seed: int = 0,
) -> Corpus:
    """Presets loosely shaped after the paper's three datasets."""
    presets = {
        # tight clusters, moderate tree, small modality gap (animals):
        "wildlife": dict(depth=4, branching=(2, 3), jitter=[0.6, 0.45, 0.35, 0.3],
                         img_noise=0.25, text_noise=0.18, vlm_error=0.08,
                         skew=1.6),
        # diffuse clusters, deep tree (artworks are visually heterogeneous):
        "artwork": dict(depth=5, branching=(2, 3), jitter=[0.7, 0.5, 0.45, 0.4, 0.35],
                        img_noise=0.45, text_noise=0.3, vlm_error=0.05,
                        skew=1.2),
        # very tight clusters, flat tree, well-aligned text (single-product
        # shots): the paper's kvbatch-friendly dataset (§4.2)
        "ecommerce": dict(depth=3, branching=(3, 5), jitter=[0.8, 0.5, 0.35],
                          img_noise=0.15, text_noise=0.12, vlm_error=0.03,
                          skew=2.2),
    }
    p = presets[name]
    rng = np.random.default_rng(seed)
    concepts, leaves = _build_tree(rng, dim, p["depth"], p["branching"], p["jitter"])

    # zipf-ish image counts per leaf
    w = (1.0 / np.arange(1, len(leaves) + 1) ** p["skew"])
    rng.shuffle(w)
    w /= w.sum()
    counts = rng.multinomial(n_images, w)
    images, image_leaf = [], []
    for leaf, cnt in zip(leaves, counts):
        base = concepts[leaf].direction
        noise_scale = p["img_noise"] / np.sqrt(dim)
        for _ in range(cnt):
            v = base + noise_scale * rng.standard_normal(dim)
            images.append(v / np.linalg.norm(v))
            image_leaf.append(leaf)
    images = np.asarray(images, np.float32)
    image_leaf = np.asarray(image_leaf, np.int64)

    # fill subtree image id lists bottom-up
    ids_by_leaf: dict[int, list[int]] = {}
    for i, leaf in enumerate(image_leaf):
        ids_by_leaf.setdefault(int(leaf), []).append(i)

    def collect(nid) -> list[int]:
        c = concepts[nid]
        out = list(ids_by_leaf.get(nid, []))
        for ch in c.children:
            out.extend(collect(ch))
        c.leaf_image_ids = np.asarray(sorted(out), np.int64)
        return out

    collect(0)
    return Corpus(name=name, dim=dim, images=images, image_leaf=image_leaf,
                  concepts=concepts, text_noise=p["text_noise"],
                  vlm_error=p["vlm_error"], rng=rng)


# ---------------- clustered stores (index benchmarks / tests) ----------------


def clustered_unit_vectors(
    n: int, dim: int, *, n_centers: int = 16, spread: float = 0.25,
    seed: int = 0, skew: float = 0.0, grouped: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(n, dim) unit vectors in tight vMF-ish clumps + (n,) center labels.

    The workload the cluster-pruned index (`repro.index`) is built for:
    real image-embedding stores are strongly clustered (images of the same
    concept land together), unlike isotropic Gaussians whose k-means radii
    approach the sphere diameter and defeat any bound-based pruning.
    ``spread`` is the per-dimension noise scale relative to unit signal
    (same convention as ``make_corpus``'s ``img_noise``).

    ``skew > 0`` draws cluster sizes Zipf (weight ``1/rank^skew``; label 0
    is the biggest clump — SemCEB/SemBench-style head-heavy concept
    distributions). ``grouped=True`` emits rows grouped by label (the
    ingest order real stores have: images arrive batched by source or
    concept), which is the order that concentrates one concept's boundary
    mass onto whichever contiguous shard blocks hold it — the pathology
    the boundary-balanced sharded build exists to fix.
    """
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    if skew > 0:
        w = 1.0 / np.arange(1, n_centers + 1, dtype=np.float64) ** skew
        labels = rng.choice(n_centers, size=n, p=w / w.sum())
    else:
        labels = rng.integers(n_centers, size=n)
    if grouped:
        labels = np.sort(labels, kind="stable")
    x = centers[labels] + (spread / np.sqrt(dim)) * rng.standard_normal(
        (n, dim))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), labels


# ---------------- specificity-model training data (paper §3.1) ----------------


def specificity_dataset(
    corpus: Corpus, *, n_samples: int = 5000, subset: int = 512, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(text embeddings (n, d), threshold labels (n,)).

    Exactly the paper's construction: sample a data subset and a concept; the
    label is the cosine-distance threshold under which exactly
    |subset ∩ matches(concept)| images of the subset fall.
    """
    rng = np.random.default_rng(seed)
    node_ids = list(corpus.concepts.keys())
    X, y = [], []
    n_img = len(corpus.images)
    while len(X) < n_samples:
        nid = node_ids[rng.integers(len(node_ids))]
        sub = rng.choice(n_img, size=min(subset, n_img), replace=False)
        t = corpus.text_embedding(nid, seed=int(rng.integers(1 << 30)))
        truth = np.zeros(n_img, bool)
        truth[corpus.true_matches(nid)] = True
        m = int(truth[sub].sum())
        dist = 1.0 - corpus.images[sub] @ t
        order = np.sort(dist)
        if m == 0:
            thr = max(order[0] - 1e-3, 0.0)
        elif m >= len(sub):
            thr = order[-1] + 1e-3
        else:
            thr = 0.5 * (order[m - 1] + order[m])
        X.append(t)
        y.append(thr)
    return np.asarray(X, np.float32), np.asarray(y, np.float32)

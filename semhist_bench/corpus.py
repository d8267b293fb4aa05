"""The benchmark's corpus: the preset recipe of the paper's synthetic
hierarchy (an ImageNet/WordNet-like concept tree whose leaves emit images
around their directions), with the images drawn on the device in a few
large calls.

The presets and the recipe follow ``core/synthetic.py``'s
``make_corpus``, with two departures. The tree's shape (each node's
branching, the leaves' Zipf weights and image counts) comes from the
configuration's fixed ``shape_seed`` and only the directions from the
run's seed, so every seed does the same amount of work on other data; and
the images' noise comes from a ``torch.Generator`` instead of a per-row
numpy loop, so a corpus of 2^23 x 1152 rows takes about a second on the
card. Images are emitted leaf after leaf in the tree's last frontier
order, so every node's match set is one contiguous row range
``[lo[node], hi[node])``.

This module imports nothing of the program: the reference regenerates the
images from the same seed with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The three dataset presets of the paper's evaluation (core/synthetic.py).
PRESETS = {
    "wildlife": dict(depth=4, branching=(2, 3), jitter=[0.6, 0.45, 0.35, 0.3],
                     img_noise=0.25, text_noise=0.18, vlm_error=0.08,
                     skew=1.6),
    "artwork": dict(depth=5, branching=(2, 3),
                    jitter=[0.7, 0.5, 0.45, 0.4, 0.35],
                    img_noise=0.45, text_noise=0.3, vlm_error=0.05, skew=1.2),
    "ecommerce": dict(depth=3, branching=(3, 5), jitter=[0.8, 0.5, 0.35],
                      img_noise=0.15, text_noise=0.12, vlm_error=0.03,
                      skew=2.2),
}

GEN_ROWS = 1 << 20          # rows drawn per generator call


def seed_words(seed: int, purpose: int) -> list[int]:
    """Entropy for one purpose's stream: any whole seed, negative too."""
    return [int(seed) % (1 << 64), int(purpose)]


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed, purpose))


def torch_seed(seed: int, purpose: int) -> int:
    ss = np.random.SeedSequence(seed_words(seed, purpose))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Tree:
    """The concept tree and where each node's images lie."""

    preset: str
    shape_seed: int
    dim: int
    n: int
    directions: np.ndarray      # (nodes, d) float64 unit vectors
    depth: np.ndarray           # (nodes,) int
    parent: np.ndarray          # (nodes,) int, -1 at the root
    children: list              # per node, child ids
    leaves: np.ndarray          # leaf ids in emission order
    leaf_counts: np.ndarray     # images per leaf, in emission order
    lo: np.ndarray              # (nodes,) first row of the node's matches
    hi: np.ndarray              # (nodes,) one past its last row
    text_noise: float
    vlm_error: float
    img_noise: float

    @property
    def nodes(self) -> int:
        return len(self.depth)

    def matches(self, node: int) -> int:
        return int(self.hi[node] - self.lo[node])


def build_tree(preset: str, n: int, dim: int, seed: int,
               shape_seed: int) -> Tree:
    """The tree and per-leaf counts: the shape from ``shape_seed``, the
    directions from ``seed``."""
    p = PRESETS[preset]
    shape = rng_for(shape_seed, 0)
    rng = rng_for(seed, 1)
    scale = 1.0 / np.sqrt(dim)
    root = rng.standard_normal(dim)
    dirs = [root / np.linalg.norm(root)]
    depth, parent, children = [0], [-1], [[]]
    frontier = [0]
    for d in range(1, p["depth"] + 1):
        new = []
        for pid in frontier:
            nb = shape.integers(p["branching"][0], p["branching"][1] + 1)
            for _ in range(nb):
                v = dirs[pid] + p["jitter"][d - 1] * scale \
                    * rng.standard_normal(dim)
                dirs.append(v / np.linalg.norm(v))
                nid = len(depth)
                depth.append(d)
                parent.append(pid)
                children.append([])
                children[pid].append(nid)
                new.append(nid)
        frontier = new
    leaves = np.asarray(frontier, np.int64)
    w = 1.0 / np.arange(1, len(leaves) + 1) ** p["skew"]
    shape.shuffle(w)
    w /= w.sum()
    counts = shape.multinomial(n, w).astype(np.int64)

    nodes = len(depth)
    lo = np.zeros(nodes, np.int64)
    hi = np.zeros(nodes, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for leaf, s, c in zip(leaves, starts, counts):
        lo[leaf], hi[leaf] = s, s + c
    for d in range(p["depth"] - 1, -1, -1):
        for nid in range(nodes):
            if depth[nid] == d:
                ch = children[nid]
                lo[nid], hi[nid] = lo[ch[0]], hi[ch[-1]]
    return Tree(preset=preset, shape_seed=shape_seed, dim=dim, n=n,
                directions=np.asarray(dirs, np.float64),
                depth=np.asarray(depth), parent=np.asarray(parent),
                children=children, leaves=leaves, leaf_counts=counts,
                lo=lo, hi=hi, text_noise=p["text_noise"],
                vlm_error=p["vlm_error"], img_noise=p["img_noise"])


def make_images(tree: Tree, seed: int, device) -> torch.Tensor:
    """(N, d) float32 unit rows on ``device``: leaf direction plus
    ``img_noise / sqrt(d)`` Gaussian noise, normalised. The same seed and
    device give bitwise the same rows."""
    dev = torch.device(device)
    n, d = tree.n, tree.dim
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(torch_seed(seed, 2))
    out.normal_(0.0, tree.img_noise / np.sqrt(d), generator=gen)
    dirs = torch.as_tensor(tree.directions, dtype=torch.float32, device=dev)
    for leaf, lo, hi in zip(tree.leaves, tree.lo[tree.leaves],
                            tree.hi[tree.leaves]):
        if hi > lo:
            out[lo:hi].add_(dirs[int(leaf)])
    for i in range(0, n, GEN_ROWS):
        blk = out[i:i + GEN_ROWS]
        blk.div_(torch.linalg.vector_norm(blk, dim=1, keepdim=True))
    return out


def text_embedding(tree: Tree, node: int, seed: int) -> np.ndarray:
    """A predicate's text embedding: node direction plus modality-gap noise
    (the recipe's ``Corpus.text_embedding``), float32."""
    g = np.random.default_rng((node + 1) * 7919 + seed)
    v = tree.directions[node] + tree.text_noise \
        * g.standard_normal(tree.dim) / np.sqrt(tree.dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def oracle_answers(tree: Tree, node: int, ids: np.ndarray,
                   seed: int) -> np.ndarray:
    """The noisy yes/no oracle standing in for VLM answers (the recipe's
    ``Corpus.vlm_answer``): misses at ``vlm_error``, false positives at an
    eighth of it."""
    ids = np.asarray(ids)
    ans = (ids >= tree.lo[node]) & (ids < tree.hi[node])
    u = np.random.default_rng(node * 104729 + seed).random(len(ids))
    fn = ans & (u < tree.vlm_error)
    fp = (~ans) & (u < tree.vlm_error / 8.0)
    return np.where(fn, False, np.where(fp, True, ans))


def specificity_labels(tree: Tree, images: torch.Tensor, *, samples: int,
                       subset: int, seed: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(text embeddings (S, d) float32, thresholds (S,) float32): the
    paper's §3.1 training set, built as the recipe's
    ``specificity_dataset``: a random node and data subset per sample, the
    label the distance under which as many subset rows fall as the subset
    holds matches. The subsets' distances are taken on the device in
    batches."""
    rng = rng_for(seed, 3)
    n = tree.n
    nodes, subs, texts = [], [], []
    for _ in range(samples):
        nid = int(rng.integers(tree.nodes))
        sub = rng.choice(n, size=min(subset, n), replace=False)
        t = text_embedding(tree, nid, int(rng.integers(1 << 30)))
        nodes.append(nid)
        subs.append(sub)
        texts.append(t)
    X = np.stack(texts)
    subs = np.stack(subs)
    nodes = np.asarray(nodes)
    m = ((subs >= tree.lo[nodes, None])
         & (subs < tree.hi[nodes, None])).sum(axis=1)
    y = np.empty(samples, np.float32)
    dev = images.device
    step = 256
    for i in range(0, samples, step):
        idx = torch.as_tensor(subs[i:i + step], device=dev)
        rows = images[idx.reshape(-1)].reshape(idx.shape[0], idx.shape[1], -1)
        t = torch.as_tensor(X[i:i + step], device=dev)
        dist = 1.0 - torch.einsum("bsd,bd->bs", rows, t)
        srt = torch.sort(dist, dim=1).values.cpu().numpy()
        for j in range(srt.shape[0]):
            mj, order = int(m[i + j]), srt[j]
            if mj == 0:
                y[i + j] = max(order[0] - 1e-3, 0.0)
            elif mj >= len(order):
                y[i + j] = order[-1] + 1e-3
            else:
                y[i + j] = 0.5 * (order[mj - 1] + order[mj])
    return X, y


def medoid_sample(images: torch.Tensor, k: int, *, iters: int,
                  seed: int) -> np.ndarray:
    """Ids of the rows nearest the centroids of a plain Lloyd's k-means
    (the paper's diverse KV-batch sample, §3.2), in float32 matrix
    products on the images' device."""
    rng = rng_for(seed, 4)
    n = images.shape[0]
    cent = images[torch.as_tensor(rng.choice(n, size=k, replace=False),
                                  device=images.device)].clone()
    ks = torch.arange(k, device=images.device)
    for _ in range(iters):
        # sums by one-hot products, not atomics: the same seed gives the
        # same sample
        sums = torch.zeros_like(cent)
        cnt = torch.zeros((k,), dtype=cent.dtype, device=images.device)
        c2 = (cent * cent).sum(dim=1)
        for i in range(0, n, GEN_ROWS):
            x = images[i:i + GEN_ROWS]
            a = (c2[None, :] - 2.0 * (x @ cent.T)).argmin(dim=1)
            onehot = (a[None, :] == ks[:, None]).to(cent.dtype)
            sums += onehot @ x
            cnt += onehot.sum(dim=1)
        new = sums / cnt.clamp(min=1.0)[:, None]
        cent = torch.where((cnt > 0)[:, None], new, cent)
    # the row nearest each centroid
    near = torch.full((k,), torch.inf, device=images.device)
    near_i = torch.zeros((k,), dtype=torch.long, device=images.device)
    c2 = (cent * cent).sum(dim=1)
    for i in range(0, n, GEN_ROWS):
        x = images[i:i + GEN_ROWS]
        d2 = (x * x).sum(dim=1)[:, None] - 2.0 * (x @ cent.T) + c2[None, :]
        v, a = d2.min(dim=0)
        take = v < near
        near = torch.where(take, v, near)
        near_i = torch.where(take, a + i, near_i)
    return np.unique(near_i.cpu().numpy())

"""Lloyd's k-means built on the assignment kernel; returns medoid sample ids.

The paper selects its KV-batch sample by clustering image embeddings with
K = sample_size and picking the image nearest each centroid (§3.2).

The seeded draws (initial centroids, re-seeds of empty clusters) are the
reference's own numpy draws, in the same order, so the port starts from the
same centroids as ``repro.kernels.kmeans.ops.kmeans``. The assignment step
runs the CUDA kernel for a CUDA tensor and its plain version for a CPU one;
the centroid update is two ``index_add_`` segment sums.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.kmeans import kernel
from repro_torch.kernels.kmeans.ref import assign_ref

f32 = torch.float32


SCORE_ROWS = 65536     # rows a chunk of the slice winners' scores


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N,) int32 nearest-centroid ids: the kernel on CUDA, plain on CPU.

    The kernel holds at most ``kernel.MAX_CENTROIDS`` centroids (the
    reference kernel's limit). Past that — the boundary-balanced sharded
    build clusters the whole store at K x shards — each slice of at most
    that many centroids is one launch, and each row keeps the slice winner
    whose float32 score ``||c||^2 - 2 x.c`` is lowest, the earlier slice on
    a tie; the slices' winners can then differ from one pass over every
    centroid only on near-ties, as the kernel's own bf16x2 products do."""
    if x.device.type == "cpu":
        return assign_ref(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"no assignment kernel for {x.device}")
    x, centroids = x.contiguous(), centroids.contiguous()
    step = kernel.MAX_CENTROIDS
    if centroids.shape[0] <= step:
        return kernel.assign_blocks(x, centroids)
    c2 = torch.sum(centroids * centroids, dim=1)
    best = best_s = None
    for lo in range(0, centroids.shape[0], step):
        ids = kernel.assign_blocks(x, centroids[lo:lo + step].contiguous())
        ids = ids.long() + lo
        score = torch.empty(x.shape[0], dtype=f32, device=x.device)
        for i in range(0, x.shape[0], SCORE_ROWS):
            sl = ids[i:i + SCORE_ROWS]
            score[i:i + SCORE_ROWS] = c2[sl] - 2.0 * torch.sum(
                x[i:i + SCORE_ROWS] * centroids[sl], dim=1)
        if best is None:
            best, best_s = ids, score
        else:
            take = score < best_s
            best = torch.where(take, ids, best)
            best_s = torch.where(take, score, best_s)
    return best.to(torch.int32)


def kmeans(
    x: torch.Tensor, k: int, *, iters: int = 10, seed: int = 0,
    init_centroids: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (centroids (k, d), assignments (N,) int32) on ``x``'s device.

    ``init_centroids`` warm-starts Lloyd's from a previous clustering
    instead of the seeded random draw. Must be (k', d) with k' <= N; k is
    then taken from it.
    """
    rng = np.random.default_rng(seed)
    x = x.to(f32)
    n, d = x.shape
    dev = x.device
    if init_centroids is not None:
        init = np.asarray(init_centroids, np.float32)
        if init.ndim != 2 or init.shape[1] != d:
            raise ValueError(f"init_centroids {init.shape} incompatible "
                             f"with store dim {d}")
        k = min(len(init), n)
        cent = torch.as_tensor(init[:k], device=dev)
    else:
        ids = rng.choice(n, size=k, replace=False)
        cent = x[torch.as_tensor(ids, device=dev)]
    ones = torch.ones((n,), dtype=f32, device=dev)

    for _ in range(iters):
        a = assign(x, cent).long()
        sums = torch.zeros((k, d), dtype=f32, device=dev).index_add_(0, a, x)
        cnts = torch.zeros((k,), dtype=f32, device=dev).index_add_(0, a, ones)
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        # re-seed empty clusters at random points (drawn every iteration,
        # as the reference does, so the rng streams stay in step)
        empty = cnts < 0.5
        reseed = x[torch.as_tensor(rng.choice(n, size=k), device=dev)]
        cent = torch.where(empty[:, None], reseed, new)
    return cent, assign(x, cent)


def medoid_sample(x: torch.Tensor, k: int, **kw) -> np.ndarray:
    """Indices of the k images nearest the k centroids (diverse sample)."""
    cent, _ = kmeans(x, k, **kw)
    x = x.to(f32)
    d2 = (torch.sum(x * x, dim=1)[:, None]
          - 2.0 * (x @ cent.T)
          + torch.sum(cent * cent, dim=1)[None, :])
    return np.unique(torch.argmin(d2, dim=0).cpu().numpy())

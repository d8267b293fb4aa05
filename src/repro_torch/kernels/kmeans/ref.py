"""Plain-torch version of the k-means assignment step: the CPU path of
``ops`` and the oracle the CUDA kernel is held to."""

from __future__ import annotations

import torch

f32 = torch.float32


def assign_ref(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x (N, d), centroids (C, d) -> (N,) int32 nearest-centroid ids.

    Scores as the kernel does, -2·x·c + ||c||^2 (||x||^2 is constant per row
    and left out); ``torch.argmin`` returns the first index on a tie."""
    c = centroids.to(f32)
    scores = torch.sum(c * c, dim=1)[None, :] - 2.0 * (x.to(f32) @ c.T)
    return torch.argmin(scores, dim=1).to(torch.int32)

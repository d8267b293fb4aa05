"""Compressed KV-cache batching (paper §3.2): the parts the estimate path uses.

The KV-batch estimator calibrates a threshold on a k-means medoid sample:
the m-th smallest predicate<->sample distance, where m is the number of
sample images the VLM answers "yes" for. With synthetic weights the answers
come from the corpus oracle (as in the reference), so the estimate needs
only the sample ids. The offline build (prefill + Expected-Attention
compression) and the online batched prompt decode — ``build_compressed_store``
and ``batched_prompt_decode`` — are the next slice of the port; until then
the store carries ``sample_ids`` and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class CompressedCacheStore:
    """Per-layer compressed (k, v) stacks for the whole sample batch.

    Only ``sample_ids`` is filled until the KV-batch machinery is ported."""

    sample_ids: np.ndarray    # image ids in the sample
    cfg: Any = None
    params: Any = None
    cache: Any = None         # per-layer caches, compressed lengths
    cache_len: int = 0        # compressed length actually valid
    cache_capacity: int = 0   # allocated length (compressed + prompt room)
    build_s: float = 0.0
    bytes_total: int = 0


def threshold_from_matches(sample_dists: np.ndarray, m: int) -> float:
    """Paper §3.2 calibration: m-th smallest distance; 0 matches -> min."""
    order = np.sort(np.asarray(sample_dists, np.float64))
    if m <= 0:
        return float(max(order[0] - 1e-6, 0.0))
    if m >= len(order):
        return float(order[-1] + 1e-6)
    return float(0.5 * (order[m - 1] + order[m]))

"""Evaluation metrics (paper §4.1)."""

from __future__ import annotations

import numpy as np


def q_error(pred: float, true: float, dataset_size: int) -> float:
    """Ratio of predicted to actual selectivity, symmetric (always >= 1).

    Zero predictions are floored to 1/dataset_size (paper §4.1); a zero truth
    is floored the same way so broad/empty predicates stay comparable.
    """
    floor = 1.0 / max(dataset_size, 1)
    p = max(float(pred), floor)
    t = max(float(true), floor)
    return max(p / t, t / p)


def summarize_q_errors(qs) -> dict:
    qs = np.asarray(list(qs), np.float64)
    return {
        "median": float(np.median(qs)),
        "p5": float(np.percentile(qs, 5)),
        "p95": float(np.percentile(qs, 95)),
        "mean": float(qs.mean()),
        "n": int(qs.size),
    }

"""The yardstick's arithmetic: the card's published peaks and the work a
probe needs, counted from shapes alone, whatever implements it.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def probe_bytes(n: int, d: int, b: int) -> int:
    """A full-scan probe of b predicates: the (n, d) float32 store read once,
    the predicates and thresholds read, one count and one top-1 distance
    written per predicate."""
    return 4 * n * d + 4 * b * d + 4 * b + 8 * b


def probe_flops(n: int, d: int, b: int) -> int:
    return 2 * n * d * b


def probe_least_s(n: int, d: int, b: int) -> float:
    """The least time the card could take for one probe launch."""
    return max(probe_bytes(n, d, b) / HBM_BYTES_PER_S,
               probe_flops(n, d, b) / FP32_FLOPS_PER_S)


"""Flash-attention entry point: a CPU or meta tensor takes the plain
version in ``ref`` (the meta device sizes a step without running it: the
dry-run), a CUDA tensor the kernel (or the call raises; no fallback); any
other device raises. The
kernel masks its own ragged tiles, so nothing is padded or moved here
(``repro/kernels/flash_attention/ops.py`` pads and moves axes for the TPU
tiles)."""

from __future__ import annotations

import math

import torch

from repro_torch.analysis import cost
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D). The queries
    start at position 0, as a prefill's do."""
    if q.device.type in ("cpu", "meta"):
        pairs = cost.visible_pairs(q.shape[1], k.shape[1], causal=causal,
                                   window=window)
        return cost.fused("flash_attention", flash_attention_ref, q, k, v,
                          flops=cost.attention_flops(q, v, pairs),
                          causal=causal, window=window, scale=scale)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return kernel.flash_fwd(q, k, v, causal=causal, window=window,
                            scale=scale)

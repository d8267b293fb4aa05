"""Plain version of the flash kernel: direct attention
(``repro_torch.models.layers.sdpa_reference``), the CPU path of ``ops`` and
the oracle the CUDA kernel is held to, with the rows' log-sum-exp the
kernel writes for the training forward."""

import math

import torch

from repro_torch.models.layers import _causal_mask_bias, sdpa_reference


def row_lse(q, k, *, causal=True, window=None, scale=None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores, float32
    (B, H, Sq): what the kernel writes beside its output."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    scale = scale or (1.0 / math.sqrt(D))
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.to(torch.float32)) * scale
    if causal:
        s = s + _causal_mask_bias(torch.arange(Sq, device=q.device),
                                  torch.arange(k.shape[1], device=q.device),
                                  window)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        return_lse=False):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D). With ``return_lse``, (out,
    lse (B, H, Sq))."""
    out = sdpa_reference(q, k, v, causal=causal, window=window, scale=scale)
    if not return_lse:
        return out
    return out, row_lse(q, k, causal=causal, window=window, scale=scale)

"""Flash-decode entry point: a CPU or meta tensor takes the plain version
in ``ref``, a CUDA tensor the kernel (or the call raises; no fallback);
any other device raises. The
kernel reads the cache where it lies: nothing is padded or moved
(``repro/kernels/decode_attention/ops.py`` pads and moves axes for the TPU
tiles)."""

from __future__ import annotations

import math

import torch

from repro_torch.analysis import cost
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_valid=None, scale: float | None = None,
                     ) -> torch.Tensor:
    """q (B, 1, H, D), k/v (B, L, Hkv, D); kv_valid None (all L), an int
    or (B,) valid lengths. Returns (B, 1, H, D).

    A sequence with no valid slot (``kv_valid`` 0) returns a zero row, on
    the CPU and on the card alike: the kernel's merge divides an empty
    state (l = 0, acc = 0) by max(l, 1e-30), and the plain version zeroes
    a softmax row whose every key is masked. The reference returns a
    padding artifact there that depends on its chunk size (its -1e30 mask
    over the padded cache), which the port does not reproduce."""
    if q.device.type in ("cpu", "meta"):
        # the kernel reads the valid slots only; a (B,) tensor of lengths
        # is data, so its pairs are counted as the whole cache
        pairs = (int(kv_valid) if isinstance(kv_valid, int)
                 else k.shape[1])
        return cost.fused("decode_attention", decode_attention_ref, q, k, v,
                          flops=cost.attention_flops(q, v, pairs),
                          kv_valid=kv_valid, scale=scale)
    if torch.is_tensor(kv_valid):
        valid = kv_valid.to(device=q.device, dtype=torch.int32).expand(
            q.shape[0]).contiguous()
    else:       # one length for every sequence: a kernel argument
        valid = k.shape[1] if kv_valid is None else int(kv_valid)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return kernel.decode_fwd(q, k, v, valid, scale=scale)

"""Plain version of the flash kernel: direct attention
(``repro_torch.models.layers.sdpa_reference``), the CPU path of ``ops`` and
the oracle the CUDA kernel is held to."""

from repro_torch.models.layers import sdpa_reference


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D)."""
    return sdpa_reference(q, k, v, causal=causal, window=window, scale=scale)

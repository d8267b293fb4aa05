"""Plain version of the decode kernel: single-token attention against a
(possibly low-precision) cache, the CPU path of ``ops`` and the oracle the
CUDA kernel is held to."""

from repro_torch.models.layers import sdpa_reference


def decode_attention_ref(q, k, v, *, kv_valid=None, scale=None):
    """q (B, 1, H, D); k/v (B, L, Hkv, D); kv_valid None, an int or (B,)."""
    return sdpa_reference(q, k, v, causal=False, kv_valid=kv_valid,
                          scale=scale)

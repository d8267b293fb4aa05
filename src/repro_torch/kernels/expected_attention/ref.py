"""Plain version of the Expected-Attention scores
(``repro_torch.serving.compress.expected_attention_scores``): the CPU path
of ``ops`` and the oracle the CUDA kernel is held to."""

from repro_torch.serving.compress import expected_attention_scores


def ea_scores_ref(k, v, q_mu, q_var):
    """k/v (B, S, Hkv, D); q_mu/q_var (Hkv, rep, D) -> (B, S, Hkv) f32."""
    return expected_attention_scores(k, v, q_mu, q_var)

"""seamless-m4t-large-v2 [audio]: enc-dec, 24L each, d=1024 16H (kv=16)
d_ff=8192 vocab=256206 [arXiv:2308.11596].

Backbone only: the speech frontend (w2v-BERT feature extractor) is a
STUB, the encoder takes precomputed frame embeddings (B, S_enc, d).
"""

from repro_torch.configs.base import AudioConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,          # decoder layers
        num_enc_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        encdec=True,
        audio=AudioConfig(),
        rope_theta=10000.0,
        microbatch_tokens=1 << 16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        num_layers=2,
        num_enc_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encdec=True,
        audio=AudioConfig(),
    )


register("seamless-m4t-large-v2", full, smoke)

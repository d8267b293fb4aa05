"""smollm-360m [dense]: 32L d=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-arch small model [hf:HuggingFaceTB/SmolLM]; its smoke reduction has
a head dim of 20 and one KV head (40-byte bf16 rows).
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        family="dense",
        num_layers=2,
        d_model=60,
        num_heads=3,
        num_kv_heads=1,
        head_dim=20,
        d_ff=96,
        vocab_size=256,
        rope_theta=10000.0,
        tie_embeddings=True,
    )


register("smollm-360m", full, smoke)

"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

Llama+Mistral mix with sliding-window attention [arXiv:2401.16818]: a ring
buffer of ``window`` slots is the layer's cache.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        attn_kind="swa",
        window=4096,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="swa",
        window=16,
        rope_theta=10000.0,
    )


register("h2o-danube-1.8b", full, smoke)

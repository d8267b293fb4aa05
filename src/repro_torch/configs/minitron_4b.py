"""minitron-4b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron [arXiv:2407.14679]. Notable for the 256k vocab.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        rope_theta=10000.0,
        microbatch_tokens=1 << 17,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        rope_theta=10000.0,
    )


register("minitron-4b", full, smoke)

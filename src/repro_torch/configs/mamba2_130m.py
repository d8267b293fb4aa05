"""mamba2-130m [ssm]: 24L d=768 attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060]. O(1) decode state; no KV
cache, so no attention kernel runs.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=1,          # attention-free; unused
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        layer_pattern=("mamba",),
        mlp_pattern=("none",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk=256),
        tie_embeddings=True,
        microbatch_tokens=1 << 17,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=1,
        num_kv_heads=1,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        layer_pattern=("mamba",),
        mlp_pattern=("none",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                      chunk=32),
        tie_embeddings=True,
    )


register("mamba2-130m", full, smoke)

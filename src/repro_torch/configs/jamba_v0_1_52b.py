"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2, Mamba:attention 7:1 interleave [arXiv:2403.19887].

Period-8 block: attention at position 4, Mamba elsewhere; MoE every other
layer. SSM blocks are Mamba2/SSD with d_state=128 (the reference's
deviation from Jamba's Mamba1 d_state=16: one SSD implementation serves
both SSM archs). Attention layers use a 4096 sliding window.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        attn_kind="swa",
        window=4096,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        mlp_pattern=("dense", "moe") * 4,
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk=256),
        fsdp=True,
        microbatch_tokens=1 << 17,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        num_layers=8,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_kind="swa",
        window=16,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        mlp_pattern=("dense", "moe") * 4,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                      chunk=32),
    )


register("jamba-v0.1-52b", full, smoke)

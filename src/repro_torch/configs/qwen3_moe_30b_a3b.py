"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

head_dim=128 per the published config (decoupled from d_model/num_heads).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=6144,  # unused: every layer is MoE (mlp_pattern)
        vocab_size=151936,
        rope_theta=1000000.0,
        mlp_pattern=("moe",),
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
        fsdp=True,
        microbatch_tokens=1 << 18,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_pattern=("moe",),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32),
    )


register("qwen3-moe-30b-a3b", full, smoke)

"""deepseek-v2-lite-16b [moe]: 27L d=2048 MLA(kv_lora=512) expert_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, first layer dense
[arXiv:2405.04434].

MLA's attention runs on the plain route (``models/layers.py``
``sdpa_plain``): its q/k head of 192 against a v head of 128 (576 against
512 in the absorbed decode) is a shape no attention kernel takes.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,  # the first (dense) layer
        vocab_size=102400,
        rope_theta=10000.0,
        mlp_pattern=("moe",),
        first_k_dense=1,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
        fsdp=True,
        microbatch_tokens=1 << 18,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_pattern=("moe",),
        first_k_dense=1,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1),
    )


register("deepseek-v2-lite-16b", full, smoke)

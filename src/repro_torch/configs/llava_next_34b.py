"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Anyres tiling [hf:llava-hf/llava-v1.6]. Transformer BACKBONE only: the
vision tower / anyres tiling frontend is a STUB, the model takes
precomputed projector-output patch embeddings (B, 2880, d_model). 7 query
heads a KV head; the serve cache is fp8 e4m3.
"""

import torch

from repro_torch.configs.base import ModelConfig, VLMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5000000.0,
        vlm=VLMConfig(num_patch_tokens=2880),
        fsdp=True,
        remat_group=10,
        microbatch_tokens=1 << 16,
        serve_cache_dtype=torch.float8_e4m3fn,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        vlm=VLMConfig(num_patch_tokens=8),
    )


register("llava-next-34b", full, smoke)

"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

GQA + 128k vocab [arXiv:2407.21783]. 128 query heads over 8 KV heads (16
a KV head); the serve cache is fp8 e4m3.
"""

import torch

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=500000.0,
        fsdp=True,
        optimizer="adafactor",
        optstate_dtype=torch.bfloat16,
        grad_accum_dtype=torch.bfloat16,
        remat="full",
        remat_group=9,
        microbatch_tokens=1 << 16,
        serve_cache_dtype=torch.float8_e4m3fn,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rope_theta=500000.0,
    )


register("llama3-405b", full, smoke)

from repro_torch.configs.base import (
    SHAPES,
    AudioConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    VLMConfig,
    cells,
    get_config,
    list_archs,
    register,
)

# The 10 assigned architectures.
ASSIGNED = (
    "llama3-405b",
    "h2o-danube-1.8b",
    "minitron-4b",
    "smollm-360m",
    "qwen3-moe-30b-a3b",
    "deepseek-v2-lite-16b",
    "mamba2-130m",
    "llava-next-34b",
    "jamba-v0.1-52b",
    "seamless-m4t-large-v2",
)

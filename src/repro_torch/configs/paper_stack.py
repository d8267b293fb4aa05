"""The parts of the paper's model stack that the port runs.

* the embedding width and the §3.1 specificity model's configuration;
* ``llava-next-8b``, the KV-cache VLM of compressed KV-cache batching
  (§3.2; a llama3-8B backbone behind a stub vision frontend), full and
  smoke.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, VLMConfig, register

EMBED_DIM = 1152  # SigLIP so400m embedding width — the histogram's vector dim


def llava8b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-8b",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        vlm=VLMConfig(num_patch_tokens=2880),
    )


def llava8b_smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-8b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        vlm=VLMConfig(num_patch_tokens=8),
    )


register("llava-next-8b", llava8b, llava8b_smoke)


@dataclasses.dataclass(frozen=True)
class SpecificityModelConfig:
    """The paper's §3.1 specificity model: predicate embedding -> threshold."""

    embed_dim: int = EMBED_DIM
    hidden: tuple[int, ...] = (512, 256)
    # training
    lr: float = 1e-3
    steps: int = 2000
    batch: int = 256

"""The paper's own model stack (Semantic Histograms, §2/§3/§4):

  * siglip-text-so400m — the SigLIP2-class embedding tower that populates the
    Semantic Histogram and embeds filter predicates (embed_dim=1152; the
    decoder-only stack stands in for the encoder-only text tower, as in the
    reference);
  * llava-next-8b      — the KV-cache VLM of compressed KV-cache batching
    (§3.2; a llama3-8B backbone behind a stub vision frontend);
  * qwen25-vl-7b       — the execution VLM answering "Is <predicate>
    depicted?" in the filter cascade.

These register like the assigned archs, full and smoke.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, VLMConfig, register

EMBED_DIM = 1152  # SigLIP so400m embedding width — the histogram's vector dim


def siglip_text() -> ModelConfig:
    return ModelConfig(
        name="siglip-text-so400m",
        family="dense",
        num_layers=27,
        d_model=1152,
        num_heads=16,
        num_kv_heads=16,
        head_dim=72,
        d_ff=4304,
        vocab_size=32000,
        rope_theta=10000.0,
    )


def siglip_smoke() -> ModelConfig:
    return ModelConfig(
        name="siglip-smoke", family="dense", num_layers=2, d_model=32,
        num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
    )


def llava8b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-8b",
        family="vlm",
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
        name="llava-next-8b-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        vlm=VLMConfig(num_patch_tokens=8),
    )


def qwen25vl() -> ModelConfig:
    return ModelConfig(
        name="qwen25-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        rope_theta=1000000.0,
        vlm=VLMConfig(num_patch_tokens=2880),
    )


def qwen25vl_smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen25-vl-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        vlm=VLMConfig(num_patch_tokens=8),
    )


register("siglip-text-so400m", siglip_text, siglip_smoke)
register("llava-next-8b", llava8b, llava8b_smoke)
register("qwen25-vl-7b", qwen25vl, qwen25vl_smoke)


@dataclasses.dataclass(frozen=True)
class SpecificityModelConfig:
    """The paper's §3.1 specificity model: predicate embedding -> threshold."""

    embed_dim: int = EMBED_DIM
    hidden: tuple[int, ...] = (512, 256)
    # training
    lr: float = 1e-3
    steps: int = 2000
    batch: int = 256

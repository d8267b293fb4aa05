"""The parts of the paper's model stack that the estimate path needs.

Only the embedding width and the §3.1 specificity model's configuration;
the VLM configurations arrive with the KV-batch slice.
"""

import dataclasses

EMBED_DIM = 1152  # SigLIP so400m embedding width — the histogram's vector dim


@dataclasses.dataclass(frozen=True)
class SpecificityModelConfig:
    """The paper's §3.1 specificity model: predicate embedding -> threshold."""

    embed_dim: int = EMBED_DIM
    hidden: tuple[int, ...] = (512, 256)
    # training
    lr: float = 1e-3
    steps: int = 2000
    batch: int = 256

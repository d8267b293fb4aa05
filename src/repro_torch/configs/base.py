"""Config system: a typed dataclass per model + a registry keyed by arch ids.

The fields are those the dense attention stack reads (``models/``); dtypes
are torch dtypes. ``mla`` and ``encdec`` are kept so that the model raises
on a config that needs MLA or an encoder-decoder (ROADMAP item 14).
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Modality frontend STUB: the model takes precomputed patch embeddings."""

    num_patch_tokens: int = 2880   # anyres 5 tiles x 576


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A dense decoder: full causal GQA attention and a SwiGLU MLP in every
    layer, untied input embedding and output head."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    mla: Any = None                # not ported: raises (ROADMAP item 14)
    vlm: VLMConfig | None = None
    encdec: bool = False           # not ported: raises (ROADMAP item 14)
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.num_heads))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def _load_all():
    import repro_torch.configs as pkg

    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.name not in ("base", "__init__"):
            importlib.import_module(f"repro_torch.configs.{mod.name}")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    _load_all()
    table = _SMOKE if smoke else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(table)}")
    return table[arch_id]()

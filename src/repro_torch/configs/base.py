"""Config system: typed dataclasses + a registry keyed by ``--arch`` ids,
as in ``repro/configs/base.py``, with torch dtypes.

Every assigned architecture has one file in this package registering (a)
the full production config and (b) a ``smoke`` reduction of the same
family. The training step (``models/steps.py``) reads the memory-policy
fields: ``optimizer``, ``optstate_dtype``, ``grad_accum_dtype``,
``remat``, ``remat_group`` and ``microbatch_tokens``; the specs read
the sharding fields (``fsdp``, ``attn_head_dim_sharding``: the logical
axes a weight carries) and the train forward ``seq_sharding`` (the
residual's placement between repeats).
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert ffn hidden size
    num_shared: int = 0           # shared (always-on) experts
    router_jitter: float = 0.0
    capacity_factor: float = 1.25  # the capacity dispatch's slots per expert
    dispatch: str = "dense"        # the capacity dispatch (the only one)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Modality frontend STUB: the model takes precomputed patch embeddings."""

    num_patch_tokens: int = 2880   # anyres 5 tiles x 576
    patch_embed_dim: int = 0       # 0 -> equals d_model (projector output)


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Speech frontend STUB: precomputed frame embeddings feed the encoder."""

    frame_dim: int = 0             # 0 -> equals d_model
    dec_len_ratio: float = 1.0     # decoder seq = ratio * shape seq


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention
    attn_kind: str = "full"        # full | swa
    window: int = 4096             # swa window
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # heterogeneous stacks: layer_pattern repeats over the stack ("attn" |
    # "mamba"); mlp_pattern repeats in lockstep ("dense" | "moe" | "none")
    layer_pattern: tuple[str, ...] = ("attn",)
    mlp_pattern: tuple[str, ...] = ("dense",)
    first_k_dense: int = 0         # leading layers forced to dense mlp
    # sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    vlm: VLMConfig | None = None
    audio: AudioConfig | None = None
    encdec: bool = False
    num_enc_layers: int = 0        # enc-dec only
    # numerics / memory policy
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    optstate_dtype: Any = torch.float32
    optimizer: str = "adamw"            # adamw | adafactor
    grad_accum_dtype: Any = torch.float32
    serve_cache_dtype: Any = None        # None -> compute_dtype
    remat: str = "full"            # full | dots | none
    remat_group: int = 0
    seq_sharding: bool = False
    attn_head_dim_sharding: bool = False
    microbatch_tokens: int = 1 << 19
    fsdp: bool = False
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.num_heads))
        if self.num_layers % len(self.layer_pattern):
            raise ValueError("layer_pattern must tile num_layers")

    @property
    def attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return self.attention_free or self.attn_kind == "swa"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatch: int = 0            # 0 -> auto (grad accumulation divisor)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def cells(arch_id: str) -> list[str]:
    """Live (non-skipped) shape names for an arch: long_500k only for a
    sub-quadratic one."""
    cfg = get_config(arch_id)
    return [s.name for s in SHAPES.values()
            if s.name != "long_500k" or cfg.sub_quadratic]

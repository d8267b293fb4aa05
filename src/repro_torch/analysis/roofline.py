"""Roofline terms of a counted step, on the card's own peaks
(``repro/analysis/roofline.py`` for the port):

    compute_term = sum over dtypes of FLOPs / peak rate of that dtype  [s]
    memory_term  = bytes / device-memory rate                         [s]

The FLOPs and bytes come from ``analysis/cost.py`` (a count, not HLO). One
process has no partitioner, so a step's collectives are not known and
there is no collective term: the bottleneck is the larger of the two. The
ring formulas of the reference's ``parse_collectives`` are kept
(``wire_bytes``) for what the port does move itself
(``optim/grad_compression.py``).

Peaks are the published dense rates (no sparsity) of the card, matched on
the name ``nvidia-smi`` gives, at its full power limit: the H100 SXM data
sheet gives 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor
cores, 989 TFLOP/s in bf16, 1,979 in fp8, 80 GB, and 900 GB/s of NVLink in
total (450 GB/s each way).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    hbm_bw: float       # bytes/s
    fp32: float         # FLOP/s outside the tensor cores
    bf16: float         # FLOP/s, dense tensor cores (fp16 alike)
    fp8: float          # FLOP/s, dense tensor cores (int8 alike)
    link_bw: float      # NVLink bytes/s, one direction
    hbm_bytes: float    # device memory


# first match wins: "H100 PCIe" before "H100"
PEAKS = [
    Peaks("H100 PCIe", 2.0e12, 51e12, 756e12, 1513e12, 3.0e11, 80e9),
    Peaks("H100", 3.35e12, 67e12, 989e12, 1979e12, 4.5e11, 80e9),
]
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"      # an H100 SXM, as nvidia-smi names it


def peaks(name: str = DEFAULT_CARD) -> Peaks:
    """The peaks of the card ``name`` (``nvidia-smi``'s or torch's name);
    raises for a card with none known."""
    for p in PEAKS:
        if p.name in name:
            return p
    raise KeyError(f"no peak rates known for {name!r}")


def flop_rate(p: Peaks, dtype: str) -> float:
    """The peak rate of products whose operands are ``dtype`` (its torch
    name without ``torch.``)."""
    if dtype in ("bfloat16", "float16"):
        return p.bf16
    if dtype.startswith("float8") or dtype == "int8":
        return p.fp8
    return p.fp32


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Bytes one device sends for a collective over a group of ``g``, by
    the ring algorithm (``parse_collectives``): ``nbytes`` is the result's
    size (the input's for reduce-scatter's result times g).

      all-gather:         (g-1)/g * R
      all-reduce:         2 * (g-1)/g * R   (reduce-scatter + all-gather)
      reduce-scatter:     (g-1)/g * R * g   (input = g * result)
      all-to-all:         (g-1)/g * R
      collective-permute: R
    """
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return (g - 1) / g * nbytes
    if kind == "all-reduce":
        return 2 * (g - 1) / g * nbytes
    if kind == "reduce-scatter":
        return (g - 1) / g * nbytes * g
    if kind == "all-to-all":
        return (g - 1) / g * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    compute_term: float
    memory_term: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    card: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(cost, *, model_flops: float = 0.0, card: str = DEFAULT_CARD
            ) -> Roofline:
    """Roofline terms of ``cost`` (an ``analysis.cost.Cost``) at the peaks
    of ``card``."""
    p = peaks(card)
    by_dtype = cost.flops_by_dtype or ({"float32": cost.flops}
                                       if cost.flops else {})
    ct = sum(f / flop_rate(p, dt) for dt, f in by_dtype.items())
    mt = cost.hbm_bytes / p.hbm_bw
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, compute_term=ct,
        memory_term=mt, bottleneck="compute" if ct >= mt else "memory",
        model_flops=model_flops,
        useful_ratio=model_flops / cost.flops if cost.flops else 0.0,
        card=p.name)


def model_flops_train(cfg, shape) -> float:
    """6 N D (dense) / 6 N_active D (MoE): the useful-FLOPs yardstick."""
    tokens = shape.global_batch * shape.seq_len
    return 6.0 * active_param_count(cfg) * tokens


def model_flops_step(cfg, shape) -> float:
    if shape.kind == "train":
        return model_flops_train(cfg, shape)
    n = active_param_count(cfg)
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token a sequence


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: the top_k and shared experts)."""
    from repro_torch.models import nn
    from repro_torch.models.steps import model_specs

    total = nn.count_params(model_specs(cfg))
    if cfg.moe is None:
        return total
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    per_layer_expert = 3 * cfg.d_model * cfg.moe.d_expert   # gate/up/down
    P = len(cfg.mlp_pattern)
    moe_layers = sum(1 for j in range(cfg.num_layers)
                     if j >= cfg.first_k_dense
                     and cfg.mlp_pattern[j % P] == "moe")
    return total - moe_layers * (E - K) * per_layer_expert

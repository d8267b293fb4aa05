"""Gradient compression for the slow cross-pod links
(``repro/optim/grad_compression.py``).

Two-tier reduction: a full-precision sum over the fast intra-pod "data"
axis, then a compressed sum over the slow inter-pod "pod" axis, with error
feedback so the compression noise is unbiased over steps.

Two codecs:
  * ``int8`` — per-tensor absmax scale, round half to even and clip to
    +-127, as the reference's;
  * ``topk`` — error-feedback magnitude top-k (k a fraction), realized
    densely (masked).

``two_stage_allreduce`` runs over a one-process mesh, as the port's probe
mesh does (``launch/mesh.py``): one process holds every shard. Each local
gradient carries a leading dim for each mesh axis, in the mesh's axis
order (shard (p, d, ...) at ``g[p, d, ...]``); every shard gets the
result.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.analysis.roofline import wire_bytes
from repro_torch.models import nn

f32 = torch.float32


# ---------------------------- codecs ---------------------------------------


def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(f32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, dtype=f32
                ) -> torch.Tensor:
    return (q.to(f32) * scale).to(dtype)


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top ``frac`` fraction of entries by magnitude (dense mask)."""
    flat = x.reshape(-1).to(f32).abs()
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (x.to(f32).abs() >= thresh).to(x.dtype)


# ------------------------ error-feedback wrapper ----------------------------


def ef_init(params: Any) -> Any:
    return nn.tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                             device=p.device), params)


def ef_compress(grads: Any, ef: Any, *, codec: str = "int8",
                topk_frac: float = 0.01):
    """Returns (compressed-then-decompressed grads, new error buffers): the
    decompressed value enters the optimizer, the residual stays in the
    buffer."""

    def one(g, e):
        target = g.to(f32) + e
        if codec == "int8":
            rec = int8_decode(*int8_encode(target))
        elif codec == "topk":
            rec = target * topk_mask(target, topk_frac).to(f32)
        else:
            raise ValueError(codec)
        return rec.to(g.dtype), target - rec

    outs = [one(g, e) for g, e in zip(nn.tree_leaves(grads),
                                      nn.tree_leaves(ef))]
    return (nn.tree_unflatten(grads, [o[0] for o in outs]),
            nn.tree_unflatten(grads, [o[1] for o in outs]))


# ------------------------ two-stage reduction -------------------------------


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 left to right: the same rounding on every device."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def two_stage_allreduce(local_grads: Any, *, mesh, codec: str = "int8",
                        wire: dict | None = None) -> Any:
    """Float32 sum over "data", then over "pod" the int8 codes of each
    device's sum added in int32 and rescaled by the largest of the pods'
    scales (``codec="int8"``; otherwise a float32 sum). Every shard gets
    the result. Without a "pod" axis the local gradients come back as
    they are (the reference's identity). Sums run left to right over the
    shards, so a card's result is bitwise the CPU's.

    ``wire``, a dict, gets the bytes one device sends on each axis by the
    ring formulas (``analysis/roofline.py`` ``wire_bytes``): the "data"
    all-reduce of float32, and on "pod" the all-reduce of the codes, in
    int32 as the reference sums them (4 bytes an element: int8 codes on
    the wire would need a reduction that widens in flight), plus the
    scales' max."""
    names = list(mesh.shape)
    if "pod" not in names:
        return local_grads
    k = len(names)
    n_pod, n_data = mesh.shape["pod"], mesh.shape["data"]
    pod, data = names.index("pod"), names.index("data")

    def reduce_one(g):
        block = g.shape[k:]
        x = g.to(f32).movedim((pod, data), (0, 1))
        rest = x.shape[2:k]
        x = x.reshape(n_pod, n_data, -1, *block)          # (P, D, R, *block)
        s = _sum0(x.movedim(1, 0))                         # over "data"
        n = math.prod(block)
        if codec == "int8":
            dims = tuple(range(2, s.dim()))
            amax = s.abs().amax(dim=dims, keepdim=True) if dims else s.abs()
            scale = torch.clamp(amax, min=1e-12) / 127.0    # a device's own
            q = torch.clamp(torch.round(s / scale), -127, 127).to(torch.int8)
            red = _sum0(q.to(torch.int32)).to(f32) * scale.amax(dim=0)
            pod_bytes = wire_bytes("all-reduce", 4 * n, n_pod) + wire_bytes(
                "all-reduce", 4, n_pod)
        else:
            red = _sum0(s)
            pod_bytes = wire_bytes("all-reduce", 4 * n, n_pod)
        if wire is not None:
            wire["data"] = wire.get("data", 0.0) + wire_bytes(
                "all-reduce", 4 * n, n_data)
            wire["pod"] = wire.get("pod", 0.0) + pod_bytes
        out = red.reshape(*rest, *block).expand(n_pod, n_data, *rest, *block)
        return out.movedim((0, 1), (pod, data)).contiguous()

    return nn.tree_map(reduce_one, local_grads)

"""Parameter specs and initialisation for the port's models.

A model is described by a tree (dicts and lists) of :class:`ParamSpec`
leaves; ``init_params`` turns it into a tree of tensors on one device.

Initialisation follows the reference (``repro/models/nn.py`` ``_init_leaf``):
weights truncated normal in ±2 standard deviations with std = scale /
sqrt(fan_in), ``embed`` leaves normal times scale, norms ones, and zeros.
The draws come from a ``torch.Generator`` on the target device, one leaf at
a time and in row chunks of at most ``CHUNK`` values, each chunk drawn in
float32 and written straight into the leaf's dtype: an 8B model's bf16
parameters never have a float32 copy. ``jax.random`` bits cannot be
reproduced in torch, so ``params_from_numpy`` carries the reference's own
parameters across for the parity tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

f32 = torch.float32
CHUNK = 1 << 26        # values drawn in float32 at a time (256 MB)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0


def dense(shape, dtype=torch.bfloat16, scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "normal", scale)


def embedding(shape, dtype=torch.bfloat16, scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "embed", scale)


def zeros(shape, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "zeros")


def ones(shape, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "ones")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (``rest`` mirror
    ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _fan_in(shape: tuple[int, ...]) -> int:
    # all-but-last dims feed in for the [in..., out] weight convention
    return max(1, math.prod(shape[:-1]))


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "zeros":
        return out.zero_()
    if spec.init == "ones":
        return out.fill_(1.0)
    flat = out.view(-1)
    std = spec.scale if spec.init == "embed" else (
        spec.scale / math.sqrt(_fan_in(spec.shape)))
    for i in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - i)
        t = torch.empty((n,), dtype=f32, device=device)
        if spec.init == "embed":
            t.normal_(generator=gen)
        else:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[i:i + n].copy_(t.mul_(std))
    return out


def init_params(specs: Any, gen: torch.Generator, device=None) -> Any:
    """Materialize a spec tree into tensors on ``device`` (``gen``'s device
    by default), leaf by leaf in tree order."""
    device = gen.device if device is None else torch.device(device)
    return tree_map(lambda s: _init_leaf(s, gen, device), specs)


def params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """The reference's param tree (numpy arrays) as the port's params.

    The reference stacks layers over a leading axis: an LM has
    ``first`` (the unstacked leading layers) and ``blocks`` (one tree per
    period position, each stacked over the repeats:
    ``repro/models/lm.py`` ``stack_layout``); an encoder-decoder has
    ``enc_blocks`` and ``dec_blocks``. The port keeps one dict per layer
    in global order (``layers``; ``enc_layers`` and ``dec_layers``). Each
    leaf is cast to its spec's dtype; a tied LM has no ``head``.
    """
    from repro_torch.models.lm import stack_layout
    from repro_torch.models.steps import model_specs

    def layer(stacked, r):
        return tree_map(lambda a: a[r], stacked)

    if cfg.encdec:
        src = dict(tree)
        src["enc_layers"] = [layer(tree["enc_blocks"], r) for r in
                             range(cfg.num_enc_layers or cfg.num_layers)]
        src["dec_layers"] = [layer(tree["dec_blocks"], r)
                             for r in range(cfg.num_layers)]
    else:
        first_k, P, R = stack_layout(cfg)
        if len(tree["first"]) != first_k or len(tree["blocks"]) != P:
            raise ValueError(f"{cfg.name}: the tree has {len(tree['first'])} "
                             f"leading layers and {len(tree['blocks'])} "
                             f"period positions, the config {first_k} and {P}")
        src = dict(tree)
        src["layers"] = list(tree["first"]) + [
            layer(tree["blocks"][j], r) for r in range(R) for j in range(P)]
    specs = model_specs(cfg)
    return tree_map(
        lambda s, a: torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=s.dtype),
        specs, {k: src[k] for k in specs})

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


def tree_unflatten(tree, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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


def abstract_params(specs: Any) -> Any:
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes,
    no memory (sizing a model that does not fit)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def tree_bytes(specs: Any) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(specs))


def _per_layer(tree: dict, cfg, take) -> dict:
    """The reference's stacked tree in the port's layout, leaves not yet
    converted: a stacked leaf's repeat r becomes ``take(leaf, r)``.

    The reference stacks layers over a leading axis: an LM has
    ``first`` (the unstacked leading layers) and ``blocks`` (one tree per
    period position, each stacked over the repeats:
    ``repro/models/lm.py`` ``stack_layout``); an encoder-decoder has
    ``enc_blocks`` and ``dec_blocks``. The port keeps one dict per layer
    in global order (``layers``; ``enc_layers`` and ``dec_layers``); a
    tied LM has no ``head``."""
    from repro_torch.models.lm import stack_layout
    from repro_torch.models.steps import model_specs

    def layer(stacked, r):
        return tree_map(lambda a: take(a, r), stacked)

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
    return {k: src[k] for k in model_specs(cfg)}


class Stack:
    """The per-layer tensors of one of the reference's stacked leaves, in
    repeat order: a leaf to ``tree_map`` and ``tree_leaves``."""

    def __init__(self, xs):
        self.xs = list(xs)

    @property
    def shape(self) -> tuple:
        return (len(self.xs), *self.xs[0].shape)

    @property
    def device(self) -> torch.device:
        return self.xs[0].device


def stacked(tree: dict, cfg) -> dict:
    """The port's per-layer tree grouped as the reference stacks it (the
    inverse of ``_per_layer``): ``first`` and ``blocks`` (or
    ``enc_blocks`` and ``dec_blocks``), each stacked leaf a ``Stack`` of
    its repeats' tensors; the other keys as they are."""
    from repro_torch.models.lm import stack_layout

    def stack(layers):
        return tree_map(lambda *xs: Stack(xs), *layers)

    out = dict(tree)
    if cfg.encdec:
        out["enc_blocks"] = stack(out.pop("enc_layers"))
        out["dec_blocks"] = stack(out.pop("dec_layers"))
    else:
        first_k, P, _ = stack_layout(cfg)
        layers = out.pop("layers")
        out["first"] = layers[:first_k]
        out["blocks"] = [stack(layers[first_k + j::P]) for j in range(P)]
    return out


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                         dtype=dtype)


def params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """The reference's param tree (numpy arrays) as the port's params
    (``_per_layer``), each leaf cast to its spec's dtype."""
    from repro_torch.models.steps import model_specs

    return tree_map(lambda s, a: _tensor(a, s.dtype, device),
                    model_specs(cfg),
                    _per_layer(tree, cfg, lambda a, r: a[r]))


def train_state_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """The reference's train state ``{"params", "opt"}`` (numpy arrays:
    ``repro.models.steps.make_train_state``'s, at any step) as the port's.
    AdamW's m and v, or Adafactor's momentum, follow the params' layout in
    ``cfg.optstate_dtype``; Adafactor's statistics keep the reference's
    stacked layout (``stacked``), float32, as they are; the step is a 0-d
    int32 tensor."""
    from repro_torch.models.steps import model_specs

    specs = model_specs(cfg)
    params = params_from_numpy(tree["params"], cfg, device)
    opt = tree["opt"]

    def moments(t):
        return tree_map(lambda s, a: _tensor(a, cfg.optstate_dtype, device),
                        specs, _per_layer(t, cfg, lambda a, r: a[r]))

    def stats(t):
        return tree_map(lambda _, a: _tensor(a, f32, device),
                        stacked(params, cfg), t)

    out = {"m": moments(opt["m"]),
           "step": torch.tensor(int(np.asarray(opt["step"])),
                                dtype=torch.int32, device=device)}
    if "v" in opt:
        out["v"] = moments(opt["v"])
    else:
        out["vr"], out["vc"] = stats(opt["vr"]), stats(opt["vc"])
    return {"params": params, "opt": out}

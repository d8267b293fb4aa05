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

Each leaf also carries the reference's logical axis names (``"embed"``,
``"heads"``, ``"vocab"``, ...: ``repro/models/nn.py``). ``resolve_pspec``
turns them into a placement on a named-axis mesh (``launch/mesh.py``
``Mesh``) by the reference's prioritised rules with its divisibility
fallback; ``param_shardings`` does so for a whole tree. One process on one
card has no partitioner, so a ``Placement`` is a description, not a
layout: the dry-run reads each leaf's per-device shape and bytes from it,
and a restore puts the leaf on the placement's device.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

f32 = torch.float32
CHUNK = 1 << 26        # values drawn in float32 at a time (256 MB)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    # one logical axis name (or None) per dim, e.g. ("embed", "heads", "head_dim")
    axes: tuple[str | None, ...] = ()
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")


def dense(shape, axes, dtype=torch.bfloat16, scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, tuple(axes), "normal", scale)


def embedding(shape, axes, dtype=torch.bfloat16, scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, tuple(axes), "embed", scale)


def zeros(shape, axes, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, tuple(axes), "zeros")


def ones(shape, axes, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, tuple(axes), "ones")


def stack_spec(spec: ParamSpec, n: int, axis_name: str = "layers"
               ) -> ParamSpec:
    """``spec`` with a leading stacking dim of ``n`` (the reference's
    ``stack_specs`` for one leaf)."""
    return ParamSpec((n, *spec.shape), spec.dtype,
                     (axis_name, *(spec.axes or (None,) * len(spec.shape))),
                     spec.init, spec.scale)


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


# ---------------------------------------------------------------------------
# Logical -> physical axis resolution
# ---------------------------------------------------------------------------

# Priority-ordered candidate mesh axes per logical axis (the reference's
# rules). The first candidate whose size divides the dim and that no other
# dim of the leaf has claimed wins; ("pod", "data") shards over the product
# of both axes.
DEFAULT_RULES: dict[str, Sequence[Any]] = {
    "batch": [("pod", "data"), "data"],
    "embed": [None],                      # replicated unless FSDP rules used
    "embed_fsdp": [("pod", "data"), "data", None],  # ZeRO-3 weight shard
    "heads": ["model"],
    "kv_heads": ["model", None],
    "head_dim": [None],
    # cache-only fallback: when kv_heads < model size (GQA on wide TP), shard
    # the cache's head_dim
    "cache_head_dim": ["model", None],
    "kv_lora_w": [None],
    "mlp": ["model"],
    "experts": ["model"],
    "expert_mlp": [None],
    "vocab": ["model"],
    "kv_lora": ["model", None],   # MLA latent cache shards on model
    "q_lora": ["model", None],
    "seq": [None],
    "seq_sp": ["model", None],    # sequence parallelism (Megatron-SP)
    "store": [("pod", "data"), "data"],
    "cache_batch": [("pod", "data"), "data"],
    "layers": [None],
    "conv": [None],
    "state": [None],
    "ssm_heads": ["model", None],
    "sample": ["data", None],
}


def _axis_size(mesh, axis: Any) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis if a in mesh.shape)
    return mesh.shape.get(axis, 0)


def _axis_names(axis: Any) -> tuple[str, ...]:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's shards lie on ``mesh``: one entry per dim, a mesh
    axis, a tuple of axes (sharded over their product) or None
    (replicated), as the reference's ``PartitionSpec``. A shard's device
    is the mesh's (``launch/mesh.py`` ``Mesh.device``): one process holds
    every shard."""

    mesh: Any
    spec: tuple = ()

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One device's block of a tensor of ``shape`` (``spec`` padded
        with None to its rank)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(int(d) // _axis_size(self.mesh, a)
                     for d, a in zip(shape, spec))

    def shard_bytes(self, x) -> int:
        """One device's bytes of ``x`` (anything with ``shape`` and a torch
        ``dtype``)."""
        return math.prod(self.shard_shape(x.shape)) * x.dtype.itemsize

    @property
    def device(self) -> torch.device:
        return self.mesh.torch_device()

    def to_json(self) -> list:
        return [list(a) if isinstance(a, tuple) else a for a in self.spec]


def resolve_pspec(shape: tuple[int, ...], axes: tuple[str | None, ...],
                  mesh, rules: dict[str, Sequence[Any]] | None = None
                  ) -> tuple:
    """Resolve logical axes to one placement entry per dim, with the
    reference's divisibility fallback (``repro/models/nn.py``
    ``resolve_pspec``); ``mesh`` needs only ``shape``, a dict of axis
    sizes."""
    rules = rules or DEFAULT_RULES
    if not axes:
        axes = (None,) * len(shape)
    taken: set[str] = set()
    out: list[Any] = []
    for dim, name in zip(shape, axes):
        placed = None
        if name is not None:
            for cand in rules.get(name, [None]):
                if cand is None:
                    break
                names = _axis_names(cand)
                if any(n not in mesh.shape for n in names):
                    continue
                if any(n in taken for n in names):
                    continue
                size = _axis_size(mesh, cand)
                if size > 0 and dim % size == 0:
                    placed = cand
                    taken.update(names)
                    break
        out.append(placed)
    return tuple(out)


def param_shardings(specs: Any, mesh, rules=None) -> Any:
    """A ``Placement`` for every leaf of a spec tree.

    The reference stacks a period position's layers into one leaf with a
    leading ``"layers"`` axis; the port keeps a leaf a layer. ``"layers"``
    never places (its rule is [None]) and so claims no mesh axis: a
    per-layer leaf resolves to its stacked leaf's placement without the
    leading entry. A rule set that would place it is refused."""
    rules = rules or DEFAULT_RULES
    if any(c is not None for c in rules.get("layers", [None])):
        raise ValueError("a per-layer leaf cannot hold a sharded 'layers' "
                         "axis")
    return tree_map(lambda s: Placement(
        mesh, resolve_pspec(s.shape, s.axes, mesh, rules)), specs)


def stacked_specs(specs: dict, cfg) -> dict:
    """The port's spec tree in the reference's stacked layout (``stacked``),
    each stacked leaf one ``ParamSpec`` with the leading ``"layers"``
    axis."""
    return tree_map(lambda x: stack_spec(x.xs[0], len(x.xs))
                    if isinstance(x, Stack) else x, stacked(specs, cfg))


@dataclasses.dataclass
class MeshScope:
    """The mesh ``logical_constraint`` resolves against, and what it saw:
    ``constraints`` maps (logical axes, shape) to [placement entries,
    calls]."""

    mesh: Any
    constraints: dict = dataclasses.field(default_factory=dict)


_MESH_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def logical_constraint(x: torch.Tensor, axes: tuple[str | None, ...],
                       mesh=None, rules=None) -> torch.Tensor:
    """The reference's sharding constraint by logical axes. One process has
    no partitioner, so ``x`` comes back unchanged; inside ``mesh_context``
    the placement is resolved and recorded (the dry-run lists the
    activations' placements). Outside a context: one ``ContextVar``
    read."""
    scope = _MESH_CTX.get()
    if scope is None and mesh is None:
        return x
    m = mesh if mesh is not None else scope.mesh
    spec = resolve_pspec(tuple(x.shape), axes, m, rules)
    if scope is not None:
        rec = scope.constraints.setdefault((tuple(axes), tuple(x.shape)),
                                           [spec, 0])
        rec[1] += 1
    return x


def mesh_context(mesh):
    """Make ``mesh`` visible to ``logical_constraint``; yields the
    ``MeshScope`` that records its calls."""

    @contextlib.contextmanager
    def _ctx():
        scope = MeshScope(mesh)
        tok = _MESH_CTX.set(scope)
        try:
            yield scope
        finally:
            _MESH_CTX.reset(tok)

    return _ctx()

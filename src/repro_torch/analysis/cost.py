"""FLOP and byte count of a step: the port's counterpart of the reference's
``repro/analysis/hlo_cost.py``. There is no HLO to parse, so the count is
taken where the ops run, by a ``TorchDispatchMode`` that sees every aten op
(forward, autograd's backward and checkpoint recomputation alike):

  * flops — dot-like ops only (matrix products, batched products,
    convolutions, SDPA), by the formulas of ``torch.utils.flop_counter``;
    elementwise work is left out, as ``hlo_cost`` leaves it out;
  * hbm_bytes — operands plus outputs of every op that moves data; views,
    ``empty`` and metadata ops move none (the counterpart of
    ``hlo_cost``'s ``_NO_TRAFFIC``). A region marked ``fused`` counts its
    FLOPs and only its boundary bytes (its tensor inputs and outputs), as
    an HLO fusion's traffic is its boundary;
  * a breakdown per op (``Cost.ops``) and FLOPs per operand dtype.

It runs on the meta device (the dry-run: shapes only, no memory) and on
the card. There the hand-written kernels are ``ctypes`` launches that the
dispatcher never sees: they count as nothing, just as ``hlo_cost`` counts a
Pallas custom call as nothing. On the meta device (and the CPU) the ops
route attention to its plain version, marked ``fused`` and given the
kernel's own FLOPs (``attention_flops``: the (query, key) pairs its mask
lets through, not the plain version's full product), so the count holds
the attention's work that the card's kernels hide.

Loop awareness: ``hlo_cost`` multiplies a while body by its trip count.
The train step's microbatches are identical trips, and it iterates them
through ``trips(m, like)``: under a ``CostMode`` and on meta tensors
(``like``'s device) that runs one trip whose count is multiplied by m, as
meta tensors hold no values to get wrong. On any other device it is
``range(m)``: every trip runs, counted or not.

One ``CostMode`` is active in a process at a time.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that move no data: allocation without a fill, aliasing and metadata
_NO_TRAFFIC = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size, aten._unsafe_view,
    aten._reshape_alias,
}

_ACTIVE: list = []        # the CostMode in force, if any
_KINDS: dict = {}         # op overload -> (name, flop formula, moves data)


def active() -> "CostMode | None":
    return _ACTIVE[-1] if _ACTIVE else None


def _tensors(*trees) -> list[torch.Tensor]:
    """The distinct tensors in ``trees`` (nested lists, tuples, dicts)."""
    seen, out, todo = set(), [], list(trees)
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    flops_by_dtype: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    ops: dict = dataclasses.field(default_factory=lambda: defaultdict(
        lambda: {"count": 0.0, "flops": 0.0, "bytes": 0.0}))

    def add(self, name: str, *, flops: float = 0.0, nbytes: float = 0.0,
            dtype=None, count: float = 1.0) -> None:
        rec = self.ops[name]
        rec["count"] += count
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes
        if flops:
            self.flops_by_dtype[str(dtype).replace("torch.", "")] += flops

    def scaled(self, f: float) -> "Cost":
        """Every count times ``f`` (a global count over a mesh's size)."""
        out = Cost(self.flops * f, self.hbm_bytes * f)
        for k, v in self.flops_by_dtype.items():
            out.flops_by_dtype[k] = v * f
        for k, v in self.ops.items():
            out.ops[k] = {"count": v["count"], "flops": v["flops"] * f,
                          "bytes": v["bytes"] * f}
        return out

    def top(self, n: int = 8, key: str = "bytes") -> list:
        """The ``n`` ops with the most ``key`` ("bytes" or "flops")."""
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][key])
        return [(k, dict(v)) for k, v in rows[:n]]


class CostMode(TorchDispatchMode):
    """Counts every aten op run under it into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._scale = 1.0
        self._fused: list[tuple] = []      # (name, dtype) of open regions

    def __enter__(self):
        if _ACTIVE:
            raise RuntimeError("a CostMode is already active")
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _KINDS.get(func)
        if kind is None:
            packet = func.overloadpacket
            kind = _KINDS[func] = (str(packet), flop_registry.get(packet),
                                   not (packet in _NO_TRAFFIC or func.is_view))
        name, flop_fn, moves = kind
        flops = 0.0
        dtype = None
        if flop_fn is not None:
            flops = float(flop_fn(*args, **kwargs, out_val=out))
            first = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
            dtype = first.dtype if first is not None else None
        s = self._scale
        if self._fused:
            region, dt, counted = self._fused[0]
            if flops and not counted:
                self.cost.add(region, flops=s * flops, dtype=dt, count=0.0)
            return out
        nbytes = 0
        if moves:
            nbytes = _nbytes(_tensors(args, kwargs)) + _nbytes(_tensors(out))
        if flops or nbytes:
            self.cost.add(name, flops=s * flops, nbytes=s * nbytes,
                          dtype=dtype, count=s)
        return out

    def _trips(self, n: int):
        self._scale *= n
        try:
            yield 0
        finally:
            self._scale /= n


def trips(n: int, like: torch.Tensor):
    """The iterations of a loop of ``n`` identical trips (the train step's
    microbatches): under a ``CostMode`` with ``like`` on the meta device,
    one trip counted ``n`` times; else ``range(n)``."""
    mode = active()
    if mode is None or like.device.type != "meta" or n <= 1:
        return range(n)
    return mode._trips(n)


def visible_pairs(sq: int, sk: int, *, causal: bool,
                  window: int | None) -> int:
    """The (query, key) pairs an attention mask lets through, the queries
    at positions 0..sq-1: causal keys j <= i, and with a window also
    j > i - window."""
    if not causal:
        return sq * sk
    # numpy, not torch: a count taken under a CostMode must not count this
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1)
    lo = i - window + 1 if window is not None else np.zeros_like(i)
    return int(np.maximum(hi - np.maximum(lo, 0) + 1, 0).sum())


def attention_flops(q: torch.Tensor, v: torch.Tensor, pairs: int) -> float:
    """The products of attention over ``pairs`` (query, key) pairs of each
    batch row and query head: q k^T (2 D a pair) and p v (2 Dv a pair).
    q (B, Sq, H, D), v (B, Sk, Hkv, Dv)."""
    B, _, H, D = q.shape
    return 2.0 * B * H * (D + v.shape[-1]) * pairs


def attention_bwd_flops(q: torch.Tensor, v: torch.Tensor,
                        pairs: int) -> float:
    """The products the flash backward kernel issues over ``pairs`` (query,
    key) pairs of each batch row and query head, two passes: the dk/dv
    pass's S, dP, dV and dK, the dq pass's S, dP and dQ (2 D or 2 Dv a pair
    each)."""
    B, _, H, D = q.shape
    return 2.0 * B * H * (4 * D + 3 * v.shape[-1]) * pairs


def fused(name: str, fn, *args, flops: float | None = None, **kwargs):
    """``fn(*args, **kwargs)``; under a ``CostMode`` counted as one fused
    op named ``name``: ``flops`` where given (the kernel's own work, where
    the plain version computes more), else the FLOPs of its products, at
    the dtype of its first tensor input (a plain version that upcasts
    stands in for a kernel that multiplies in that dtype), and the bytes
    of its tensor inputs and outputs only."""
    mode = active()
    if mode is None:
        return fn(*args, **kwargs)
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    dtype = None if first is None else first.dtype
    mode._fused.append((name, dtype, flops is not None))
    try:
        out = fn(*args, **kwargs)
    finally:
        mode._fused.pop()
    if not mode._fused:
        nbytes = _nbytes(_tensors(args, kwargs)) + _nbytes(_tensors(out))
        mode.cost.add(name, flops=mode._scale * (flops or 0.0),
                      nbytes=mode._scale * nbytes, dtype=dtype,
                      count=mode._scale)
    return out


def count(fn, *args, **kwargs):
    """(fn's result, its ``Cost``)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.cost

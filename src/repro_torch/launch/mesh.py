"""Meshes: the probe mesh of the sharded store, and the named-axis meshes
the training and serving steps are placed on.

The reference shards the store with ``shard_map`` over a jax ``Mesh``: one
process drives every shard, counts are combined by ``psum`` and top-k by
``all_gather`` and a re-sort. The port keeps that single-controller shape
without jax. A ``ProbeMesh`` is an ordered tuple of ``torch.device``s, one
per shard, with the reference's axis names and sizes. Shard s holds the
s-th contiguous row block of the store, in the row order of
``NamedSharding(mesh, P(("pod", "data")))``: pod-major over the mesh's own
device layout. Several shards may sit on one device: on a single card the
blocks are views of one tensor, and each is scanned by its own launch.

A process group would not do here: NCCL refuses two ranks on one GPU, and
gloo would move every combine through host memory.

The reference's training meshes (``make_production_mesh``,
``make_local_mesh``) are ``Mesh``es: axis names and sizes and no devices,
which is all its logical-axis rules read (``models/nn.py``
``resolve_pspec``). The dry-run sizes every cell on them; on one card a
``Mesh`` names the device every shard of its placements lies on (one
process holds them all). Like the reference's, this module touches no
device state at import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "ProbeMesh", "make_local_mesh", "make_probe_mesh",
           "make_production_mesh", "mesh_axis_sizes", "data_axes"]

DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class ProbeMesh:
    """Devices laid out row-major over the axes of ``shape``, e.g.
    ``{"data": 4}`` or ``{"pod": 2, "data": 4}`` (the reference's
    ``mesh.shape``); every axis shards the store."""

    devices: tuple
    shape: dict

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "shape", dict(self.shape))
        bad = [a for a in self.shape if a not in DATA_AXES]
        if bad:
            raise ValueError(f"a probe mesh shards over {DATA_AXES} only, "
                             f"got axes {bad}")
        if any(int(n) < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axis sizes must be >= 1: {self.shape}")
        if int(np.prod(list(self.shape.values()))) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shard_devices(self) -> tuple:
        """Shard s's device: shards run pod-major (the row order of
        ``P(("pod", "data"))``) whatever order the mesh lists its axes."""
        names = self.axis_names
        order = [names.index(a) for a in data_axes(self)]
        flat = np.arange(self.size).reshape(
            [self.shape[a] for a in names]).transpose(order).reshape(-1)
        return tuple(self.devices[i] for i in flat)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, e.g. (("data", 16), ("model", 16));
    ``shape`` is the reference's ``mesh.shape`` (axis -> size). ``device``
    is where one process puts every shard (None: the default device,
    resolved when a placement first asks: CUDA, raising without it)."""

    axis_names: tuple
    axis_sizes: tuple
    device: object = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1: "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def torch_device(self) -> torch.device:
        return resolve_device(self.device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 single-pod or 2x16x16 multi-pod (512 chips), as the
    reference's."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16), device)
    return Mesh(("data", "model"), (16, 16), device)


def make_local_mesh(device=None) -> Mesh:
    """The single-device (1, 1) mesh of smoke runs and examples."""
    return Mesh(("data", "model"), (1, 1), device)


def make_probe_mesh(n_shards: int, device=None) -> ProbeMesh:
    """1-D ``("data",)`` mesh of ``n_shards`` shards — the sharded probe's
    mesh (``serve --shards``). By default the shards are dealt round-robin
    over the visible CUDA devices (all on ``cuda:0`` on a single card) and
    the call raises without CUDA; ``device`` puts every shard there (the
    tests pass ``device="cpu"``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    if device is None:
        resolve_device()
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", s % count) for s in range(n_shards)]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs = [dev] * n_shards
    return ProbeMesh(tuple(devs), {"data": int(n_shards)})


def mesh_axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.shape)

"""Launcher for the CUDA k-means assignment kernel ``csrc/kmeans_assign.cu``.

Replaces ``repro/kernels/kmeans/kernel.py`` ``assign_blocks``: fused
distance + argmin, only int32 assignments leave the kernel. As there, the
centroid norms ``c2`` are computed here in torch, outside the kernel.

Two paths, chosen here from the buffers (``vector_path``): the tensor-core
path (``assign_tensor_cores``: bf16x2 products, 16-byte copies, each row
read once for any C) for rows and centroids on 16-byte boundaries, and the
scalar-load path (``assign_scalar``, fp32 on the CUDA cores) for any other
buffer. ``tile`` gives the tensor-core block's rows and centroids.

``launches`` counts the kernel's launches in this process, and
``path_launches`` by path.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch import DTYPE
from repro_torch.kernels import _build

NAME = "kmeans_assign"
MAX_CENTROIDS = 512   # the TPU kernel's limit, kept
# (centroids, rows) a tensor-core block covers: every centroid, and as many
# rows as 32,768 accumulators (128 a thread) allow
TILES = ((32, 256), (64, 256), (128, 256), (256, 128), (512, 64))

launches = 0
_count_lock = threading.Lock()   # the counts are bumped from several threads
path_launches = {"tensor_cores": 0, "scalar": 0}

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.kmeans_assign_tc_launch.argtypes is None:
        lib.kmeans_assign_tc_launch.argtypes = [_vp] * 4 + [_i] * 4 + [_vp]
        lib.kmeans_assign_tc_launch.restype = _i
        lib.kmeans_assign_scalar_launch.argtypes = [_vp] * 4 + [_i] * 3 + [_vp]
        lib.kmeans_assign_scalar_launch.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile(c: int) -> tuple[int, int]:
    """(rows, centroids) a tensor-core block covers for C centroids: the
    narrowest centroid tile that holds all C, so each row is read once."""
    for block_c, block_rows in TILES:
        if 1 <= c <= block_c:
            return block_rows, block_c
    raise ValueError(f"1..{MAX_CENTROIDS} centroids, got {c}")


def vector_path(x: torch.Tensor, centroids: torch.Tensor) -> bool:
    """The tensor-core path's 16-byte copies take both buffers: every row
    starts on a 16-byte boundary (d a multiple of 4, aligned bases)."""
    return _build.aligned16(x, centroids)


def _checked(x: torch.Tensor, centroids: torch.Tensor) -> tuple[int, int, int]:
    for name, t in (("x", x), ("centroids", centroids)):
        if t.device.type != "cuda" or t.dtype != DTYPE:
            raise ValueError(f"{name} must be float32 on CUDA, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if centroids.device != x.device:
        raise ValueError(f"centroids on {centroids.device}, x on {x.device}")
    n, d = x.shape
    c = centroids.shape[0]
    if centroids.shape[1] != d:
        raise ValueError(f"centroids {tuple(centroids.shape)} vs x dim {d}")
    if not 1 <= c <= MAX_CENTROIDS:
        raise ValueError(f"1..{MAX_CENTROIDS} centroids, got {c}")
    if n >= 2**31:
        raise ValueError("x rows must fit int32")
    return n, d, c


def _launch(path: str | None, x: torch.Tensor, centroids: torch.Tensor,
            ) -> torch.Tensor:
    """Launch ``path`` ("tensor_cores", "scalar"; None: the buffers pick)."""
    global launches
    n, d, c = _checked(x, centroids)
    vec = vector_path(x, centroids)
    if path is None:
        path = "tensor_cores" if vec else "scalar"
    elif path == "tensor_cores" and not vec:
        raise ValueError("the tensor-core path needs rows on 16-byte "
                         f"boundaries (d {d}, bases {x.data_ptr() % 16}, "
                         f"{centroids.data_ptr() % 16})")
    c2 = torch.sum(centroids * centroids, dim=1)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), centroids.data_ptr(), c2.data_ptr(), out.data_ptr(),
            n, d, c)
    if path == "tensor_cores":
        err = lib.kmeans_assign_tc_launch(*args, tile(c)[1], stream)
    else:
        err = lib.kmeans_assign_scalar_launch(*args, stream)
    _build.check(lib, NAME, err)
    with _count_lock:
        launches += 1
        path_launches[path] += 1
    return out


def assign_tensor_cores(x: torch.Tensor, centroids: torch.Tensor,
                        ) -> torch.Tensor:
    """The tensor-core path; raises on buffers it cannot take."""
    return _launch("tensor_cores", x, centroids)


def assign_scalar(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The scalar-load path (fp32 FMAs on the CUDA cores), any buffer."""
    return _launch("scalar", x, centroids)


def assign_blocks(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x (N, d), centroids (C, d): contiguous float32 on one CUDA device.
    Returns (N,) int32 ids of the nearest centroid, lowest index on ties."""
    return _launch(None, x, centroids)

"""Launcher for the CUDA k-means assignment kernel ``csrc/kmeans_assign.cu``.

Replaces ``repro/kernels/kmeans/kernel.py`` ``assign_blocks``: fused
distance + argmin, only int32 assignments leave the kernel. As there, the
centroid norms ``c2`` are computed here in torch, outside the kernel.

``launches`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import DTYPE
from repro_torch.kernels import _build

NAME = "kmeans_assign"
MAX_CENTROIDS = 512   # the TPU kernel's limit, kept

launches = 0

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.kmeans_assign_launch.argtypes is None:
        lib.kmeans_assign_launch.argtypes = [_vp] * 4 + [_i] * 3 + [_vp]
        lib.kmeans_assign_launch.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def assign_blocks(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x (N, d), centroids (C, d): contiguous float32 on one CUDA device.
    Returns (N,) int32 ids of the nearest centroid, lowest index on ties."""
    global launches
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
    c2 = torch.sum(centroids * centroids, dim=1)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.kmeans_assign_launch(x.data_ptr(), centroids.data_ptr(),
                                   c2.data_ptr(), out.data_ptr(), n, d, c,
                                   stream)
    _build.check(lib, NAME, err)
    launches += 1
    return out

"""Launcher for the CUDA Expected-Attention scoring kernel
``csrc/expected_attention.cu``.

Replaces ``repro/kernels/expected_attention/kernel.py`` ``ea_scores``: one
bandwidth-bound pass over a layer's K/V cache at the reference's
(B, S, Hkv, D) layout, writing (B, S, Hkv) float32 scores. The top-keep
selection and the gather stay in ``ops``.

Any head dim D <= 256 that is a multiple of 4 and any number of query
heads per KV head (in groups of at most 8, a pass over the cache each).
Two paths, chosen here from the caches (``vector_path``): the vector path
(``ea_scores_vector``: 16-byte loads, a head a block) for bfloat16 caches
whose bases and strides lie on 16-byte boundaries and whose D is a
multiple of 8, and the scalar-load path (``ea_scores_scalar``) for any
other (float32 and float8 e4m3 serve caches among them).

``launches`` counts the kernel's launches in this process, and
``path_launches`` by path.
"""

from __future__ import annotations

import ctypes
import threading
import math

import torch

from repro_torch.kernels import _build

NAME = "expected_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

launches = 0
_count_lock = threading.Lock()   # the counts are bumped from several threads
path_launches = {"vector": 0, "scalar": 0}

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.ea_scores_scalar_launch.argtypes is None:
        lib.ea_scores_scalar_launch.argtypes = (
            [_vp] * 5 + [_i] * 6 + [_ll] * 6 + [ctypes.c_float, _vp])
        lib.ea_scores_scalar_launch.restype = _i
        lib.ea_scores_vector_launch.argtypes = (
            [_vp] * 5 + [_i] * 5 + [_ll] * 6 + [ctypes.c_float, _vp])
        lib.ea_scores_vector_launch.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def vector_path(k: torch.Tensor, v: torch.Tensor) -> bool:
    """The vector path's 16-byte loads take both caches: bfloat16, with
    bases and every stride on 16-byte boundaries (8 elements), and whole
    16-byte vectors a row (D a multiple of 8)."""
    return (k.dtype == v.dtype == torch.bfloat16 and k.shape[-1] % 8 == 0
            and _build.aligned16(k, v))


def _launch(path: str | None, k: torch.Tensor, v: torch.Tensor,
            q_mu: torch.Tensor, q_var: torch.Tensor) -> torch.Tensor:
    """Launch ``path`` ("vector", "scalar"; None: the caches pick)."""
    global launches
    _build.require_cuda(NAME, DTYPES, k=k, v=v)
    _build.require_cuda(NAME, {torch.float32: 0}, q_mu=q_mu, q_var=q_var)
    B, S, hkv, D = k.shape
    rep = q_mu.shape[1]
    if (v.shape != k.shape or v.dtype != k.dtype
            or q_mu.shape != (hkv, rep, D) or q_var.shape != q_mu.shape
            or not (q_mu.is_contiguous() and q_var.is_contiguous())):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)}, mu "
                         f"{tuple(q_mu.shape)}, var {tuple(q_var.shape)} do "
                         f"not fit")
    if not _build.head_dim_ok(D) or rep < 1:
        raise ValueError(f"head_dim {D} (takes a multiple of 4 up to "
                         f"{_build.MAX_HEAD_DIM}) or rep {rep} not supported")
    vec = vector_path(k, v)
    if path is None:
        path = "vector" if vec else "scalar"
    elif path == "vector" and not vec:
        raise ValueError("the vector path needs bfloat16 caches on 16-byte "
                         f"boundaries with D a multiple of 8, got {k.dtype}, "
                         f"D {D}, strides {k.stride()}, {v.stride()}")
    out = torch.empty((B, S, hkv), dtype=torch.float32, device=k.device)
    lib = _lib()
    stream = torch.cuda.current_stream(k.device).cuda_stream
    ptrs = (k.data_ptr(), v.data_ptr(), q_mu.data_ptr(), q_var.data_ptr(),
            out.data_ptr(), B, S, hkv, rep, D)
    strides = (*k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D), stream)
    if path == "vector":
        err = lib.ea_scores_vector_launch(*ptrs, *strides)
    else:
        err = lib.ea_scores_scalar_launch(*ptrs, DTYPES[k.dtype], *strides)
    _build.check(lib, NAME, err)
    with _count_lock:
        launches += 1
        path_launches[path] += 1
    return out


def ea_scores_vector(k, v, q_mu, q_var) -> torch.Tensor:
    """The vector path; raises on caches it cannot take."""
    return _launch("vector", k, v, q_mu, q_var)


def ea_scores_scalar(k, v, q_mu, q_var) -> torch.Tensor:
    """The scalar-load path, any cache."""
    return _launch("scalar", k, v, q_mu, q_var)


def ea_scores(k: torch.Tensor, v: torch.Tensor, q_mu: torch.Tensor,
              q_var: torch.Tensor) -> torch.Tensor:
    """k/v (B, S, Hkv, D) of one dtype, last dim contiguous; q_mu/q_var
    (Hkv, rep, D) contiguous float32; all on one CUDA device. Returns
    (B, S, Hkv) float32 scores."""
    return _launch(None, k, v, q_mu, q_var)

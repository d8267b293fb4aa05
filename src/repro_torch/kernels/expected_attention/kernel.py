"""Launcher for the CUDA Expected-Attention scoring kernel
``csrc/expected_attention.cu``.

Replaces ``repro/kernels/expected_attention/kernel.py`` ``ea_scores``: one
bandwidth-bound pass over a layer's K/V cache at the reference's
(B, S, Hkv, D) layout, writing (B, S, Hkv) float32 scores. The top-keep
selection and the gather stay in ``ops``.

``launches`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "expected_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 8

launches = 0

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.ea_scores_launch.argtypes is None:
        lib.ea_scores_launch.argtypes = (
            [_vp] * 5 + [_i] * 6 + [_ll] * 6 + [ctypes.c_float, _vp])
        lib.ea_scores_launch.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ea_scores(k: torch.Tensor, v: torch.Tensor, q_mu: torch.Tensor,
              q_var: torch.Tensor) -> torch.Tensor:
    """k/v (B, S, Hkv, D) of one dtype, last dim contiguous; q_mu/q_var
    (Hkv, rep, D) contiguous float32; all on one CUDA device. Returns
    (B, S, Hkv) float32 scores."""
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
    if D not in HEAD_DIMS or not 1 <= rep <= MAX_REP:
        raise ValueError(f"head_dim {D} (takes {HEAD_DIMS}) or rep {rep} "
                         f"(1..{MAX_REP}) not supported")
    out = torch.empty((B, S, hkv), dtype=torch.float32, device=k.device)
    lib = _lib()
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = lib.ea_scores_launch(
        k.data_ptr(), v.data_ptr(), q_mu.data_ptr(), q_var.data_ptr(),
        out.data_ptr(), B, S, hkv, rep, D, DTYPES[k.dtype], *k.stride()[:3],
        *v.stride()[:3], 1.0 / math.sqrt(D), stream)
    _build.check(lib, NAME, err)
    launches += 1
    return out

"""Launcher for the CUDA flash-decode kernel ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention/kernel.py`` ``decode_fwd``: one
new token's GQA query heads against a cache at the reference's
(B, L, Hkv, D) layout, with a per-sequence valid length. The cache may be
float32, bfloat16 or float8 e4m3 and is upcast inside the kernel.

``launches`` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "decode_attention"
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 8          # query heads per KV head (kMaxRep in the source)

launches = 0

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.decode_attention_launch.argtypes is None:
        lib.decode_attention_launch.argtypes = (
            [_vp] * 5 + [_i] * 7 + [_ll] * 10 + [ctypes.c_float, _vp])
        lib.decode_attention_launch.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_valid: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q (B, 1, H, D) float32/bfloat16; k/v (B, L, Hkv, D) of one cache
    dtype; kv_valid (B,) int32; all on one CUDA device, last dims
    contiguous. Returns (B, 1, H, D) in q's dtype."""
    global launches
    _build.require_cuda(NAME, Q_DTYPES, q=q)
    _build.require_cuda(NAME, KV_DTYPES, k=k, v=v)
    _build.require_cuda(NAME, {torch.int32: 0}, kv_valid=kv_valid)
    B, sq, H, D = q.shape
    L, hkv = k.shape[1], k.shape[2]
    if (sq != 1 or k.shape != (B, L, hkv, D) or v.shape != k.shape
            or v.dtype != k.dtype or kv_valid.shape != (B,)
            or not kv_valid.is_contiguous()):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype}, kv_valid "
                         f"{tuple(kv_valid.shape)} do not fit decode")
    if D not in HEAD_DIMS or H % hkv or H // hkv > MAX_REP:
        raise ValueError(f"head_dim {D} (takes {HEAD_DIMS}) or heads "
                         f"{H}/{hkv} (at most {MAX_REP} per KV head) not "
                         f"supported")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), B, L, H, hkv, D, Q_DTYPES[q.dtype],
        KV_DTYPES[k.dtype], q.stride(0), q.stride(2), *k.stride()[:3],
        *v.stride()[:3], out.stride(0), out.stride(2), scale, stream)
    _build.check(lib, NAME, err)
    launches += 1
    return out

"""Launcher for the CUDA flash-decode kernel ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention/kernel.py`` ``decode_fwd``: one
new token's GQA query heads against a cache at the reference's
(B, L, Hkv, D) layout, with a per-sequence valid length, for any head dim
D <= 256 that is a multiple of 4 and any number of query heads per KV
head (taken in groups of at most 8). The cache may be float32, bfloat16 or
float8 e4m3 and is upcast inside the kernel; its rows load as 16-byte
copies where they start on 16-byte boundaries and as 4-byte copies where
they start on 4-byte ones (nothing is copied to an aligned buffer). A call
is two launches: the cache slots of all (sequence, KV head, head group)
triples dealt to the blocks in equal runs, then a merge of each head's
float32 partial states, which live in one scratch tensor.

``launches`` counts calls (each one split launch and one merge launch).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

NAME = "decode_attention"
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

launches = 0
_count_lock = threading.Lock()   # the counts are bumped from several threads

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.decode_attention_launch.argtypes is None:
        lib.decode_attention_launch.argtypes = (
            [_vp] * 4 + [_i] + [_vp] * 3 + [_i, ctypes.c_float, _vp])
        lib.decode_attention_scratch_floats.argtypes = [_i] * 7
        lib.decode_attention_scratch_floats.restype = _ll
        lib.decode_attention_launch.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


# launch arguments by the tensors' metadata: the checks below run once a
# layout (a decode pass calls with the same shapes every layer and step)
_plans: dict = {}


def _plan(q, k, v, kv_valid, per_seq: bool) -> tuple:
    """Check what the kernel takes; return (layout, scratch floats, rows on
    16-byte strides), the layout the launch's integers as one C array."""
    _build.require_cuda(NAME, Q_DTYPES, q=q)
    _build.require_cuda(NAME, KV_DTYPES, k=k, v=v)
    B, sq, H, D = q.shape
    L, hkv = k.shape[1], k.shape[2]
    if per_seq:
        _build.require_cuda(NAME, {torch.int32: 0}, kv_valid=kv_valid)
    if (sq != 1 or k.shape != (B, L, hkv, D) or v.shape != k.shape
            or v.dtype != k.dtype or k.device != q.device or (per_seq and (
                kv_valid.shape != (B,) or not kv_valid.is_contiguous()
                or kv_valid.device != q.device))):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype}, kv_valid "
                         f"{kv_valid if not per_seq else kv_valid.shape} do "
                         f"not fit decode")
    if not _build.head_dim_ok(D) or H % hkv:
        raise ValueError(f"head_dim {D} (takes a multiple of 4 up to "
                         f"{_build.MAX_HEAD_DIM}) or heads {H}/{hkv} not "
                         f"supported")
    if not all(s * t.element_size() % 4 == 0
               for t in (k, v) for s in t.stride()[:-1]):
        raise ValueError(f"{NAME}: k and v rows must start on 4-byte "
                         f"boundaries (the kernel copies 4-byte words)")
    lib = _lib()
    floats = lib.decode_attention_scratch_floats(
        B, L, H, hkv, D, Q_DTYPES[q.dtype], KV_DTYPES[k.dtype])
    if floats < 0:
        raise ValueError(f"{NAME}: no launch plan for B {B}, L {L}, heads "
                         f"{H}/{hkv}, head_dim {D}")
    layout = (B, L, H, hkv, D, Q_DTYPES[q.dtype], KV_DTYPES[k.dtype],
              q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
              H * D, D)
    strided16 = all(s * t.element_size() % 16 == 0
                    for t in (k, v) for s in t.stride()[:-1])
    return (ctypes.c_longlong * len(layout))(*layout), floats, strided16


def decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_valid: torch.Tensor | int, *, scale: float) -> torch.Tensor:
    """q (B, 1, H, D) float32/bfloat16; k/v (B, L, Hkv, D) of one cache
    dtype, row starts 4-byte aligned; kv_valid (B,) int32 on the device,
    or one int for every sequence; all on one CUDA device, last dims
    contiguous. Returns (B, 1, H, D) in q's dtype."""
    global launches
    per_seq = torch.is_tensor(kv_valid)
    key = (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(),
           k.dtype, k.device, v.shape, v.stride(), v.dtype, v.device,
           (kv_valid.shape, kv_valid.stride(), kv_valid.dtype,
            kv_valid.device) if per_seq else None)
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) > 256:
            _plans.clear()
        plan = _plans[key] = _plan(q, k, v, kv_valid, per_seq)
    layout, floats, strided16 = plan
    if (k.data_ptr() | v.data_ptr()) % 4:
        raise ValueError(f"{NAME}: k and v must start on 4-byte boundaries")
    vec = strided16 and (k.data_ptr() | v.data_ptr()) % 16 == 0
    out = torch.empty((q.shape[0], 1, q.shape[2], q.shape[3]),
                      dtype=q.dtype, device=q.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_valid.data_ptr() if per_seq else None,
        0 if per_seq else int(kv_valid), out.data_ptr(), scratch.data_ptr(),
        layout, int(vec), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, NAME, err)
    with _count_lock:
        launches += 1
    return out

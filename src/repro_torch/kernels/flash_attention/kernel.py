"""Launcher for the CUDA flash-attention kernel ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py`` ``flash_fwd``: causal,
windowed or full GQA attention with an online softmax, at the reference's
(B, S, H, D) layout read through the tensors' strides (nothing is padded or
moved in device memory), for any head dim D <= 256 that is a multiple of 4
and any H / Hkv. Two kernels, chosen from the inputs (``wgmma_path``):
bfloat16 whose bases and strides are 16-byte aligned, with 16 <= D <= 128,
runs both products on the tensor cores (wgmma, its tiles brought in by
TMA); any other input (float32, or a bfloat16 row TMA cannot take, such as
D = 20 at a 40-byte stride) runs on the CUDA cores, its rows loaded element
by element where they are not 16-byte aligned. float32 accumulation either
way, output in the input type. Asked for (``return_lse``), either kernel
also writes each query row's log-sum-exp, float32 (B, H, Sq), which the
training forward (``models/flash_ref.FlashAttention``) saves for its
backward.

The kernel has no backward, so ``flash_fwd`` refuses inputs that require
grad while grad mode is on: an output with no ``grad_fn`` would give q, k
and v no gradient, silently. ``FlashAttention.forward`` runs with grad
mode off (autograd's rule for a Function's forward), so the training
route reaches the kernel through it alone.

``launches`` counts the kernel's launches in this process, and
``path_launches`` by kernel; a run sets them to 0 and reads them back to
show that a path really went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()   # the counts are bumped from several threads
path_launches = {"wgmma": 0, "core": 0}

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [_vp] * 5 + [_i] * 7 + [_ll] * 12 + [ctypes.c_float] + [_i] * 4
            + [_vp])
        lib.flash_attention_launch.restype = _i
        lib.flash_attention_path.argtypes = [_i] * 3
        lib.flash_attention_path.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def wgmma_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The tensor-core kernel takes these inputs (the library's rule:
    bfloat16, 16 <= D <= 128, every base and stride on a 16-byte boundary
    for TMA)."""
    return bool(_lib().flash_attention_path(
        q.shape[-1], DTYPES[q.dtype], int(_build.aligned16(q, k, v))))


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int | None, scale: float,
              return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D): one dtype on one CUDA device,
    last dim contiguous, D a multiple of 4 up to 256. Returns (B, Sq, H, D)
    in q's dtype, and with ``return_lse`` also the rows' log-sum-exp
    (B, H, Sq) in float32."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_fwd has no backward: an input requires grad, so its "
            "output would give it none; differentiate through "
            "repro_torch.models.flash_ref.FlashAttention")
    _build.require_cuda(NAME, DTYPES, q=q, k=k, v=v)
    B, sq, H, D = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != (B, sk, hkv, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, S, H, D)")
    if not _build.head_dim_ok(D) or H % hkv:
        raise ValueError(f"head_dim {D} (takes a multiple of 4 up to "
                         f"{_build.MAX_HEAD_DIM}) or heads {H}/{hkv} not "
                         f"supported")
    vec = _build.aligned16(q, k, v)
    out = torch.empty((B, sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, sq, sk,
        H, hkv, D, DTYPES[q.dtype], *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], scale, int(causal),
        int(window or 0), int(vec), q.device.index, stream)
    _build.check(lib, NAME, err)
    path = "wgmma" if lib.flash_attention_path(D, DTYPES[q.dtype],
                                               int(vec)) else "core"
    with _count_lock:
        launches += 1
        path_launches[path] += 1
    return (out, lse) if return_lse else out

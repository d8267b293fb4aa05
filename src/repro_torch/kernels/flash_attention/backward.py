"""Launcher for the flash-attention backward ``csrc/flash_attention_bwd.cu``.

Replaces no Pallas kernel: the reference's backward is XLA
(``repro/models/flash_ref.py:110`` ``flash_bwd``). ``flash_bwd`` computes
what ``models/flash_ref.flash_backward`` (the plain version, the CPU path
and the oracle) computes: dq, dk and dv from q, k, v, the forward's output
and row log-sum-exp and the output's cotangent, for causal, windowed or
full GQA attention with the queries from position 0 (Sq != Sk allowed),
any head dim D <= 256 that is a multiple of 4 and any H / Hkv, read through
the tensors' strides. bfloat16 whose bases and strides are 16-byte aligned,
with 16 <= D <= 128, runs every product on the tensor cores (wgmma, its
tiles brought in by TMA); float32, wider or narrower heads and bfloat16
rows TMA cannot take (such as D = 20 at a 40-byte stride) run on the CUDA
cores (``wgmma_path``). float32 accumulation either way, each gradient in
its input's dtype. No atomics: two calls on the same inputs give bitwise
the same gradients.

``launches`` counts calls (each one stats, one dk/dv and one dq launch),
``path_launches`` by kernel; a run sets them to 0 and reads them back to
show that a path really went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

NAME = "flash_attention_bwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()   # the counts are bumped from several threads
path_launches = {"wgmma": 0, "core": 0}

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    return bind(_build.load(NAME))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/flash_attention_bwd.cu`` (once) and return it."""
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = (
            [_vp] * 10 + [_i] * 7 + [_ll] * 24 + [ctypes.c_float] + [_i] * 4
            + [_vp])
        lib.flash_attention_bwd_launch.restype = _i
        lib.flash_attention_bwd_path.argtypes = [_i] * 3
        lib.flash_attention_bwd_path.restype = _i
        lib.flash_attention_bwd_stats_rows.argtypes = [_i]
        lib.flash_attention_bwd_stats_rows.restype = _i
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def wgmma_path(*tensors: torch.Tensor) -> bool:
    """The wgmma kernels take these inputs (q, k, v, out, dout; the
    library's rule: bfloat16, 16 <= D <= 128, every base and stride on a
    16-byte boundary for TMA)."""
    q = tensors[0]
    return bool(_lib().flash_attention_bwd_path(
        q.shape[-1], DTYPES[q.dtype], int(_build.aligned16(*tensors))))


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
              causal: bool, window: int | None, scale: float):
    """q, out, dout (B, Sq, H, D), k/v (B, Sk, Hkv, D): one dtype on one
    CUDA device, last dim contiguous; lse (B, H, Sq) float32 contiguous.
    Returns (dq, dk, dv), each in its input's shape and dtype."""
    global launches
    _build.require_cuda(NAME, DTYPES, q=q, k=k, v=v, out=out, dout=dout)
    B, sq, H, D = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, sk, hkv, D) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} do not fit (B, S, H, D)")
    if len({t.dtype for t in (q, k, v, out, dout)}) != 1:
        raise ValueError(f"{NAME}: q, k, v, out and dout must share a dtype")
    if not _build.head_dim_ok(D) or H % hkv:
        raise ValueError(f"head_dim {D} (takes a multiple of 4 up to "
                         f"{_build.MAX_HEAD_DIM}) or heads {H}/{hkv} not "
                         f"supported")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or lse.shape != (B, H, sq) or not lse.is_contiguous()):
        raise ValueError(f"{NAME}: lse must be a contiguous float32 "
                         f"{(B, H, sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    vec = _build.aligned16(q, k, v, out, dout)
    dev = q.device
    dq = torch.empty((B, sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, sk, hkv, D), dtype=k.dtype, device=dev)
    dv = torch.empty((B, sk, hkv, D), dtype=v.dtype, device=dev)
    lib = _lib()
    # each row's {lse log2 e, rowsum(dout out)}, written by the first
    # launch; a (b, h)'s rows padded (with zeros) to the kernels' multiple
    stats = torch.empty((B, H, lib.flash_attention_bwd_stats_rows(sq), 2),
                        dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, sq, sk, H, hkv, D, DTYPES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3], scale, int(causal),
        int(window or 0), int(vec), dev.index, stream)
    _build.check(lib, NAME, err)
    path = "wgmma" if lib.flash_attention_bwd_path(D, DTYPES[q.dtype],
                                                   int(vec)) else "core"
    with _count_lock:
        launches += 1
        path_launches[path] += 1
    return dq, dk, dv

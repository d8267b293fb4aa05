"""Launcher for the CUDA probe kernel ``csrc/cosine_topk.cu``.

The kernel replaces the full-scan Pallas entry points of
``repro/kernels/cosine_topk/kernel.py`` (``cosine_probe_blocks``,
``cosine_probe_batch_blocks``, ``cosine_probe_batch_tiled_blocks``): one
kernel with predicate tiles as a grid axis, and the scalar probe as B = 1.
It returns per-slab partials — counts (nslab, B, T) and the slab's kk
smallest distances (nslab, B, kk) — that ``ops`` merges.

``launches`` counts the kernel's launches in this process; a run sets it to
0 and reads it back to show that a path really went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import DTYPE
from repro_torch.kernels import _build

NAME = "cosine_topk"
SLAB = 1024          # store rows per block (kSlab in the source)
MAX_T = 32           # thresholds per predicate (kMaxT)
MAX_SMEM = 232_448   # bytes of shared memory a block may use on Hopper

launches = 0

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.cosine_topk_launch.argtypes is None:
        lib.cosine_topk_launch.argtypes = [_vp] * 5 + [_i] * 8 + [_vp]
        lib.cosine_topk_launch.restype = _i
        lib.cosine_topk_smem_bytes.argtypes = [_i, _i, _i]
        lib.cosine_topk_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile_width(b: int) -> int:
    """Predicates staged per block: the power of two >= B, at most 8."""
    bt = 1
    while bt < min(b, 8):
        bt *= 2
    return bt


def probe_blocks(store: torch.Tensor, preds: torch.Tensor,
                 thresholds: torch.Tensor, *, kk: int, n_valid: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the probe: store (N, d), preds (B, d), thresholds (B, T), all
    contiguous float32 on one CUDA device. Rows >= ``n_valid`` are dead."""
    global launches
    for name, t in (("store", store), ("preds", preds),
                    ("thresholds", thresholds)):
        if t.device.type != "cuda" or t.dtype != DTYPE:
            raise ValueError(f"{name} must be float32 on CUDA, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.device != store.device:
            raise ValueError(f"{name} is on {t.device}, store on "
                             f"{store.device}")
    n, d = store.shape
    b, t = thresholds.shape
    if preds.shape != (b, d):
        raise ValueError(f"preds {tuple(preds.shape)} vs store dim {d} and "
                         f"{b} threshold rows")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"the kernel takes 1..{MAX_T} thresholds per "
                         f"predicate, got {t}")
    if not 1 <= kk <= SLAB:
        raise ValueError(f"kk must lie in 1..{SLAB}, got {kk}")
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside 0..{n}")
    if n >= 2**31 or b * t >= 2**31:
        raise ValueError("store rows and B*T must fit int32")
    lib = _lib()
    bt = tile_width(b)
    if lib.cosine_topk_smem_bytes(bt, d, kk) > MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    vec = int(d % 4 == 0 and store.data_ptr() % 16 == 0)
    nslab = (n + SLAB - 1) // SLAB
    counts = torch.empty((nslab, b, t), dtype=torch.int32, device=store.device)
    topk = torch.empty((nslab, b, kk), dtype=torch.float32, device=store.device)
    stream = torch.cuda.current_stream(store.device).cuda_stream
    err = lib.cosine_topk_launch(
        store.data_ptr(), preds.data_ptr(), thresholds.data_ptr(),
        counts.data_ptr(), topk.data_ptr(), n, n_valid, d, b, t, kk, bt, vec,
        stream)
    _build.check(lib, NAME, err)
    launches += 1
    return counts, topk

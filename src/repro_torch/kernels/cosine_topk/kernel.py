"""Launcher for the CUDA probe kernel ``csrc/cosine_topk.cu``.

The kernel replaces every Pallas entry point of
``repro/kernels/cosine_topk/kernel.py``: the full-scan, masked and rowmask
probes, each scalar, batched and B-tiled. It is one kernel with predicate
tiles as a grid axis (the scalar probe is B = 1), a run-time ``n_valid`` (the
masked probes) and a nullable per-row int32 mask (the rowmask probes). In
probe mode it returns per-slab partials — counts (nslab, B, T) and the
slab's kk smallest distances (nslab, B, kk) — that ``ops`` merges; in
compound mode (``mode`` 1 = and, 2 = or) one match count per slab.

``launches`` counts the kernel's launches in this process, and
``entry_launches`` the same launches by the entry point that made them; a
run sets both to 0 and reads them back to show that a path really went
through the kernel.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch import DTYPE
from repro_torch.kernels import _build

NAME = "cosine_topk"
SLAB = 1024          # store rows per block (kSlab in the source)
MAX_T = 32           # thresholds per predicate (kMaxT)
MAX_TILE = 8         # predicates staged per block
MAX_SMEM = 232_448   # bytes of shared memory a block may use on Hopper
MODES = {"and": 1, "or": 2}

launches = 0
entry_launches: collections.Counter = collections.Counter()

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.cosine_topk_launch.argtypes is None:
        lib.cosine_topk_launch.argtypes = [_vp] * 6 + [_i] * 9 + [_vp]
        lib.cosine_topk_launch.restype = _i
        lib.cosine_topk_smem_bytes.argtypes = [_i, _i, _i]
        lib.cosine_topk_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile_width(b: int) -> int:
    """Predicates staged per block: the power of two >= B, at most 8."""
    bt = 1
    while bt < min(b, MAX_TILE):
        bt *= 2
    return bt


def entry_name(base: str, b: int) -> str:
    """The reference entry point a launch of B predicates stands for: the
    batched probe takes its B-tiled variant once B spans several tiles."""
    return f"{base}_tiled" if b > MAX_TILE else base


def probe_blocks(store: torch.Tensor, preds: torch.Tensor,
                 thresholds: torch.Tensor, *, kk: int, n_valid: int,
                 mask: torch.Tensor | None = None, mode: str | None = None,
                 entry: str = "cosine_probe_batch",
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the probe: store (N, d), preds (B, d), thresholds (B, T), all
    contiguous float32 on one CUDA device. Rows >= ``n_valid`` are dead, and
    so is every row whose ``mask`` (N,) int32 entry is 0.

    ``mode`` None returns the per-slab (counts, top-k) partials; "and" or
    "or" scores the B <= 8 conjuncts of one compound predicate (T = 1) and
    returns (per-slab match counts (nslab,), None). ``entry`` names the
    launch in ``entry_launches``."""
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
    if mask is not None and (mask.device != store.device
                             or mask.dtype != torch.int32
                             or mask.shape != (n,)
                             or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous ({n},) int32 tensor on "
                         f"{store.device}, got {tuple(mask.shape)} "
                         f"{mask.dtype} on {mask.device}")
    code = 0
    if mode is not None:
        if mode not in MODES:
            raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
        if t != 1 or kk != 1 or b > MAX_TILE:
            raise ValueError(f"a compound launch takes 1..{MAX_TILE} "
                             f"conjuncts with one threshold each, got "
                             f"({b}, {t})")
        code = MODES[mode]
    lib = _lib()
    bt = tile_width(b)
    if lib.cosine_topk_smem_bytes(bt, d, kk) > MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    vec = int(d % 4 == 0 and store.data_ptr() % 16 == 0)
    nslab = (n + SLAB - 1) // SLAB
    if code:
        counts = torch.empty((nslab,), dtype=torch.int32, device=store.device)
        topk = None
    else:
        counts = torch.empty((nslab, b, t), dtype=torch.int32,
                             device=store.device)
        topk = torch.empty((nslab, b, kk), dtype=torch.float32,
                           device=store.device)
    stream = torch.cuda.current_stream(store.device).cuda_stream
    err = lib.cosine_topk_launch(
        store.data_ptr(), preds.data_ptr(), thresholds.data_ptr(),
        None if mask is None else mask.data_ptr(), counts.data_ptr(),
        None if topk is None else topk.data_ptr(), n, n_valid, d, b, t, kk,
        bt, vec, code, stream)
    _build.check(lib, NAME, err)
    launches += 1
    entry_launches[entry] += 1
    return counts, topk

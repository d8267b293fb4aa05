"""Launcher for the CUDA probe kernel ``csrc/cosine_topk.cu``.

The kernel replaces every Pallas entry point of
``repro/kernels/cosine_topk/kernel.py``: the full-scan, masked and rowmask
probes, each scalar, batched and B-tiled (``cosine_probe_blocks`` :93 to
``cosine_probe_batch_masked_tiled_blocks`` :551). A call is two launches
from one C call, a scan that leaves per-block partials with a run-time
``n_valid`` (the masked probes) and a nullable per-row int32 mask (the
rowmask probes), then a merge that sums the counts and selects the exact
top-k on the card. ``launch_shape`` gives the scan's plan:

- B <= 8, compound mode, and a buffer the 16-byte loads cannot take: the
  8-wide scan, a grid of (row blocks, predicate tiles of up to 8). Rows
  per block are the largest power of two in 32..1024 that still makes
  four blocks a SM, so a small buffer spreads over the whole card and the
  2^20 store keeps 1024-row blocks. Compound mode (``mode`` "and" / "or")
  counts the rows that match every / any of any number of conjuncts; each
  block walks all of the conjunction's tiles over its rows.
- Otherwise B > 8: the wide scan, which reads each live store row once for
  any B. At most one persistent CTA a SM walks staged blocks of 32 rows
  and every 24-predicate pass over them, with a warp tile of 8 rows x 12
  predicates; each 8-row quarter of a CTA leaves one partial (its k
  smallest distances for k <= 32), or for a larger k each quarter of each
  staged block.

A row's distance has the same bits in both (the kernel's fixed reduction
order), so a predicate alone is bitwise its row of any batch.

The argument checks run once per tensor layout (shapes, strides, dtypes,
devices, k, ``n_valid`` and mode), which also fixes the launch's integers
as one C array; a call then allocates its outputs and makes the C call.
The partials live in one scratch buffer per stream, reused by every launch
on it: a lock keeps each call's scan and merge adjacent on the stream, so
stream order keeps them apart.

``launches`` counts the kernel's calls in this process,
``entry_launches`` the same calls by the entry point that made them, and
``path_launches`` by scan ("narrow": the 8-wide scan, "wide"); a run sets
them to 0 and reads them back to show that a path really went through the
kernel. They are counted under the launch lock, so calls from several
threads (a serve loop's flusher, planners, an index rebuild) lose none.

``arm_launch_timing`` arms the calling thread's next launch with a pair of
timing ``torch.cuda.Event``s (one pair a thread and device, reused),
recorded on the launch's stream just before and just after the C call: the
pair then holds the scan and the merge alone, not the host work that
stages a call's inputs. ``timed_launch`` hands the pair back only where
exactly one launch recorded it since the arming and succeeded (the
coalescer times its probes so).
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

from repro_torch import DTYPE
from repro_torch.kernels import _build

NAME = "cosine_topk"
MIN_ROWS, MAX_ROWS = 32, 1024   # store rows a block (kMinRows, kMaxRows)
MAX_T = 32           # thresholds per predicate (kMaxT)
MAX_TILE = 8         # predicates staged per block, B <= 8
BLOCK_B = 128        # the reference's block_b: it tiles B past this
WIDE_ROWS = 32       # wide launch: store rows a staged block (kWRows)
WIDE_LIST_K = 32     # wide launch: k up to this keeps one list a CTA
MAX_SMEM = 232_448   # bytes of shared memory a block may use on Hopper
MODES = {"and": 1, "or": 2}

launches = 0
entry_launches: collections.Counter = collections.Counter()
path_launches = {"narrow": 0, "wide": 0}

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.cosine_topk_launch.argtypes is None:
        lib.cosine_topk_launch.argtypes = (
            [_vp] * 7 + [ctypes.POINTER(_i), _i, _i, _i, _vp])
        lib.cosine_topk_launch.restype = _i
        lib.cosine_topk_smem_bytes.argtypes = [_i] * 5
        lib.cosine_topk_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [_i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile_width(b: int) -> int:
    """Predicates staged per block of the 8-wide launch: the power of two
    >= B, at most 8."""
    bt = 1
    while bt < min(b, MAX_TILE):
        bt *= 2
    return bt


def entry_name(base: str, b: int) -> str:
    """The reference entry point a launch of B predicates stands for: its
    batched probe takes the B-tiled variant past block_b predicates
    (``repro/kernels/cosine_topk/ops.py``, ``tiled=None``)."""
    return f"{base}_tiled" if b > BLOCK_B else base


def wide_grid(n_scan: int, sms: int) -> int:
    """Persistent CTAs of a wide launch: one a SM, at most one a staged
    block."""
    return min(max(1, -(-n_scan // WIDE_ROWS)), sms)


def launch_shape(n_scan: int, b: int, t: int, k: int, sms: int,
                 compound: bool = False, wide: bool | None = None,
                 ) -> tuple[int, int, int, int]:
    """(rows a block, partial blocks, per-block top-k kb, int32 partials)
    of a launch scanning ``n_scan`` rows.

    B <= 8 (and compound, and ``wide=False``): the 8-wide scan, the largest
    power-of-two block in MIN_ROWS..MAX_ROWS whose grid (blocks x predicate
    tiles; a compound block walks every tile itself) still holds four
    blocks a SM. B > 8: the wide scan, staged blocks of WIDE_ROWS rows under
    ``wide_grid`` persistent CTAs, whatever B; each CTA leaves one partial
    an 8-row quarter with its k smallest distances for k <= WIDE_LIST_K,
    else each staged block's quarter leaves its 8."""
    if wide is None:
        wide = b > MAX_TILE and not compound
    if wide:
        n_rb = -(-n_scan // WIDE_ROWS)
        per_cta = k <= WIDE_LIST_K or n_rb == 0
        kb = k if k <= WIDE_LIST_K else 8
        nblk = WIDE_ROWS // 8 * (wide_grid(n_scan, sms) if per_cta else n_rb)
        return WIDE_ROWS, nblk, kb, nblk * b * (t + kb)
    tiles = 1 if compound else -(-b // tile_width(b))
    rows = MAX_ROWS
    while rows > MIN_ROWS and -(-n_scan // rows) * tiles < 4 * sms:
        rows //= 2
    nblk = max(1, -(-n_scan // rows))
    if compound:
        return rows, nblk, 0, nblk
    kb = min(k, rows)
    return rows, nblk, kb, nblk * b * (t + kb)


def wide_fits(d: int) -> bool:
    """Whether the wide launch's rows and ring fit a block at width d."""
    return d % 4 == 0 and _lib().cosine_topk_smem_bytes(0, d, 0, 0, 0) \
        <= MAX_SMEM


def store_passes(b: int, d: int) -> int:
    """Times a launch of B predicates reads each live row of a 16-byte
    aligned store of width d: once, unless B > 8 and the wide launch does
    not fit (once per tile of 8 then)."""
    return 1 if b <= MAX_TILE or wide_fits(d) else -(-b // MAX_TILE)


# launch arguments by the tensors' metadata: the checks below run once a
# layout (a serve loop probes the same store with the same shapes)
_plans: dict = {}
_scratch: dict = {}     # raw stream -> int32 partials buffer
_lock = threading.Lock()
# a thread's launch timing: armed, launches since the arming, the pair its
# one launch recorded, and its (start, end) event pairs by device index
_timing = threading.local()


def arm_launch_timing(on: bool = True) -> None:
    """Arm (or disarm) the calling thread's launches for timing; arming
    forgets what an earlier arming recorded."""
    _timing.armed = on
    if on:
        _timing.n, _timing.recorded = 0, None


def timed_launch():
    """The (start, end) CUDA events recorded around the calling thread's
    launch since ``arm_launch_timing``, or None unless exactly one launch
    was made there and it succeeded."""
    if getattr(_timing, "n", 0) != 1:
        return None
    return _timing.recorded


def _event_pair(index: int):
    pairs = getattr(_timing, "pairs", None)
    if pairs is None:
        pairs = _timing.pairs = {}
    pair = pairs.get(index)
    if pair is None:
        pair = pairs[index] = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
    return pair


def _plan(store, preds, thresholds, mask, k, n_valid, mode, one) -> tuple:
    """Check what the kernel takes; return the launch's fixed arguments."""
    for name, t, dim in (("store", store, 2), ("preds", preds, 2 - one),
                         ("thresholds", thresholds, 2 - one)):
        if t.device.type != "cuda" or t.dtype != DTYPE:
            raise ValueError(f"{name} must be float32 on CUDA, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
        if t.device != store.device:
            raise ValueError(f"{name} is on {t.device}, store on "
                             f"{store.device}")
    if one:
        preds, thresholds = preds[None], thresholds[None]
    n, d = store.shape
    b, t = thresholds.shape
    if preds.shape != (b, d):
        raise ValueError(f"preds {tuple(preds.shape)} vs store dim {d} and "
                         f"{b} threshold rows")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"the kernel takes 1..{MAX_T} thresholds per "
                         f"predicate, got {t}")
    if not 1 <= k <= max(1, n):
        raise ValueError(f"k must lie in 1..{max(1, n)}, got {k}")
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside 0..{n}")
    if n >= 2**31 or b * t >= 2**31 or b * k >= 2**31:
        raise ValueError("store rows, B*T and B*k must fit int32")
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
        if t != 1 or k != 1:
            raise ValueError(f"a compound launch takes one threshold per "
                             f"conjunct and k = 1, got T = {t}, k = {k}")
        code = MODES[mode]
    bt = tile_width(b)
    sms = torch.cuda.get_device_properties(store.device).multi_processor_count
    rows, nblk, kb, part = launch_shape(n_valid, b, t, k, sms, bool(code),
                                        wide=False)
    if _lib().cosine_topk_smem_bytes(bt, d, kb, rows, code) > MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    narrow = (ctypes.c_int * 8)(d, b, t, k, bt, rows, code, 0)
    wide = None
    if b > MAX_TILE and not code and wide_fits(d):
        part = max(part, launch_shape(n_valid, b, t, k, sms)[3])
        wide = (ctypes.c_int * 8)(d, b, t, k, 0, WIDE_ROWS, 0,
                                  wide_grid(n_valid, sms))
    return narrow, wide, d, b, t, part, code, store.device.index


def probe(store: torch.Tensor, preds: torch.Tensor, thresholds: torch.Tensor,
          *, k: int, n_valid: int, mask: torch.Tensor | None = None,
          mode: str | None = None, entry: str = "cosine_probe_batch",
          one: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the probe: store (N, d), preds (B, d), thresholds (B, T), all
    contiguous float32 on one CUDA device. Rows >= ``n_valid`` are dead, and
    so is every row whose ``mask`` (N,) int32 entry is 0.

    ``mode`` None returns (counts (B, T) int32, the k smallest live
    distances (B, k) ascending, +inf past the live rows); "and" or "or"
    scores the B conjuncts of one compound predicate (T = 1, k = 1) and
    returns (the match count, 0-d int32, None). ``entry`` names the call in
    ``entry_launches``; ``one`` takes a single predicate, preds (d,) and
    thresholds (T,), and returns counts (T,) and top-k (k,)."""
    global launches
    key = (store.shape, store.stride(), store.dtype, store.device,
           preds.shape, preds.stride(), preds.dtype, preds.device,
           thresholds.shape, thresholds.stride(), thresholds.dtype,
           thresholds.device, None if mask is None else
           (mask.shape, mask.stride(), mask.dtype, mask.device),
           k, n_valid, mode, one)
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) > 256:
            _plans.clear()
        plan = _plans[key] = _plan(store, preds, thresholds, mask, k,
                                   n_valid, mode, one)
    narrow, wide, d, b, t, part, code, index = plan
    sp, pp = store.data_ptr(), preds.data_ptr()
    vec = d % 4 == 0 and sp % 16 == 0
    # the wide launch reads rows and predicates by 16-byte bulk copies
    layout = wide if vec and wide is not None and pp % 16 == 0 else narrow
    dev = store.device
    if code:
        counts, topk = torch.empty((), dtype=torch.int32, device=dev), None
    else:
        counts = torch.empty((t,) if one else (b, t), dtype=torch.int32,
                             device=dev)
        topk = torch.empty((k,) if one else (b, k), dtype=torch.float32,
                           device=dev)
    # the current stream's handle without building a Stream object (which
    # costs more than the rest of the call's host work)
    stream = torch._C._cuda_getCurrentRawStream(index)
    lib = _lib()
    events = None
    if getattr(_timing, "armed", False):
        _timing.n += 1
        if _timing.n == 1:
            events = _event_pair(index)
    with _lock:
        scratch = _scratch.get(stream)
        if scratch is None or scratch.numel() < part:
            scratch = _scratch[stream] = torch.empty(
                max(part, 1 << 16), dtype=torch.int32, device=dev)
        if events is not None:
            events[0].record(torch.cuda.current_stream(dev))
        err = lib.cosine_topk_launch(
            sp, pp, thresholds.data_ptr(),
            None if mask is None else mask.data_ptr(), counts.data_ptr(),
            None if topk is None else topk.data_ptr(), scratch.data_ptr(),
            layout, n_valid, int(vec), index, stream)
        if events is not None:
            events[1].record(torch.cuda.current_stream(dev))
            if err == 0:
                _timing.recorded = events
        if err == 0:
            launches += 1
            entry_launches[entry] += 1
            path_launches["wide" if layout is wide else "narrow"] += 1
    _build.check(lib, NAME, err)
    return counts, topk

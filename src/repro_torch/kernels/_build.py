"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and the
stream as ``void*``/``int``; the return value is the ``cudaError_t`` of the
launch) and is compiled on its own by ``nvcc`` into
``build/lib<name>-<hash>.so`` beside the package, where ``<hash>`` is the
content hash of the source and of every header it includes by quotes
(``csrc/hopper.cuh``), recursively: a library is built once per version of
its sources and reused by later processes. ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them.

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is needed only when a kernel is first launched on a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from csrc/*.cu at first use")
    return str(path)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and the headers it includes by quotes (found
    beside the including file), recursively, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists():
                todo.append(header)
    return found


def _target(name: str) -> pathlib.Path:
    data = b"".join(p.read_bytes() for p in sources(name))
    digest = hashlib.sha1(data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return start_nvcc(CSRC / f"{name}.cu", tmp), tmp, out


def start_nvcc(source: pathlib.Path, out: pathlib.Path) -> subprocess.Popen:
    """Start ``nvcc`` with the port's flags on ``source`` into the library
    ``out``; its output (ptxas register use) comes back on stdout."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name, proc, tmp, out) -> None:
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: list[str]) -> None:
    """Compile every named source that has no library yet, in parallel."""
    with _lock:
        todo = [n for n in names if n not in _libs and not _target(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        errors = []
        for name, proc, tmp, out in started:    # wait for every nvcc
            try:
                _finish(name, proc, tmp, out)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def require_cuda(name: str, dtypes, **tensors) -> None:
    """Raise unless every tensor is on the first tensor's CUDA device, of a
    dtype in ``dtypes``, with a contiguous last dim."""
    dev = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.dtype not in dtypes:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor of "
                             f"{sorted(map(str, dtypes))}, got {t.dtype} on "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs a contiguous last dim")


MAX_HEAD_DIM = 256   # the attention kernels: D a multiple of 4 up to this


def head_dim_ok(D: int) -> bool:
    """A head dim the three attention kernels take: a multiple of 4 up to
    256 (each pads it, in shared memory or registers, to a width it was
    built for)."""
    return 0 < D <= MAX_HEAD_DIM and D % 4 == 0


def aligned4(*tensors) -> bool:
    """Every row of every tensor starts on a 4-byte boundary, so a kernel
    may read them as 4-byte words."""
    return all(t.data_ptr() % 4 == 0
               and all(s * t.element_size() % 4 == 0 for s in t.stride()[:-1])
               for t in tensors)


def aligned16(*tensors) -> bool:
    """Every row of every tensor starts on a 16-byte boundary, so a kernel
    may read them as 16-byte vectors."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1])
               for t in tensors)


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")

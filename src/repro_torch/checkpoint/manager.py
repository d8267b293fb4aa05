"""Checkpoints of a tree of tensors, with the reference's guarantees and
layout (``repro/checkpoint/manager.py``): ``<dir>/step_N/{manifest.json,
shard_<host>.npz}``.

  * atomicity  — written to ``step_N.tmp/``, fsync'd, renamed to
                 ``step_N/``: a crash mid-write never corrupts the latest
                 checkpoint, and ``latest_step`` sees only whole ones
  * async      — ``save_async`` copies every tensor to host memory at once
                 (so a train step may write the state in place right after)
                 and writes on a background thread
  * restore    — ``restore(step, like)`` rebuilds ``like``'s tree on the
                 devices and in the dtypes of ``like``'s leaves
  * retention  — the newest ``keep`` checkpoints are kept

Keys are the tree paths joined by ``/`` (dict keys, list indices);
``manifest.json`` holds each key's shape and dtype. A dtype numpy lacks
(bfloat16, the float8 types) is stored as its raw 1- or 2-byte words, its
torch name in the manifest, and viewed back on restore: no ``ml_dtypes``
needed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

_SEP = "/"
_RAW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.int8,
        torch.float8_e5m2: torch.int8}
_BY_NAME = {str(t).removeprefix("torch."): t for t in _RAW}


def _paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) in tree order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _paths(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array, dtype name) of one leaf, copied to host memory."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)   # the caller may write leaf
    name = str(t.dtype).removeprefix("torch.")
    return t.view(_RAW.get(t.dtype, t.dtype)).numpy(), name


def _unflatten(like: Any, leaves) -> Any:
    """``leaves`` (an iterator, in ``_paths`` order) in ``like``'s
    structure."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 host_id: int = 0, num_hosts: int = 1):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save

    def _snapshot(self, state: Any) -> dict[str, tuple[np.ndarray, str]]:
        return {k: _to_host(v) for k, v in _paths(state)}

    def _write(self, step: int, flat: dict) -> Path:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        keys = sorted(flat)
        np.savez(tmp / f"shard_{self.host_id}.npz",
                 **{k: flat[k][0] for k in keys})
        manifest = {
            "step": step,
            "keys": keys,
            "num_hosts": self.num_hosts,
            "shapes": {k: list(flat[k][0].shape) for k in keys},
            "dtypes": {k: flat[k][1] for k in keys},
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        for f in tmp.iterdir():  # fsync before the atomic rename
            with open(f, "rb") as fh:
                os.fsync(fh.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def save(self, step: int, state: Any) -> Path:
        return self._write(step, self._snapshot(state))

    def save_async(self, step: int, state: Any) -> threading.Thread:
        """Copy to host memory NOW, write in the background."""
        self.wait()
        flat = self._snapshot(state)
        t = threading.Thread(target=self._write, args=(step, flat),
                             daemon=True)
        t.start()
        self._thread = t
        return t

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore

    def latest_step(self) -> int | None:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if not p.name.endswith(".tmp")
                 and (p / "manifest.json").exists()]
        return max(steps) if steps else None

    def restore(self, step: int | None, like: Any, *,
                shardings: Any = None) -> Any:
        """The checkpoint in the structure of ``like``, each leaf in the
        dtype of ``like``'s leaf there and on its device, or, with
        ``shardings`` (a tree of ``models.nn.Placement``s in ``like``'s
        structure: an elastic restart onto another mesh), on its
        placement's device, the placement kept on the leaf
        (``tensor.placement``)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        dtypes = json.loads((d / "manifest.json").read_text())["dtypes"]
        data: dict[str, np.ndarray] = {}
        for shard in sorted(d.glob("shard_*.npz")):
            with np.load(shard) as z:
                for k in z.files:
                    data[k] = z[k]
        places = {} if shardings is None else dict(_paths(shardings))
        out = []
        for key, ref in _paths(like):
            place = places.get(key)
            if shardings is not None and place is None:
                raise KeyError(f"no placement for {key}")
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            t = torch.from_numpy(arr)
            if dtypes[key] in _BY_NAME:
                t = t.view(_BY_NAME[dtypes[key]])
            if place is not None:
                t = t.to(device=place.device, dtype=ref.dtype)
                t.placement = place
            elif isinstance(ref, torch.Tensor):
                t = t.to(device=ref.device, dtype=ref.dtype)
            else:
                t = arr.astype(np.asarray(ref).dtype)
            out.append(t)
        return _unflatten(like, iter(out))

    # --------------------------------------------------------------- gc

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp"))
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

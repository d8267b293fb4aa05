"""Host-side data pipeline, as ``repro/data/pipeline.py``: deterministic,
shard-aware, prefetching.

  * every host makes ONLY its shard of the global batch (host_id /
    num_hosts split over the batch dim),
  * the batch of step N comes from (seed, N, host_id) alone, through the
    reference's numpy generator, so it is bitwise the reference's batch
    and a restart needs no data state in its checkpoint,
  * a background thread prefetches a few batches, so the host's batch
    assembly overlaps the device's work; ``lm_data_iterator`` hands them
    out as tensors on the device.

Synthetic token streams stand in for a tokenised corpus, as there.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def synth_lm_batch(cfg, shape, step: int, *, seed: int = 0, host_id: int = 0,
                   num_hosts: int = 1) -> dict:
    """Deterministic synthetic next-token batch (the host's shard), numpy."""
    B = shape.global_batch // num_hosts
    S = shape.seq_len
    rng = np.random.default_rng((seed, step, host_id))
    if cfg.encdec:
        dec = max(1, int(S * (cfg.audio.dec_len_ratio if cfg.audio else 1.0)))
        toks = rng.integers(0, cfg.vocab_size, (B, dec), dtype=np.int32)
        return {
            "frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "tokens": toks,
            "labels": np.roll(toks, -1, axis=1),
        }
    if cfg.vlm is not None:
        p = cfg.vlm.num_patch_tokens
        toks = rng.integers(0, cfg.vocab_size, (B, S - p), dtype=np.int32)
        return {
            "patch_embeds": rng.standard_normal((B, p, cfg.d_model)).astype(
                np.float32),
            "tokens": toks,
            "labels": np.roll(toks, -1, axis=1),
        }
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


class PrefetchIterator:
    """Background prefetch of ``depth`` batches; ``make_batch(i)`` makes the
    i-th."""

    def __init__(self, make_batch, num_steps: int, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._n = num_steps
        self._make = make_batch
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        for i in range(self._n):
            self._q.put(self._make(i))
        self._q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item


def lm_data_iterator(cfg, shape, *, num_steps: int, seed: int = 0,
                     host_id: int = 0, num_hosts: int = 1,
                     device=None) -> PrefetchIterator:
    """``synth_lm_batch`` for steps 0 .. num_steps - 1 as tensors on
    ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)

    def make(step):
        batch = synth_lm_batch(cfg, shape, step, seed=seed, host_id=host_id,
                               num_hosts=num_hosts)
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    return PrefetchIterator(make, num_steps)

"""Compressed KV-cache batching (paper §3.2) — the full pipeline:

  OFFLINE (``build_compressed_store``)
   1. k-means-diverse sample of ``sample_size`` images (kernels/kmeans medoids)
   2. batched VLM prefill over the sample's (stubbed) patch embeddings
   3. Expected-Attention compression of each layer's KV cache at ``rate``
   4. compressed caches kept on the device, with room for the prompt

  ONLINE (``batched_prompt_decode``, per filter predicate)
   5. finish prefill: run the short prompt token-by-token as batched decode
      steps against all caches at once (the paper's "two more VLM passes")
   6. read a yes/no answer token per image
   7. calibrate: threshold = m-th smallest predicate<->sample distance where
      m = #yes; if m == 0, the smallest observed distance

Semantics vs systems split, as in the reference: with synthetic weights the
VLM's logits carry no meaning, so *answers* come from the corpus oracle
while *latency and memory* come from executing the real machinery above.

The random draws (the parameters, the patch lift, the calibration tokens)
happen in ``build_compressed_store``; ``assemble_store`` is the build given
them, so a test can hand in the reference's own arrays (``jax.random`` bits
cannot be reproduced in torch).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.models.steps import make_decode_step, make_prefill_step, model_specs
from repro_torch.serving.compress import calibration_q_stats, compress_cache

f32 = torch.float32
PATCH_CHUNK = 32      # patches of the lift drawn at a time (0.6 GB at full width)
PROMPT_ROOM = 16      # cache slots past the compressed ones, for the prompt


def fabricate_patch_embeds(image_embs: torch.Tensor, cfg, n_patches: int, *,
                           gen: torch.Generator) -> torch.Tensor:
    """Modality-frontend STUB: lift (B, d_img) image embeddings to
    (B, n_patches, d_model) pseudo projector outputs through a random
    (n_patches, d_img, d_model) normal / sqrt(d_img) lift, as the reference
    does. At full width the lift is 54 GB in float32, so it is drawn from
    ``gen`` and applied ``PATCH_CHUNK`` patches at a time on ``gen``'s
    device; only the (B, n_patches, d_model) output is kept."""
    dev = gen.device
    x = image_embs.to(device=dev, dtype=f32)
    B, d_img = x.shape
    out = torch.empty((B, n_patches, cfg.d_model), dtype=cfg.compute_dtype,
                      device=dev)
    for p0 in range(0, n_patches, PATCH_CHUNK):
        n = min(PATCH_CHUNK, n_patches - p0)
        lift = torch.randn((n, d_img, cfg.d_model), generator=gen,
                           device=dev, dtype=f32) / math.sqrt(d_img)
        out[:, p0:p0 + n] = torch.einsum("bd,pdm->bpm", x, lift).to(
            cfg.compute_dtype)
    return out


@dataclasses.dataclass
class CompressedCacheStore:
    """Per-layer compressed (k, v) caches for the whole sample batch.

    With the machinery off only ``sample_ids`` is needed (the KV-batch
    estimate calibrates on the sample alone)."""

    sample_ids: np.ndarray    # image ids in the sample
    cfg: Any = None
    params: Any = None
    cache: Any = None         # [{"k", "v"}] per layer, (B, capacity, Hkv, D)
    cache_len: int = 0        # compressed length actually valid
    cache_capacity: int = 0   # allocated length (compressed + prompt room)
    build_s: float = 0.0
    bytes_total: int = 0


def assemble_store(cfg, params: dict, patches: torch.Tensor,
                   calib_tokens: torch.Tensor, sample_ids, *,
                   rate: float) -> CompressedCacheStore:
    """Offline steps 2-4 from given parameters, patch embeddings (B, P, d)
    and calibration tokens (2, 32), all on one device. Each layer's full
    cache is freed once it is compressed."""
    B, n_patches = patches.shape[:2]
    keep = max(1, int(np.ceil(n_patches * (1.0 - rate))))
    capacity = keep + PROMPT_ROOM
    prefill = make_prefill_step(cfg, batch=B, max_len=n_patches)
    _, full_cache = prefill(params, {"patch_embeds": patches})

    # q statistics for the press from a generic calibration prompt
    qstats = calibration_q_stats(params, cfg, calib_tokens)

    cache = []
    for li in range(cfg.num_layers):
        c = full_cache[li]
        full_cache[li] = None
        k_c, v_c, _ = compress_cache(c["k"], c["v"], qstats.mu[li],
                                     qstats.var[li], rate=rate)
        del c
        layer = {}
        for name, t in (("k", k_c), ("v", v_c)):
            buf = torch.zeros((B, capacity, *t.shape[2:]), dtype=t.dtype,
                              device=t.device)
            buf[:, :keep] = t
            layer[name] = buf
        cache.append(layer)

    nbytes = sum(t.numel() * t.element_size() for t in nn.tree_leaves(cache))
    return CompressedCacheStore(
        sample_ids=np.asarray(sample_ids), cfg=cfg, params=params,
        cache=cache, cache_len=keep, cache_capacity=capacity,
        bytes_total=int(nbytes))


def build_compressed_store(
    image_embs: np.ndarray,
    sample_ids: np.ndarray,
    *,
    rate: float,
    smoke: bool = True,
    seed: int = 0,
    device=None,
) -> CompressedCacheStore:
    """Offline steps 2-4 for ``llava-next-8b`` (its smoke reduction unless
    ``smoke=False``) on ``device`` (the card unless asked otherwise): draws
    the parameters, the patch lift and the calibration tokens from seeded
    ``torch.Generator``s there, then ``assemble_store``."""
    dev = resolve_device(device)
    cfg = get_config("llava-next-8b", smoke=smoke)
    t0 = time.perf_counter()
    params = nn.init_params(model_specs(cfg),
                            torch.Generator(device=dev).manual_seed(seed))
    embs = torch.as_tensor(np.asarray(image_embs)[np.asarray(sample_ids)],
                           dtype=f32)
    patches = fabricate_patch_embeds(
        embs, cfg, cfg.vlm.num_patch_tokens,
        gen=torch.Generator(device=dev).manual_seed(seed + 2))
    calib = torch.randint(
        0, cfg.vocab_size, (2, 32), device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))
    store = assemble_store(cfg, params, patches, calib, sample_ids, rate=rate)
    _sync(dev)
    store.build_s = time.perf_counter() - t0
    return store


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def batched_prompt_decode(
    store: CompressedCacheStore, prompt_tokens: np.ndarray,
) -> tuple[np.ndarray, float]:
    """Online steps 5-6: returns (answer logits (B, V) float32, seconds).

    Writes the prompt's K/V into slots ``cache_len ..`` of the store's
    caches in place. Each step writes slot ``cache_len + t`` before it reads
    slots ``< cache_len + t + 1``, so every call sees the compressed caches
    as built, whatever an earlier call left in the prompt room. The clock
    is read after the device finished."""
    cfg = store.cfg
    B = len(store.sample_ids)
    dev = store.params["embed"].device
    decode = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t, tok in enumerate(list(prompt_tokens)):
        toks = torch.full((B, 1), int(tok), dtype=torch.long, device=dev)
        logits, _ = decode(store.params, store.cache, {"tokens": toks},
                           store.cache_len + t)
    _sync(dev)
    dt = time.perf_counter() - t0
    return logits.to(f32).cpu().numpy(), dt


def threshold_from_matches(sample_dists: np.ndarray, m: int) -> float:
    """Paper §3.2 calibration: m-th smallest distance; 0 matches -> min."""
    order = np.sort(np.asarray(sample_dists, np.float64))
    if m <= 0:
        return float(max(order[0] - 1e-6, 0.0))
    if m >= len(order):
        return float(order[-1] + 1e-6)
    return float(0.5 * (order[m - 1] + order[m]))

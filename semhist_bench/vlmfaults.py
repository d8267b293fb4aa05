"""Faults planted in the program's KV-batch VLM, to see the check fail:
the CPU tests plant them at smoke size (``test_semhist_bench_vlm.py``),
``vlm_readings.py --faults`` reads them at a cell's own size. A benchmark
run never plants one.

  * ``cache_row_perturbed``: one judged sample row's compressed cache
    never written (every part of it, K and V for a GQA cache, left at
    zero in every layer);
  * ``cache_position_overwritten``: in the middle layer, one judged row's
    first kept position holds every part of its second (one position
    written twice, one lost), every head;
  * ``layer_attention_skipped``: the decode skips the last layer's
    attention;
  * ``decode_attention_skipped``: the decode skips every layer's
    attention;
  * ``decode_heads_misrouted``: in the decode, query head h computes
    head h + rep's query (rep query heads a KV head), so each group's
    queries read the next group's KV head, every layer;
  * ``press_unchanged``: the press keeps the cache's first positions,
    whatever they score.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = ("cache_row_perturbed", "cache_position_overwritten",
          "layer_attention_skipped", "decode_attention_skipped",
          "decode_heads_misrouted", "press_unchanged")
DECODE = ("layer_attention_skipped", "decode_attention_skipped",
          "decode_heads_misrouted")


@contextlib.contextmanager
def planted(name: str):
    """Plant ``name`` while the block runs. Yields ``after_build(kvstore,
    rows)``, to be called on the built store (``rows``: the judged sample
    rows) before anything decodes."""
    from repro_torch.core import kvbatch
    from repro_torch.models import lm

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    undo = []

    def patch(mod, attr, value):
        undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def after_build(kvstore, rows):
        j = int(rows[0])
        if name == "cache_row_perturbed":
            for c in kvstore.cache:
                for t in c.values():
                    t[j] = 0
        elif name == "cache_position_overwritten":
            for t in kvstore.cache[len(kvstore.cache) // 2].values():
                t[j, 0] = t[j, 1]
        elif name in DECODE:
            layers = kvstore.params["layers"]
            if name == "layer_attention_skipped":
                layers = layers[-1:]
            targets = [lp["mixer"] for lp in layers]
            inner = lm.attention_apply

            def attention_apply(p, x, *, mode, cache=None, **kw):
                if mode != "decode" or not any(p is t for t in targets):
                    return inner(p, x, mode=mode, cache=cache, **kw)
                if name == "decode_heads_misrouted":
                    rep = p["wq"].shape[1] // p["wk"].shape[1]
                    return inner(dict(p, wq=p["wq"].roll(rep, dims=1)), x,
                                 mode=mode, cache=cache, **kw)
                return torch.zeros_like(x), cache

            patch(lm, "attention_apply", attention_apply)

    if name == "press_unchanged":
        def compress_cache(k, v, mu, var, *, rate):
            keep = max(1, int(np.ceil(k.shape[1] * (1.0 - rate))))
            idx = torch.arange(keep, device=k.device)[None, :, None].expand(
                k.shape[0], keep, k.shape[2]).clone()
            return k[:, :keep].clone(), v[:, :keep].clone(), idx

        patch(kvbatch, "compress_cache", compress_cache)
    try:
        yield after_build
    finally:
        for mod, attr, value in reversed(undo):
            setattr(mod, attr, value)

"""What a run draws for the KV-batch VLM (paper §3.2) from its seed: the
weights, the sample's patch embeddings and the calibration tokens, and
which sample rows the reference judges.

The program only loads these (``stack.build`` hands them to the port's
``assemble_store``); the reference draws the same weights again, one
layer at a time, and the same patches, so it never reads a tensor the
program made. Nothing here imports the program.

A leaf is ``(path, shape, init, dtype)``: its dotted path in the weight
tree (``layers.3.mixer.wq``), its shape, ``normal``, ``ones`` or
``zeros``, and the type it is served in. Leaves are drawn by group (a
layer, or ``top`` for the rest), each group from a generator of its own
on the device, in one call per type: the group's random leaves, in path
order, are consecutive pieces of one draw. A group's values depend only
on the seed, the group's name and its leaves, so either side can draw
any layer alone.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from semhist_bench.corpus import rng_for

# every random leaf is normal(0, STD): the initializer_range of
# Llama-3-8B's (and Qwen2.5's) config.json
STD = 0.02
PATCH_CHUNK = 32         # patches of the lift drawn at a time (0.6 GB at full width)
CALIB_SHAPE = (2, 32)    # the calibration prompts of the Expected-Attention press
JUDGED_ROWS = 4          # sample rows the reference works through
ALIGN = 64               # a leaf starts on a multiple of this many values

P_WEIGHTS, P_PATCHES, P_CALIB, P_ROWS = 40, 41, 42, 43   # seed purposes


def _gen(seed: int, *words: int, device) -> torch.Generator:
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *words])
    s = int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(s)


def group_of(path: str) -> str:
    """``layers.3`` for a leaf of layer 3, ``top`` for the rest."""
    parts = path.split(".")
    return ".".join(parts[:2]) if len(parts) > 1 and parts[1].isdigit() \
        else "top"


def groups(layout: list) -> list[str]:
    """The layout's groups, ``top`` first, then the layers in order."""
    seen = {group_of(p) for p, *_ in layout}
    return sorted(seen, key=lambda g: (g != "top", int(g.split(".")[1])
                                       if g != "top" else 0, g))


def draw_group(layout: list, seed: int, group: str, device
               ) -> dict[str, torch.Tensor]:
    """The leaves of ``group`` (path -> tensor on ``device``)."""
    dev = torch.device(device)
    leaves = sorted(leaf for leaf in layout if group_of(leaf[0]) == group)
    if not leaves:
        raise KeyError(f"the layout has no group {group!r}")
    gen = _gen(seed, P_WEIGHTS, zlib.crc32(group.encode()), device=dev)
    out = {}
    by_type: dict[torch.dtype, list] = {}
    for path, shape, init, dtype in leaves:
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=dev)
        elif init == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "normal":
            by_type.setdefault(dtype, []).append((path, tuple(shape)))
        else:
            raise ValueError(f"{path}: unknown init {init!r}")
    for dtype in sorted(by_type, key=str):
        sizes = [math.prod(s) for _, s in by_type[dtype]]
        starts = np.concatenate([[0], np.cumsum(
            [-(-n // ALIGN) * ALIGN for n in sizes])])
        buf = torch.randn(int(starts[-1]), generator=gen, dtype=dtype,
                          device=dev).mul_(STD)
        for (path, shape), a, n in zip(by_type[dtype], starts, sizes):
            out[path] = buf[int(a):int(a) + n].view(shape)
    return out


def draw_patches(embs: torch.Tensor, d_model: int, n_patches: int,
                 dtype: torch.dtype, seed: int) -> torch.Tensor:
    """The modality stub (the port's ``fabricate_patch_embeds``): (B, d_img)
    image embeddings lifted to (B, n_patches, d_model) through a seeded
    (n_patches, d_img, d_model) normal / sqrt(d_img) lift, drawn
    ``PATCH_CHUNK`` patches at a time on ``embs``'s device; only the
    output is kept, in ``dtype``. A matrix product's rounding may follow
    its shape, so the reference calls this with the whole sample, as the
    build does, and keeps the rows it judges."""
    dev = embs.device
    x = embs.to(torch.float32)
    B, d_img = x.shape
    gen = _gen(seed, P_PATCHES, device=dev)
    out = torch.empty((B, n_patches, d_model), dtype=dtype, device=dev)
    for p0 in range(0, n_patches, PATCH_CHUNK):
        n = min(PATCH_CHUNK, n_patches - p0)
        lift = torch.randn((n, d_img, d_model), generator=gen, device=dev,
                           dtype=torch.float32) / math.sqrt(d_img)
        out[:, p0:p0 + n] = torch.einsum("bd,pdm->bpm", x, lift).to(dtype)
    return out


def calib_tokens(vocab: int, seed: int, device) -> torch.Tensor:
    """The calibration prompts, (2, 32) token ids."""
    dev = torch.device(device)
    return torch.randint(0, vocab, CALIB_SHAPE, device=dev,
                         generator=_gen(seed, P_CALIB, device=dev))


def judged_rows(seed: int, batch: int) -> np.ndarray:
    """The sample rows the reference judges, ascending: one drawn from
    each of ``JUDGED_ROWS`` equal blocks of the batch, so that every half
    and every quarter of it is judged."""
    j = min(JUDGED_ROWS, batch)
    edges = np.linspace(0, batch, j + 1).astype(np.int64)
    rng = rng_for(seed, P_ROWS)
    return np.asarray([rng.integers(a, b) for a, b in zip(edges[:-1],
                                                          edges[1:])])

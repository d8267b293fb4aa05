"""The KV-batch VLM's part of ``correct``: what the program's VLM produced
on the judged sample rows, against the plain reference of that VLM.

The reference is ``vlm/<vlm id>.py``, found by the configuration's
``kvbatch.vlm`` as a per-layer metric's reader is found by its name; a
VLM with no such file stops the run before set-up. It gives ``SERVED``
(the weights' and patches' type), ``widths(smoke)`` (at least
``layers``, ``d``, ``patches``, ``vocab`` and ``press_heads``, the heads
the press picks positions for), ``layout`` (the weight tree's leaves,
which the program's own must equal) and ``forward`` (see
``vlm/llava-next-8b.py``), whose ``seen(i, parts)`` hands over layer i's
cache at the kept positions as named parts, ``{name: (N, keep, ...)}``:
``k`` and ``v`` for a GQA cache, the latent parts for a latent one. It
draws the benchmark's weights, patches and calibration tokens again
(``vlmdraw``) and reads nothing the program made but the kept positions,
the cache and the logits it judges. Each layer of the program's store is
a dict of tensors of shape (B, slots, ...), recorded whole by name
(``stack.record_cache``). Three numbers:

  * ``vlm_keep_gap``: of the positions the program's Expected-Attention
    press kept, over the judged rows, every layer and press head, the
    share that the reference's own press would not keep;
  * ``vlm_cache_gap``: the largest distance, over the judged rows, every
    layer, every part the reference names and every kept slot, between
    a vector (the part's last axis) the program's compressed cache holds
    after the window and the reference's at the position the program's
    press says the slot holds, over the reference's RMS vector norm of
    that layer's part at those positions; a store whose layer holds other
    parts than the reference names reads ``NO_READING``;
  * ``vlm_logit_gap``: the largest gap between an answer logit the
    program's prompt decode gave and the reference's decode over its own
    caches at the program's kept positions, over the reference's logit
    RMS; the worst of the decodes recorded (the first, and up to
    ``DECODES_KEPT - 1`` later ones).

A number that cannot be read (no press, cache or decode recorded, a shape
that does not match, a value that is not finite) reads ``NO_READING``.
The control (``control_readings``) is the reference computed in float8
e4m3 (weights, a matrix product's operands, the cache) put in the
program's place. This module imports nothing of
the program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import torch

from semhist_bench import vlmdraw

NO_READING = 1e30
DECODES_KEPT = 3
CONTROL = torch.float8_e4m3fn   # the step below the VLM's bfloat16


@dataclasses.dataclass
class VLMRecord:
    """What the program's VLM produced on the judged rows."""

    rows: np.ndarray                                  # judged sample rows
    kept: list = dataclasses.field(default_factory=list)     # per layer (J, keep, press heads)
    cache: list = dataclasses.field(default_factory=list)    # per layer {part: (J, keep, ...)}
    decodes: list = dataclasses.field(default_factory=list)  # (prompt, logits (J, V))
    decode_calls: int = 0


def reference_module(bench_dir: pathlib.Path, vlm: str):
    """The plain reference ``vlm/<vlm>.py``."""
    path = bench_dir / "vlm" / f"{vlm}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"the configuration names the KV-batch VLM {vlm!r}, which has no "
            f"plain reference: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        "semhist_bench_vlm_" + "".join(c if c.isalnum() else "_"
                                       for c in vlm), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(leaf) -> tuple:
    path, shape, init, dtype = leaf
    return (path, tuple(int(s) for s in shape), init, str(dtype))


def check_layout(ref, smoke: bool, program_layout: list) -> None:
    """The program's weight tree has the reference's leaves, no more."""
    want = {_key(x) for x in ref.layout(smoke)}
    got = {_key(x) for x in program_layout}
    if want != got:
        raise ValueError(
            "the program's VLM weights differ from the reference's layout: "
            f"only the program has {sorted(got - want)[:4]}, only the "
            f"reference {sorted(want - got)[:4]}")


@dataclasses.dataclass
class Inputs:
    """The reference's inputs, drawn again from the seed."""

    weights: object          # group -> {path: tensor}
    patches: torch.Tensor    # (J, P, d) of the judged rows
    calib: torch.Tensor      # (2, 32)


def draw_inputs(ref, smoke: bool, seed: int, sample_embs: np.ndarray,
                rows: np.ndarray, device) -> Inputs:
    w = ref.widths(smoke)
    dev = torch.device(device)
    lay = ref.layout(smoke)
    embs = torch.as_tensor(np.asarray(sample_embs, np.float32), device=dev)
    patches = vlmdraw.draw_patches(embs, w["d"], w["patches"], ref.SERVED,
                                   seed)
    patches = patches[torch.as_tensor(rows, device=dev)].clone()
    return Inputs(weights=lambda g: vlmdraw.draw_group(lay, seed, g, dev),
                  patches=patches,
                  calib=vlmdraw.calib_tokens(w["vocab"], seed, dev))


class _NoTF32:
    def __enter__(self):
        self._was = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._was


def _prompts(decodes: list) -> list:
    out = []
    for p, _ in decodes:
        if not any(np.array_equal(p, q) for q in out):
            out.append(np.asarray(p))
    return out


def vector_gap(ref: torch.Tensor, got) -> float:
    """The largest distance between ``got`` and ``ref``'s vectors (the
    last axis) over ``ref``'s RMS vector norm."""
    ref = ref.double()
    got = torch.as_tensor(got).to(ref.device).double()
    if got.shape != ref.shape:
        return NO_READING
    gap = float((got - ref).norm(dim=-1).max()
                / ref.pow(2).sum(-1).mean().sqrt())
    return gap if math.isfinite(gap) else NO_READING


def numbers(ref_kept: list, got_kept: list, prompts: list, ref_logits: list,
            decodes: list, cache_gap: float) -> dict[str, float]:
    """The three numbers from the reference's own kept positions and
    answer logits (one per prompt), what was got, and the cache's gap."""
    keep_gap = NO_READING
    if got_kept and len(got_kept) == len(ref_kept):
        miss = total = 0
        for r, g in zip(ref_kept, got_kept):
            g = torch.as_tensor(np.asarray(g)).long()
            if g.ndim != 3 or g.shape[0] != r.shape[0] or \
                    g.shape[2] != r.shape[2] or g.min() < 0:
                miss = None
                break
            r = r.cpu()
            S = int(max(r.max(), g.max())) + 1
            ref_mask = torch.zeros((r.shape[0], S, r.shape[2]), dtype=torch.bool)
            ref_mask.scatter_(1, r, True)
            hit = torch.gather(ref_mask, 1, g)
            miss += int((~hit).sum())
            total += g.numel()
        if miss is not None and total:
            keep_gap = miss / total
    logit_gap = NO_READING if not decodes else 0.0
    for p, got in decodes:
        ref = ref_logits[next(i for i, q in enumerate(prompts)
                              if np.array_equal(p, q))].cpu().double()
        got = torch.as_tensor(np.asarray(got)).double()
        if got.shape != ref.shape:
            logit_gap = NO_READING
            break
        gap = float((got - ref).abs().max() / ref.pow(2).mean().sqrt())
        logit_gap = max(logit_gap, gap if math.isfinite(gap) else NO_READING)
    return {"vlm_keep_gap": float(keep_gap),
            "vlm_cache_gap": float(cache_gap),
            "vlm_logit_gap": float(logit_gap)}


def judge(ref, kv: dict, seed: int, sample_embs: np.ndarray,
          rec: VLMRecord, device) -> dict[str, float]:
    """The program's numbers: ``rec`` against the reference."""
    smoke = bool(kv.get("smoke", False))
    w = ref.widths(smoke)
    J = len(rec.rows)
    usable = len(rec.kept) == w["layers"] and all(
        np.ndim(k) == 3 and np.shape(k)[0] == J
        and np.shape(k)[2] == w["press_heads"] for k in rec.kept)
    gaps = []

    def seen(i, parts):
        got = rec.cache[i]
        if set(got) != set(parts):
            gaps.append(NO_READING)
            return
        gaps.append(max(vector_gap(t, got[name])
                        for name, t in parts.items()))

    judge_cache = usable and len(rec.cache) == w["layers"]
    with _NoTF32(), torch.no_grad():
        inp = draw_inputs(ref, smoke, seed, sample_embs, rec.rows, device)
        prompts = _prompts(rec.decodes)
        own, logits = ref.forward(
            inp.weights, inp.patches, inp.calib, smoke=smoke,
            rate=float(kv["compression_rate"]),
            kept=rec.kept if usable else None, prompts=prompts,
            seen=seen if judge_cache else None)
    cache_gap = max(gaps, default=NO_READING) if judge_cache else NO_READING
    return numbers(own, rec.kept, prompts, logits, rec.decodes, cache_gap)


def control_readings(ref, kv: dict, seed: int, sample_embs: np.ndarray,
                     device) -> dict[str, float]:
    """The control's numbers: the reference computed in ``CONTROL`` (its
    weights, every matrix product's operands and its cache) in the
    program's place, decoding the program's prompt over its own cache at
    its own kept positions, judged as the program is."""
    smoke = bool(kv.get("smoke", False))
    w = ref.widths(smoke)
    rows = vlmdraw.judged_rows(seed, len(sample_embs))
    prompt = np.arange(int(kv["prompt_len"])) % w["vocab"]
    rate = float(kv["compression_rate"])
    cache = []
    with _NoTF32(), torch.no_grad():
        inp = draw_inputs(ref, smoke, seed, sample_embs, rows, device)
        kept, logits = ref.forward(
            inp.weights, inp.patches, inp.calib, smoke=smoke, rate=rate,
            prompts=[prompt], low=CONTROL,
            seen=lambda i, parts: cache.append(
                {name: t.cpu() for name, t in parts.items()}))
        got = VLMRecord(rows=rows, kept=[k.cpu().numpy() for k in kept],
                        cache=cache,
                        decodes=[(prompt, logits[0].cpu().numpy())])
        del kept, logits
    return judge(ref, kv, seed, sample_embs, got, device)

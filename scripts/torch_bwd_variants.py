#!/usr/bin/env python3
"""Variants of the flash backward's source, built side by side and timed in
turns in one process on one GPU: the loop for tuning
``csrc/flash_attention_bwd.cu``.

Each variant is the current source with a few lines replaced (``VARIANTS``
below). Every variant is compiled by its own ``nvcc`` (all at once, with
``_build.start_nvcc``: the port's command and flags) beside a copy of
``csrc/hopper.cuh``, and called through ``backward.flash_bwd`` with its
library in place of the port's, so a variant takes exactly the port's
launch. At one causal bf16 shape (smollm-360m's training microbatch, and
with ``--d128`` also B 2 x S 4096, 32 / 8 heads, D 128) it prints each
variant's ptxas lines for the wgmma kernels (and any ptxas warning), its
gradients' relative error against the plain ``flash_backward`` and whether
they are bitwise the first variant's, then the ms a call by CUDA events
over ``--rounds`` rounds (the variants in turns, the order reversed every
other round), and each launch's device time under torch.profiler. A
variant nvcc refuses is reported and left out. Another tree's backward
(a parent commit) is timed by ``scripts/torch_decode_ab.py SRC bwd``.

    python3 scripts/torch_bwd_variants.py [--d128] [--rounds N] [name ...]
    # from the repo root; default: every name
"""

import argparse
import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import backward, kernel  # noqa: E402
from repro_torch.models import flash_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
SOURCE = CSRC / "flash_attention_bwd.cu"

_GRADS = ("      if (whole)\n        dkdv_grads<false, BQ>(sc, dp, sts, t, qt0,"
          " key0, scale2, sq, sk,\n                              causal, "
          "window);\n      else\n        dkdv_grads<true, BQ>(sc, dp, sts, t, "
          "qt0, key0, scale2, sq, sk,\n                             causal, "
          "window);\n")

# name -> [(text in the current source, its replacement at every place),
# ...]: the knobs the design chose between (PERF.md §6)
VARIANTS = {
    "current": [],
    # the elementwise step's mask computed on every tile, not only on the
    # tiles that have a pair outside it
    "mask-all": [("      if (whole)\n        dkdv_grads<false, BQ>",
                  "      if (false)\n        dkdv_grads<false, BQ>"),
                 ("      if (whole)\n        dq_grads<false, WK>",
                  "      if (false)\n        dq_grads<false, WK>")],
    # an ablation, wrong gradients: dk / dv without its elementwise step
    "no-step": [(_GRADS, "      (void)whole;\n      (void)sts;\n")],
    # the two consumer warpgroups issue when they are ready, not in turns
    "no-turns": [("    if (cw == 0) bar_sync(mine);", ""),
                 ("      bar_sync(mine);\n", ""),
                 ("      bar_arrive(other);\n", ""),
                 ("    bar_arrive(1);", "")],
    "stages-2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages-4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    # dV's wgmma issued under a condition uniform over the warpgroup (true
    # at these shapes), as a skip of empty steps would be
    "cond-wgmma": [("        wgmma_pv<D, BQ>(dva, pf[kk], gt, kk);",
                    "        if (kw0 < sk) wgmma_pv<D, BQ>(dva, pf[kk], gt, "
                    "kk);")],
    # K read from shared memory by S^T at every step, not held in registers
    "k-smem": [("        wgmma_rs<BQ, 0>(sc, ka[ks], kmajor<D, BQ>(qt, ks), "
                "ks > 0);",
                "        wgmma_ss<BQ>(sc, kmajor<D, KB>(tiles + 64 * cw * T::SW,"
                " ks),\n                     kmajor<D, BQ>(qt, ks), ks > 0);")],
    # V read from shared memory by dP^T at every width
    "v-smem": [("static constexpr bool V_REGS = D <= 64;",
                "static constexpr bool V_REGS = false;")],
    # Q and dO in registers in the dq block at every width, or at none
    "qg-regs-all": [("static constexpr bool QG_REGS = D > 64;",
                     "static constexpr bool QG_REGS = true;")],
    "qg-smem": [("static constexpr bool QG_REGS = D > 64;",
                 "static constexpr bool QG_REGS = false;")],
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def build(names: list[str], workdir: pathlib.Path) -> dict:
    """name -> (the bound library, nvcc's log) for every variant nvcc
    builds, every nvcc at once."""
    procs = {}
    for name in names:
        d = workdir / name
        d.mkdir()
        (d / SOURCE.name).write_text(variant_source(name))
        shutil.copy(CSRC / "hopper.cuh", d / "hopper.cuh")
        procs[name] = _build.start_nvcc(d / SOURCE.name, d / "lib.so")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{log[-2000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(workdir / name / "lib.so"))
        libs[name] = (backward.bind(lib), log)
    return libs


@contextlib.contextmanager
def using(lib):
    """``backward.flash_bwd`` launches ``lib``'s kernels inside."""
    port = backward._lib
    backward._lib = lambda: lib
    try:
        yield
    finally:
        backward._lib = port


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--d128", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.names or list(VARIANTS), pathlib.Path(tmp))
        for name, (_, log) in libs.items():
            for line in cs.ptxas_summary(log):
                if "wgmma" in line:
                    print(f"  {name}: {line}", flush=True)
            for line in log.splitlines():
                if re.search(r"serializ|warning|advisory", line, re.I):
                    print(f"  {name} note: {line.strip()}", flush=True)
        run(libs, card, args.rounds, cs.TRAIN_SHAPE)
        if args.d128:
            run(libs, card, args.rounds, (2, 4096, 8, 4, 128))


def run(libs, card, rounds, shape) -> None:
    B, S, hkv, rep, D = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn((B, S, h, D), generator=gen, device=dev)
                     .to(torch.bfloat16) for h in (hkv * rep, hkv, hkv,
                                                   hkv * rep))
    scale = D ** -0.5
    out, lse = kernel.flash_fwd(q, k, v, causal=True, window=None,
                                scale=scale, return_lse=True)
    want = flash_ref.flash_backward(q, k, v, out, lse, dout, causal=True,
                                    window=None, scale=scale)

    def call():
        return backward.flash_bwd(q, k, v, out, lse, dout, causal=True,
                                  window=None, scale=scale)

    first = None
    for name, (lib, _) in libs.items():
        with using(lib):
            got = call()
        torch.cuda.synchronize()
        rel = [float((a.float() - b.float()).norm() / b.float().norm())
               for a, b in zip(got, want)]
        same = first is None or all(torch.equal(a, b)
                                    for a, b in zip(got, first))
        first = first or got
        print(f"{name}: dq dk dv relative error {[f'{r:.2e}' for r in rel]}"
              f", bitwise the first variant's: {same}", flush=True)
    names = list(libs)
    ms = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            with using(libs[n][0]):
                ms[n].append(cs.time_ms(call, 20))
    shape = f"B={B} S={S} H={hkv * rep} Hkv={hkv} D={D} causal bf16"
    print(f"backward variants at {shape} ({card}), ms a call by CUDA events "
          f"in turns, then each launch's device time:", flush=True)
    for n in names:
        per = {}
        with using(libs[n][0]):
            cs.kernel_alone_ms(call, n, ms[n][0], by_name=per)
        launches = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", k):
                    round(t, 4) for k, t in per.items()} or "not measured"
        print(f"  {n:11s} {[round(x, 4) for x in ms[n]]} {launches}",
              flush=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    g = dout.transpose(1, 2)
    lib_ms = [cs.time_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), g, retain_graph=True), 10) for _ in range(2)]
    print(f"  SDPA backward {[round(x, 4) for x in lib_ms]}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The training phase of ``chip_smoke.py`` alone, on one GPU: the flash
forward and backward kernels built with ``-Xptxas -v`` (their register
use printed), the ``cuda``-marked flash tests, then ``FlashAttention`` at
the training shapes, every smoke config's train step kernels vs plain,
smollm-360m trained at full width for 8 steps, and the flash-with-lse and
backward rows. With ``--ab``, the serve path's flash shape (B 23 x S
2880, H 32 / 8, D 128, bf16) timed with and without the lse output, in
turns (CUDA events). With ``--bwd``, only the build, the flash tests and
the backward kernel at smollm's training shape (B 4 x S 4096, 15 / 5
heads, D 64, bf16, causal) and at D 128 (B 2 x S 4096, 32 / 8 heads):
CUDA-event time, each of its three launches' device time (torch.profiler)
and SDPA's backward beside it. With ``--trace``, only the build and one
steady smollm-360m step (the train phase's configuration, after two
warm-up steps, the second timed without the profiler) under
torch.profiler in this fresh process: the top device ops by total time,
the flash backward's and forward's shares of the step's device time, and
the device's idle share over the step's wall time (the profiler's own
cost on the host inflates that wall time).

    python3 scripts/torch_train_phase.py [--ab | --bwd | --trace]
    # from the repo root
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402


def serve_ab(dev, gen) -> None:
    """The main path's flash shape with and without lse, in turns."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rn(23, 2880, 32, 128), rn(23, 2880, 8, 128), rn(23, 2880, 8, 128)
    for lse in (False, True, True, False):
        ms = [cs.time_ms(lambda: kernel.flash_fwd(
            q, k, v, causal=True, window=None, scale=128 ** -0.5,
            return_lse=lse), 5, 1) for _ in range(3)]
        print(f"serve shape, lse={lse}: {ms} ms", flush=True)


BWD_D128 = (2, 4096, 8, 4, 128)   # B S Hkv rep D: a D 128 training layer


def bwd_breakdown(dev, gen, card, shape) -> None:
    """The backward kernel at one causal bf16 shape (B, S, Hkv, rep, D):
    the call's time (CUDA events, three runs), each launch's mean device
    time, SDPA's backward."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import backward

    B, S, hkv, rep, D = shape
    q, k, v, dout = (torch.randn((B, S, h, D), generator=gen, device=dev)
                     .to(torch.bfloat16) for h in (hkv * rep, hkv, hkv,
                                                   hkv * rep))
    out, lse = kernel.flash_fwd(q, k, v, causal=True, window=None,
                                scale=D ** -0.5, return_lse=True)

    def bwd():
        return backward.flash_bwd(q, k, v, out, lse, dout, causal=True,
                                  window=None, scale=D ** -0.5)

    ms = [cs.time_ms(bwd, 20) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            bwd()
        torch.cuda.synchronize()
    per = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key):
           e.device_time_total / e.count / 1e3
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.count}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    g = dout.transpose(1, 2)
    lib = cs.time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g,
                                                 retain_graph=True), 10)
    print(f"backward at B={B} S={S} H={hkv * rep} Hkv={hkv} D={D} causal bf16 "
          f"({card}): {[round(x, 4) for x in ms]} ms a call; by launch "
          f"{ {k: round(x, 4) for k, x in per.items()} } ms; SDPA backward "
          f"{lib:.4f} ms; path launches {backward.path_launches}", flush=True)


def trace_step(card) -> None:
    """One steady smollm-360m step under torch.profiler: the device ops
    (kernels, copies) by total time, the flash kernels' shares, and the
    device's busy time (the union of the ops' intervals) against the
    step's wall time (host clock, ending in a synchronize)."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import backward
    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as ckpt:
        run = train.build(train.parse_args(cs.TRAIN_ARGS
                                           + ["--ckpt-dir", ckpt]))
        batch = list(run.data)[0]         # drains the prefetch thread
        step, state = run.runner.step_fn, run.state
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        b0 = dict(backward.path_launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        paths = {k: backward.path_launches[k] - b0[k] for k in b0}
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                    # the union of the intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in dev_events:
        name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                      e.name)[:90]
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    total = sum(t for t, _ in by_name.values())

    def share(pattern):
        return sum(t for n, (t, _) in by_name.items()
                   if re.search(pattern, n)) / max(total, 1e-9)

    print(f"smollm-360m step under torch.profiler ({card}): wall "
          f"{wall_ms:.1f} ms (the step before it, unprofiled: "
          f"{plain_ms:.1f} ms), loss {float(metrics['loss']):.4f}; device ops "
          f"{len(dev_events)}, their sum {total / 1e3:.1f} ms, busy (union) "
          f"{busy / 1e3:.1f} ms, idle share {1 - busy / 1e3 / wall_ms:.3f}; "
          f"flash backward share of the device sum {share('^bwd_'):.3f}, "
          f"flash forward {share('flash_fwd'):.3f}; backward launches by "
          f"path {paths}", flush=True)
    print("top device ops by total time (ms, count, share of the sum):",
          flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:25]:
        print(f"  {t / 1e3:9.3f} {n:6d} {t / total:6.3f}  {name}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print("card:", card, "| torch", torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    sources = ["flash_attention", "flash_attention_bwd"]
    _build.build_all(sources + ["decode_attention"])
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for src in sources:
        for line in cs.ptxas_summary(_build.build_log.get(src, "")):
            print(f"  {src}:", line)
    if "--trace" in sys.argv:
        trace_step(card)
        return
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                        "-p", "no:cacheprovider",
                        "tests/test_torch_cuda_flash_attention.py"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900,
                       env={**__import__("os").environ,
                            "PYTHONPATH": str(ROOT / "src")})
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    if r.returncode != 0:
        sys.exit("the cuda flash tests failed")
    gen = torch.Generator(device=dev).manual_seed(0)
    if "--bwd" in sys.argv:
        bwd_breakdown(dev, gen, card, cs.TRAIN_SHAPE)
        bwd_breakdown(dev, gen, card, BWD_D128)
        return
    if "--ab" in sys.argv:
        serve_ab(dev, gen)
    errs = {n: [] for n in cs.KERNELS}
    rows = cs.train_path(dev, gen, card, errs, {})
    print(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    main()

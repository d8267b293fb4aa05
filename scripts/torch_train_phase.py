#!/usr/bin/env python3
"""The training phase of ``chip_smoke.py`` alone, on one GPU: the flash
kernel built with ``-Xptxas -v`` (its register use printed), the
``cuda``-marked flash tests, then ``FlashAttention`` at the training
shapes, every smoke config's train step kernels vs plain, smollm-360m
trained at full width for 8 steps, and the flash-with-lse row with the
backward's times. With ``--ab``, the serve path's flash shape (B 23 x S
2880, H 32 / 8, D 128, bf16) timed with and without the lse output, in
turns (CUDA events).

    python3 scripts/torch_train_phase.py [--ab]    # from the repository root
"""

import json
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
    _build.build_all(["flash_attention", "decode_attention"])
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for line in cs.ptxas_summary(_build.build_log.get("flash_attention",
                                                      "")):
        print("  flash_attention:", line)
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                        "-p", "no:cacheprovider",
                        "tests/test_torch_cuda_flash_attention.py"],
                       cwd=ROOT, capture_output=True, text=True,
                       env={**__import__("os").environ,
                            "PYTHONPATH": str(ROOT / "src")})
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    if r.returncode != 0:
        sys.exit("the cuda flash tests failed")
    gen = torch.Generator(device=dev).manual_seed(0)
    if "--ab" in sys.argv:
        serve_ab(dev, gen)
    errs = {n: [] for n in cs.KERNELS}
    rows = cs.train_path(dev, gen, card, errs)
    print(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    main()

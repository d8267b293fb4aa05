#!/usr/bin/env python3
"""The model-zoo phase of ``chip_smoke.py`` alone, on one GPU, with the
attention kernels' checks of its phase 3 and the KV-batch main path's
attention shapes timed first (flash B 23 x S 2880, EA on the same cache,
decode over L 1168 at valid 1153..1158; CUDA events, three readings
each). Prints the zoo's readings and its kernels line.

    python3 scripts/torch_zoo_phase.py     # from the repository root
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
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.expected_attention import ops as ea  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    t0 = time.time()
    _build.build_all(cs.KERNELS)
    print(f"build {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {n: [] for n in cs.KERNELS}
    cs.check_attention(dev, gen, errs)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B = 23
    q, k, v = rn(B, 2880, 32, 128), rn(B, 2880, 8, 128), rn(B, 2880, 8, 128)
    print("flash main shape ms", [cs.time_ms(lambda: fa.flash_attention(
        q, k, v), 3, 1) for _ in range(3)], flush=True)
    mu = torch.randn((8, 4, 128), generator=gen, device=dev) * 0.2
    var = torch.rand((8, 4, 128), generator=gen, device=dev) * 0.1
    print("ea main shape ms", [cs.time_ms(lambda: ea.ea_scores(
        k, v, mu, var), 20) for _ in range(3)], flush=True)
    del q, k, v
    qd, kc, vc = rn(B, 1, 32, 128), rn(B, 1168, 8, 128), rn(B, 1168, 8, 128)
    valids = [1153 + i for i in range(6)]
    print("decode main shape ms", [cs.time_ms(lambda: [da.decode_attention(
        qd, kc, vc, kv_valid=n) for n in valids], 20) / 6 for _ in range(3)],
        flush=True)
    del qd, kc, vc
    torch.cuda.empty_cache()
    rows = cs.zoo_path(dev, gen, card, errs)
    print(json.dumps({"kernels": rows}))
    cs.profiler_after_sharded(dev, gen)
    print("profiler windows that fell back:", cs.FELL_BACK)


if __name__ == "__main__":
    main()

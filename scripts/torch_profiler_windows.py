#!/usr/bin/env python3
"""Count torch.profiler windows that keep no device record of the port's
ctypes kernels (flash, decode, EA; three calls a window).

    python3 scripts/torch_profiler_windows.py               # 60 rounds in a fresh process (and a torch matmul beside them)
    python3 scripts/torch_profiler_windows.py --after-phases # 5 windows each: fresh, then after chip_smoke.py's phase 4, index, mutable and concurrent phases

Prints, per kernel, the windows without device records, and the threads
alive beside each reading.
"""

import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.expected_attention import ops as ea  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402


def lost(fn) -> bool:
    """One window of three calls kept no device record."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
    return not [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rn(1, 1024, 8, 128), rn(1, 1024, 2, 128), rn(1, 1024, 2, 128)
    qd = rn(1, 1, 8, 128)
    mu = torch.randn((2, 4, 128), generator=gen, device=dev) * 0.2
    var = torch.rand((2, 4, 128), generator=gen, device=dev) * 0.1
    fns = {"flash": lambda: fa.flash_attention(q, k, v),
           "decode": lambda: da.decode_attention(qd, k, v, kv_valid=1000),
           "ea": lambda: ea.ea_scores(k, v, mu, var)}
    if "--after-phases" not in sys.argv:
        fns["torch_mm"] = lambda: q.float() @ q.float().transpose(-1, -2)
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        out = {n: [w for w in range(60) if lost(f)] for n, f in fns.items()}
        print("windows without device records, by kernel (window index "
              f"of 60): {out}", flush=True)
        return

    import chip_smoke as cs
    from repro_torch.core.optimizer import generate_queries
    from repro_torch.kernels import _build

    _build.build_all(cs.KERNELS)

    def windows(tag):
        out = {n: sum(lost(f) for _ in range(5)) for n, f in fns.items()}
        alive = [t.name for t in threading.enumerate()
                 if t is not threading.main_thread()]
        print(f"{tag}: windows of 5 without device records {out}; "
              f"threads {alive}", flush=True)

    windows("fresh")
    corpus, estimators, _, seq_profile = cs.main_path(dev)
    windows("after main path (phase 4, with its profiled passes)")
    queries = generate_queries(corpus, n_queries=5, n_filters=3, seed=0)
    _, shapes = cs.index_path(dev, corpus, estimators, queries)
    windows("after the index path")
    cs.mutable_path(dev, estimators["specificity"].hist.embeddings, shapes)
    windows("after the mutable path")
    torch.cuda.empty_cache()
    cs.concurrent_path(dev, corpus, estimators, shapes, seq_profile)
    windows("after the concurrent path")


if __name__ == "__main__":
    main()

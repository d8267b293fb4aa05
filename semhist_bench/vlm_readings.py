"""The program's readings that the KV-batch VLM's limits are set from, at
a cell's own size: its sound runs, and the faults of ``vlmfaults``.

    python3 semhist_bench/vlm_readings.py --workload <cell> --seeds <a> <b> ... [--faults N]

For each seed: the KV-batch sample as a run draws it; the program's VLM as
a run builds it (``stack.build_vlm_store`` on the benchmark's draws) and
its batched prompt decode, called through ``KVBatchEstimator`` as a run's
warm-up calls it, judged against the plain reference (``vlmcheck.judge``).
The first ``--faults`` seeds also build and judge it once with each fault
planted. One JSON line a build: the numbers compared, the seconds of each
step and the card's peak memory. The control's readings are
``control.py --vlm``'s. A run of the benchmark never runs this.
"""

import os
import sys
import time

os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]


def readings(bench_dir, cell: dict, seed: int, device,
             overrides: dict | None = None, fault: str | None = None
             ) -> dict:
    """One build of the program's VLM on ``seed``'s draws, judged; with
    ``fault`` planted (a name of ``vlmfaults.FAULTS``)."""
    import contextlib
    import gc
    import json

    import torch

    from semhist_bench import inputs, stack, vlmcheck, vlmdraw, vlmfaults
    from repro_torch.core.estimators import KVBatchEstimator

    dev = torch.device(device)
    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json")
                     .read_text())
    cfg = inputs.merge(cfg, overrides or {})
    kv = cfg["kvbatch"]
    ref = vlmcheck.reference_module(bench_dir, str(kv["vlm"]))
    port = stack.port_vlm(kv)
    vlmcheck.check_layout(ref, bool(kv.get("smoke", False)),
                          stack.vlm_layout(port.cfg))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out, t = {"seed": seed, "fault": fault}, time.perf_counter()
    sample, embs = inputs.vlm_sample(cfg, seed, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    out["inputs_s"] = time.perf_counter() - t

    rec = vlmcheck.VLMRecord(rows=vlmdraw.judged_rows(seed, len(sample)))
    with (vlmfaults.planted(fault) if fault else
          contextlib.nullcontext(lambda *a: None)) as after_build:
        t = time.perf_counter()
        kvstore = stack.build_vlm_store(port, embs, sample, seed, dev, rec)
        out["build_s"] = time.perf_counter() - t
        after_build(kvstore, rec.rows)
        t = time.perf_counter()
        undo = stack.wrap_decodes(rec)
        try:
            KVBatchEstimator(None, None, kvstore,
                             **port.estimator_kw)._machinery_latency()
        finally:
            undo()
        sync()
        out["decode_s"] = time.perf_counter() - t
    stack.record_cache(kvstore, rec)
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)
    del kvstore
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    out["numbers"] = vlmcheck.judge(ref, kv, seed, embs, rec, dev)
    sync()
    out["reference_s"] = time.perf_counter() - t
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import argparse
    import json
    import pathlib

    import torch

    from semhist_bench import vlmfaults

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=0,
                    help="seeds, from the first, that also read each fault")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 3
    bench_dir = pathlib.Path(__file__).resolve().parent
    bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    limits = json.loads((bench_dir / "limits" / f"{cell['name']}.json")
                        .read_text())
    for i, seed in enumerate(args.seeds):
        for fault in (None,) + (vlmfaults.FAULTS if i < args.faults else ()):
            out = readings(bench_dir, cell, seed, "cuda", fault=fault)
            out["fails"] = [k for k, v in out["numbers"].items()
                            if v > limits[k]]
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

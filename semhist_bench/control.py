"""The control of a cell's check: the reference put in the program's place
and computed in TF32, the step below the float32 the configurations state,
judged against the float64 reference by the same comparison as a run; with
``--vlm``, the KV-batch VLM's reference computed in float8 e4m3, the step
below its bfloat16, judged against its float32 reference
(``vlmcheck.control_readings``).

    python3 semhist_bench/control.py --workload <cell> --queries <n> --seeds <a> <b> <c> [--vlm]

Draws each seed's inputs at the cell's own size, takes the first
``--queries`` queries of the window's stream (as many as a run judges) and
prints one JSON line a seed: each number compared, beside its limit. The
check is sound only if the control fails at least one of them. Runs
nothing of the program.
"""

import os
import sys
import time

os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]


def readings(bench_dir, cell: dict, seed: int, queries: int, device,
             overrides: dict | None = None) -> dict:
    """The control's numbers for one seed."""
    import json

    from semhist_bench import inputs, reference, traffic

    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json")
                     .read_text())
    cfg = inputs.merge(cfg, overrides or {})
    mix = traffic.load_mix(bench_dir / "traffic" / f"{cell['traffic']}.json")
    tree, store, params, sample = inputs.build_inputs(cfg, seed, device)
    q = reference.Queries.of(traffic.QueryStream(tree, mix, seed)
                             .take(queries))
    ctrl, _ = reference.solve(tree, store, params, sample, q, "tf32")
    ref, ref_at_ctrl = reference.solve(tree, store, params, sample, q,
                                       "fp64", extra_thr=ctrl.avg)
    return reference.judge(q, ctrl, ref, ref_at_ctrl, 0, int(tree.n))


def vlm_readings(bench_dir, cell: dict, seed: int, device,
                 overrides: dict | None = None) -> dict:
    """The VLM control's numbers for one seed."""
    import json

    from semhist_bench import inputs, vlmcheck

    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json")
                     .read_text())
    cfg = inputs.merge(cfg, overrides or {})
    _, embs = inputs.vlm_sample(cfg, seed, device)
    kv = cfg["kvbatch"]
    ref = vlmcheck.reference_module(bench_dir, str(kv["vlm"]))
    return vlmcheck.control_readings(ref, kv, seed, embs, device)


def main() -> int:
    import argparse
    import json
    import pathlib

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--queries", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--vlm", action="store_true",
                    help="the KV-batch VLM's control instead of the plans'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    bench_dir = pathlib.Path(__file__).resolve().parent
    bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    limits = json.loads((bench_dir / "limits" / f"{cell['name']}.json")
                        .read_text())
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = (vlm_readings(bench_dir, cell, seed, "cuda") if args.vlm
                else readings(bench_dir, cell, seed, args.queries, "cuda"))
        failed = [k for k, v in nums.items() if v > limits[k]]
        print(json.dumps({"seed": seed, "numbers": nums,
                          "limits": {k: limits[k] for k in nums},
                          "fails": failed,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Find an open-loop cell's knee: the highest offered rate whose 95th
percentile stays at or under the limit, with no growing backlog, in runs
made as the benchmark makes them.

    python3 semhist_bench/sweep.py --workload <cell> --seconds <s> --runs 3 --seed <n> --rates 48 56 64

For each rate, each run is ``run.py`` in a fresh process, from a copy of
the benchmark whose mix offers that rate (the program's ``src/`` is linked,
so its kernels build once). A rate passes when every run is correct, its
``plan_p95_ms`` is at or under ``--limit-ms`` (150: one VLM call,
``core/optimizer.py``'s ``DEFAULT_VLM_CALL_S``) and the window's last
third's median latency is at most 1.5 times its first third's. Prints one
JSON line a run and, last, the knee and four fifths of it: the cell's
rate, which is then written into the mix's file by hand. A run never
searches for a rate.
"""

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
THIRDS = re.compile(r"median ms by third of the window \[([^\]]*)\]")
P95 = re.compile(r"p95 from due ([0-9.e+-]+) ms")


def checkout(tmp: pathlib.Path, traffic: str, rate: float) -> pathlib.Path:
    """A copy of the benchmark whose mix ``traffic`` offers ``rate``."""
    root = tmp / f"rate-{rate:g}"
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(ROOT / "src")
    path = root / BENCH.name / "traffic" / f"{traffic}.json"
    mix = json.loads(path.read_text())
    mix["rate_per_s"] = rate
    path.write_text(json.dumps(mix))
    return root


def run(root: pathlib.Path, workload: str, seed: int, seconds: float) -> dict:
    """One run of ``run.py`` from ``root``: its numbers, or its exit code
    and the end of its standard error."""
    proc = subprocess.run(
        [sys.executable, str(root / BENCH.name / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", "0"], cwd=root, capture_output=True, text=True)
    if proc.returncode:
        return {"rc": proc.returncode, "stderr": proc.stderr[-2000:]}
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    thirds = [float(x) for x in THIRDS.search(proc.stderr).group(1)
              .split(",")]
    return {"rc": 0, "correct": res["correct"],
            "p50_ms": res["metrics"]["plan_p50_ms"]["value"],
            "p95_ms": float(P95.search(proc.stderr).group(1)),
            "thirds_ms": thirds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--limit-ms", type=float, default=150.0)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    passed = []
    with tempfile.TemporaryDirectory() as tmp:
        for rate in args.rates:
            root = checkout(pathlib.Path(tmp), cell["traffic"], rate)
            ok = True
            for i in range(args.runs):
                seed = args.seed + i
                r = run(root, args.workload, seed, args.seconds)
                print(json.dumps({"rate_per_s": rate, "seed": seed, **r}),
                      flush=True)
                ok = ok and r["rc"] == 0 and r["correct"] \
                    and r["p95_ms"] <= args.limit_ms \
                    and r["thirds_ms"][-1] <= 1.5 * r["thirds_ms"][0]
            if ok:
                passed.append(rate)
    knee = max(passed, default=None)
    print(json.dumps({"knee_per_s": knee,
                      "rate_per_s": None if knee is None
                      else round(0.8 * knee, 1)}))
    return 0 if knee is not None else 1


if __name__ == "__main__":
    sys.exit(main())

"""The program's planner spans against the benchmark harness's own wrappers,
on one traced run of a cell, and the device's idle gaps split by the
program's ranges.

    python3 scripts/torch_planner_spans.py --workload wildlife-8m.open-mixed \\
        --seed 3000000001 --seconds 51 [--out PATH]
    python3 scripts/torch_planner_spans.py --micro 1
    python3 scripts/torch_planner_spans.py --vlm 1

from the root of a checkout, on a machine with a CUDA card. A cell run goes
through ``semhist_bench.harness.run_cell`` as ``semhist_bench/run.py --trace
1`` does, at the cell's size on the card, with every thread profiled, and
prints one JSON object:

  * ``metrics``: the run's per-layer metrics;
  * ``plans``: the window's plans and their filters, by the harness and by
    the program (``planner.plans``, ``planner.vlm_answer_calls``, and
    ``planner.vlm_answer_dense``, the calls that built a dense mask);
  * ``self_s``: the sum over the window's plans of the program's
    ``planner.wall_ns`` less ``planner.probe_ns``, beside the harness's
    ``end - start - coal_s`` over the same plans;
  * ``probe_ms``: the program's ``probe.device_ns`` a launch beside the
    profiler's probe-kernel time a launch, with the merges the trace kept;
  * ``ranges``: the program's ``planner.*`` and ``coalescer.*`` ranges in
    the trace (count, seconds);
  * ``gaps``: the device's busy time without the program's ranges (a
    range that launched kernels is also a device-side annotation, which
    the harness's ``summarize_profile`` would count as device work: its
    ``device_idle`` and ``breakdown`` are wrong here), the harness's
    labels of the device's idle time, and the
    ``planner_host`` gaps split by the program phase open in them (where
    several are open on different threads, the first of ``vlm_answer``,
    ``calibration``, ``mlp``, ``embed``; ``rest`` inside a plan's
    ``planner.wall`` otherwise; ``outside`` where no plan range is open).

The planners and the flusher are threads of their own, which
``torch.profiler`` records only when told to profile every thread: the
harness's profiler is made a ``repro_torch.core.phases.EveryThreadProfile``
here. The script reads what the harness cannot yet: once
``summarize_profile`` records every thread and labels the gaps by the
program's ranges, it has no more to do.

``--micro 1`` times, on the host, what the phase clock adds to one plan:
its six phases and the fold into the registry with the profiler off; with
a profiler recording the timing thread; and on a thread the profiler does
not record (as the planners' threads are under the harness's profiler),
alone and beside busy threads. Beside them, what one ``record_function``
range costs on such a thread, which the phases no longer open there.

``--vlm 1`` times, on the host, ``Corpus.vlm_answer``'s two paths at
N = 2^23 rows over match lists and requested ids of several sizes: the
dense mask and the binary search, each alone, the whole call at the
KV-batch sample's 32 ids, and the once-a-node check of a list's order;
beside each pair, the path the size rule picks.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

PHASE_ORDER = ("vlm_answer", "calibration", "mlp", "embed")
STEP_US = 10.0           # resolution of the gap split


def _open(sorted_starts, sorted_ends, t):
    return (np.searchsorted(sorted_starts, t, "right")
            - np.searchsorted(sorted_ends, t, "right"))


def split_gaps(prof, mark_pc, t0, t1, requests, launches) -> dict:
    """The harness's idle-gap labels (``harness.summarize_profile``'s rule)
    and the ``planner_host`` gaps split by the program's open phase; all on
    the trace's clock, in seconds."""
    from torch.autograd import DeviceType

    from semhist_bench.harness import _union_s

    dev, ranges, mark_us = [], {}, None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        ours = e.name.startswith(("planner.", "coalescer."))
        if e.device_type == DeviceType.CUDA:
            # a range that launched kernels is also a device-side
            # annotation over them: not device work
            if not ours:
                dev.append((a, b))
        elif e.name == "bench.mark":
            mark_us = a
        elif ours:
            ranges.setdefault(e.name, []).append((a, b))
    shift = (mark_us or 0.0) + (t0 - mark_pc) * 1e6
    win = (t1 - t0) * 1e6
    iv = np.clip(np.asarray(dev, np.float64).reshape(-1, 2) - shift, 0, win)

    def host(pairs):
        arr = np.asarray(pairs, np.float64).reshape(-1, 2)
        return np.sort((arr[:, 0] - t0) * 1e6), np.sort((arr[:, 1] - t0) * 1e6)

    spans = {"plan": host([(r.start, r.end) for r in requests if r.done]),
             "coal": host([c for r in requests for c in r.coal]),
             "probe": host([(a, b) for a, b, _ in launches])}
    prog = {}
    for name, pairs in ranges.items():
        arr = np.asarray(pairs, np.float64) - shift
        prog[name] = (np.sort(arr[:, 0]), np.sort(arr[:, 1]))
    if len(iv):
        iv = iv[np.argsort(iv[:, 0])]
        ends = np.maximum.accumulate(iv[:, 1])
        edges = [(0.0, iv[0, 0])] + [(ends[i], iv[i + 1, 0])
                                      for i in range(len(iv) - 1)
                                      if iv[i + 1, 0] > ends[i]]
        edges.append((ends[-1], win))
    else:
        edges = [(0.0, win)]
    labels: dict[str, float] = {}
    split = dict.fromkeys(PHASE_ORDER + ("rest", "outside"), 0.0)
    empty = (np.empty(0), np.empty(0))
    for a, b in edges:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        if _open(*spans["probe"], mid):
            label = "probe_host"
        elif _open(*spans["plan"], mid) > _open(*spans["coal"], mid):
            label = "planner_host"
        elif _open(*spans["coal"], mid):
            label = "coalescer_window"
        else:
            label = "no_request"
        labels[label] = labels.get(label, 0.0) + (b - a) / 1e6
        if label != "planner_host":
            continue
        t = np.arange(a, b, STEP_US) + 0.5 * STEP_US
        t = t[t < b]
        w = np.full(len(t), STEP_US)
        if len(t):
            w[-1] = b - (t[-1] - 0.5 * STEP_US)
        left = np.ones(len(t), bool)
        for ph in PHASE_ORDER:
            hit = left & (_open(*prog.get(f"planner.{ph}", empty), t) > 0)
            split[ph] += float(w[hit].sum()) / 1e6
            left &= ~hit
        in_plan = left & (_open(*prog.get("planner.wall", empty), t) > 0)
        split["rest"] += float(w[in_plan].sum()) / 1e6
        split["outside"] += float(w[left & ~in_plan].sum()) / 1e6
    return {"busy_s": _union_s(iv), "window_s": win / 1e6,
            "labels": labels, "planner_host_split": split,
            "ranges": {k: [len(v), float(np.sum(np.subtract(
                [b for _, b in v], [a for a, _ in v]))) / 1e6]
                for k, v in sorted(ranges.items())}}


def probe_kernels(prof, pattern) -> tuple[float, int]:
    """Device seconds of the probe's kernels and the merges kept."""
    from torch.autograd import DeviceType

    secs, merges = 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = pattern.search(e.name)
        if m:
            secs += (e.time_range.end - e.time_range.start) / 1e6
            merges += m.group(1) == "merge_kernel"
    return secs, merges


def run(args) -> dict:
    from repro_torch.core.phases import EveryThreadProfile
    from semhist_bench import harness

    torch.profiler.profile = EveryThreadProfile
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    seen: dict = {}
    bench["per_layer"].append({"name": "spans.capture", "unit": "-",
                               "workloads": [args.workload]})
    load = harness.load_reader

    def capture(ctx):
        seen["ctx"] = ctx          # reads no metric

    def load_reader(bench_dir, name):
        return capture if name == "spans.capture" else load(bench_dir, name)

    summarize = harness.summarize_profile

    def summarize_profile(prof, mark_pc, t0, t1, requests, launches):
        seen["gaps"] = split_gaps(prof, mark_pc, t0, t1, requests, launches)
        seen["kernels"] = probe_kernels(prof, harness.PROBE_KERNELS)
        return summarize(prof, mark_pc, t0, t1, requests, launches)

    harness.load_reader = load_reader
    harness.summarize_profile = summarize_profile
    result, checks = harness.run_cell(
        ROOT / "semhist_bench", bench, cell, seed=args.seed,
        seconds=args.seconds, trace=True, device="cuda", t_start=T_START)
    ctx = seen["ctx"]
    c = ctx.counters
    ok = [r for r in ctx.requests if r.ok]
    harness_self = sum(r.end - r.start - r.coal_s for r in ok)
    program_self = (c.get("planner.wall_ns", 0)
                    - c.get("planner.probe_ns", 0)) / 1e9
    dev_s, merges = seen["kernels"]
    launches = len(ctx.launches)
    fired = c.get("coalescer.probes_fired", 0)
    timed = c.get("probe.device_timed", 0)
    return {
        "workload": args.workload, "seed": args.seed,
        "correct": result["correct"], "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "plans": {"harness_ok": len(ok),
                  "harness_filters": sum(len(r.nodes) for r in ok),
                  "program": c.get("planner.plans", 0),
                  "vlm_answer_calls": c.get("planner.vlm_answer_calls"),
                  "vlm_answer_dense": c.get("planner.vlm_answer_dense")},
        "self_s": {"program": program_self, "harness": harness_self,
                   "ratio": program_self / harness_self
                   if harness_self else None},
        "probe_ms": {"program": c.get("probe.device_ns", 0) / 1e6 / timed
                     if timed else None,
                     "profiler": dev_s * 1e3 / launches if launches else None,
                     "launches": launches, "probes_fired": fired,
                     "probes_timed": timed,
                     "merges_kept": merges},
        "counters": {k: v for k, v in c.items()
                     if k.startswith(("planner.", "probe.", "coalescer."))},
        "gaps": seen["gaps"],
        "breakdown": result.get("breakdown"),
        "device": result["device"],
    }


def micro(n: int = 20000, n_busy: int = 200, busy: int = 4) -> dict:
    """Microseconds a plan the phase clock costs: unbound (no hub), bound
    with the profiler off, bound on the thread the profiler records, and
    bound on a thread it does not record, alone and beside ``busy``
    threads that spin in the interpreter; and what one ``record_function``
    range costs on such a thread, beside a no-op context."""
    import contextlib
    import threading

    from repro_torch.core import phases
    from repro_torch.obs import ObsHub

    hub = ObsHub()

    def plan(bound: bool):
        if bound:
            clock, prev = phases.PhaseClock(), phases.current()
            phases.bind(clock)
        with phases.phase("wall"):
            with phases.phase("embed", cpu=True):
                pass
            with phases.phase("mlp"):
                pass
            with phases.phase("calibration", cpu=True):
                with phases.phase("vlm_answer"):
                    pass
            with phases.phase("probe"):
                pass
        if bound:
            phases.bind(prev)
            hub.planner_phases(clock)

    def timed(body, reps: int) -> float:
        for _ in range(min(reps, 200)):
            body()
        t = time.perf_counter_ns()
        for _ in range(reps):
            body()
        return (time.perf_counter_ns() - t) / reps / 1e3

    def on_thread(body, reps: int) -> float:
        got = []
        t = threading.Thread(target=lambda: got.append(timed(body, reps)))
        t.start()
        t.join()
        return got[0]

    def rf():
        with torch.profiler.record_function("planner.x"):
            pass

    def noop():
        with contextlib.nullcontext():
            pass

    @contextlib.contextmanager
    def spinning():
        stop = threading.Event()

        def spin():
            while not stop.is_set():
                pass

        ts = [threading.Thread(target=spin) for _ in range(busy)]
        for t in ts:
            t.start()
        try:
            yield
        finally:
            stop.set()
            for t in ts:
                t.join()

    out = {"unbound_us": timed(lambda: plan(False), n),
           "bound_us": timed(lambda: plan(True), n)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):     # as the harness's
        out["bound_profiled_us"] = timed(lambda: plan(True), n)
        out["bound_unprofiled_thread_us"] = on_thread(lambda: plan(True), n)
        out["range_unprofiled_thread_us"] = on_thread(rf, n)
        out["noop_unprofiled_thread_us"] = on_thread(noop, n)
        with spinning():
            out["busy"] = {
                "threads": busy,
                "bound_unprofiled_thread_us": on_thread(
                    lambda: plan(True), n_busy),
                "range_unprofiled_thread_us": on_thread(rf, n_busy),
                "noop_unprofiled_thread_us": on_thread(noop, n_busy)}
    if torch.cuda.is_available():
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        for _ in range(1000):
            a.record()
            b.record()
            b.synchronize()
            a.elapsed_time(b)
        out["event_pair_us"] = (time.perf_counter_ns() - t) / 1000 / 1e3
    return out


def vlm_paths(n: int = 1 << 23) -> dict:
    """Milliseconds of ``Corpus.vlm_answer``'s dense mask and binary
    search at ``n`` rows (best of several), for contiguous match lists of
    m rows and k sorted requested ids, with the size rule's pick; the whole
    call at k = 32; and the check of one list's order."""
    from repro_torch.core import synthetic as syn

    rng = np.random.default_rng(0)

    def best(f, reps):
        out = float("inf")
        for _ in range(reps):
            t = time.perf_counter_ns()
            f()
            out = min(out, time.perf_counter_ns() - t)
        return out / 1e6

    rows = []
    for m in (n, n // 3, n // 10, n // 40, n // 200, 0):
        lo = int(rng.integers(0, n - m + 1))
        matches = np.arange(lo, lo + m, dtype=np.int64)
        for k in (32, 1024, 32768, 1 << 20, n):
            ids = (np.arange(n) if k == n
                   else np.sort(rng.choice(n, k, replace=False)))
            reps = 3 if k >= 1 << 20 else 20
            assert np.array_equal(syn.dense_truth(matches, ids, n),
                                  syn.lookup_truth(matches, ids))
            d = best(lambda: syn.dense_truth(matches, ids, n), reps)
            s = best(lambda: syn.lookup_truth(matches, ids), reps)
            rows.append({"m": m, "k": k, "dense_ms": d, "lookup_ms": s,
                         "rule": "lookup" if syn._lookup_wins(k, m, n)
                         else "dense"})
    picked = [r["lookup_ms"] if r["rule"] == "lookup" else r["dense_ms"]
              for r in rows]
    worst = max(p / min(r["dense_ms"], r["lookup_ms"])
                for p, r in zip(picked, rows))
    tree = {0: syn.Concept(0, 0, None, [], np.zeros(1), "root",
                           np.arange(n, dtype=np.int64))}
    corpus = syn.Corpus("timing", 0, np.empty((n, 0), np.float32),
                        np.zeros(n, np.int64), tree, 0.0, 0.08,
                        np.random.default_rng(0))
    sample = np.sort(rng.choice(n, 32, replace=False))
    check = best(lambda: corpus._sorted_matches.clear()
                 or corpus._sorted(0, tree[0].leaf_image_ids), 5)
    call = best(lambda: corpus.vlm_answer(0, sample, seed=1), 200)
    return {"n": n, "rows": rows, "rule_worst_over_best": worst,
            "vlm_answer_32_ms": call, "order_check_ms_at_m_n": check}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="wildlife-8m.open-mixed")
    ap.add_argument("--seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--micro", type=int, choices=(0, 1), default=0)
    ap.add_argument("--vlm", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = micro() if args.micro else vlm_paths() if args.vlm else run(args)
    text = json.dumps(out, default=float)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

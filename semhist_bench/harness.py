"""One cell of the benchmark, end to end, in one process.

``run_cell`` reads the cell's entry in ``BENCHMARK.json`` and finds
everything else by name: the configuration in ``configs/<config>.json``,
the traffic mix in ``traffic/<traffic>.json``, the limits of the numbers
compared in ``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<name>.py`` (or ``metrics/<name up to its first dot>.py``, the
one reader of a quantity split by the end-to-end metric it moves).

A run: draw the corpus, the MLP's weights and the KV-batch sample from the
seed; let the port build its stack on them; warm up with plans of the
mix's own shapes; then drive the window (an open loop of arrivals due on
a schedule, or closed-loop sessions), wait for every plan due in it, read
the metrics, free the program's state, and judge every plan due in the
window against the plain reference (``reference.py``), which regenerates
the corpus itself, and what the KV-batch VLM produced against the plain
reference of the VLM the configuration names (``vlmcheck.py``,
``vlm/<vlm>.py``), which draws its weights and inputs again.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from semhist_bench import corpus, reference, traffic, vlmcheck
from semhist_bench.inputs import build_inputs, merge, sample_rows
from semhist_bench import stack as stack_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LATE_S = 60.0            # how long past the window a due plan may take
WARM_SEQUENTIAL = 8      # warm-up plans run one at a time (narrow probes)
OPEN_WORKERS = 128       # threads an open loop may have planning at once
FAILED_MS = 1e12         # the latency a failed plan counts with
PREFAULT_THREADS = 8     # threads touching the host copy's pages
PROBE_KERNELS = re.compile(r"\b(probe_kernel|probe_wide_kernel|merge_kernel)\b")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(bench_dir: pathlib.Path, name: str):
    """The reader of a per-layer metric: ``read(ctx) -> float | None``."""
    for stem in (name, name.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"semhist_bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} in "
                            f"{bench_dir / 'metrics'}")


@dataclasses.dataclass
class Trace:
    """What the device trace of the window says."""

    window_s: float
    busy_s: float
    kernels: dict            # name -> (device seconds, records)
    gaps: dict               # what the host did -> idle device seconds


@dataclasses.dataclass
class Context:
    """What a per-layer reader may read."""

    requests: list           # the window's requests (stack.Request)
    window_s: float
    launches: list           # (t0, t1, B) of the window's probes
    counters: dict           # registry counters' increase over the window
    hists: dict              # registry histograms' window values
    index: dict | None       # the index's scan counters' increase
    rows: int
    dim: int
    trace: Trace | None
    # set-up phase -> host seconds, as ``run_cell`` prints them
    setup: dict = dataclasses.field(default_factory=dict)


def _union_s(iv: np.ndarray) -> float:
    if not len(iv):
        return 0.0
    iv = iv[np.argsort(iv[:, 0])]
    total, cur0, cur1 = 0.0, iv[0, 0], iv[0, 1]
    for a, b in iv[1:]:
        if a > cur1:
            total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    return float(total + cur1 - cur0) / 1e6


def summarize_profile(prof, mark_pc: float, t0: float, t1: float,
                      requests: list, launches: list) -> Trace:
    """Device busy time and device time by kernel over the window [t0, t1]
    (host clock), and the idle gaps named by what the host was doing in
    them, from the harness's own spans: a probe running (``probe_host``),
    a plan outside the coalescer (``planner_host``), plans only waiting on
    the coalescer (``coalescer_window``), or none (``no_request``).
    ``mark_pc`` is the host clock at the trace's ``bench.mark`` range."""
    from torch.autograd import DeviceType

    dev, kernels, mark_us = [], {}, None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (b - a) / 1e6
            k[1] += 1
        elif e.name == "bench.mark":
            mark_us = a
    # the trace's clock, in microseconds from the window's start
    shift = (mark_us or 0.0) + (t0 - mark_pc) * 1e6
    win = (t1 - t0) * 1e6
    iv = np.clip(np.asarray(dev, np.float64).reshape(-1, 2) - shift, 0.0, win)
    busy = _union_s(iv)

    def on_clock(pairs):
        arr = np.asarray(pairs, np.float64).reshape(-1, 2)
        return np.sort((arr[:, 0] - t0) * 1e6), np.sort((arr[:, 1] - t0) * 1e6)

    spans = {
        "plan": on_clock([(r.start, r.end) for r in requests if r.done]),
        "coal": on_clock([iv_ for r in requests for iv_ in r.coal]),
        "probe": on_clock([(a, b) for a, b, _ in launches]),
    }

    def open_at(kind, t):
        s, e = spans[kind]
        return int(np.searchsorted(s, t, "right")
                   - np.searchsorted(e, t, "right"))

    if len(iv):
        iv = iv[np.argsort(iv[:, 0])]
        ends = np.maximum.accumulate(iv[:, 1])
        edges = [(0.0, iv[0, 0])] + [(ends[i], iv[i + 1, 0])
                                      for i in range(len(iv) - 1)
                                      if iv[i + 1, 0] > ends[i]]
        edges.append((ends[-1], win))
    else:
        edges = [(0.0, win)]
    gaps: dict[str, float] = {}
    for a, b in edges:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        if open_at("probe", mid):
            label = "probe_host"
        elif open_at("plan", mid) > open_at("coal", mid):
            label = "planner_host"
        elif open_at("coal", mid):
            label = "coalescer_window"
        else:
            label = "no_request"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return Trace(window_s=t1 - t0, busy_s=busy,
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 gaps=gaps)


def end_to_end(reqs: list, t_end: float, seconds: float,
               setup_s: float) -> dict:
    """The end-to-end values a run can report. Latency runs from when a
    plan was due to when ``plan_query`` returned, over every plan of the
    window; one that failed or never returned counts as missing every
    limit. The rate counts the plans completed by the window's end over
    the window's seconds."""
    lat = np.asarray([(r.end - r.due) * 1e3 if r.ok else FAILED_MS
                      for r in reqs], np.float64)
    return {
        "setup_s": setup_s,
        "plan_p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
        "plan_p95_ms": float(np.percentile(lat, 95)) if len(lat) else None,
        "plans_per_s": sum(1 for r in reqs if r.ok and r.end <= t_end)
        / seconds,
    }


class HostCopy:
    """The store's host copy, for the port's ``Corpus``. Its pages are
    touched by ``PREFAULT_THREADS`` threads as soon as the shape is known,
    while the card draws the inputs, so the copy itself runs into memory
    that is already mapped (on the card's host a page-faulting copy of
    38.65 GB took 23 s, a prefaulted one 5 s)."""

    def __init__(self, shape: tuple, device: torch.device):
        self.out = np.empty(shape, np.float32)
        n = shape[0]
        k = PREFAULT_THREADS if device.type == "cuda" else 0
        self._threads = [threading.Thread(
            target=self.out[i * n // k:(i + 1) * n // k].fill, args=(0.0,))
            for i in range(k)]
        for t in self._threads:
            t.start()

    def fill_from(self, store: torch.Tensor) -> np.ndarray:
        for t in self._threads:
            t.join()
        host = torch.from_numpy(self.out)
        step = corpus.GEN_ROWS
        for i in range(0, store.shape[0], step):
            host[i:i + step].copy_(store[i:i + step])
        return self.out


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drive_open(stk, coal, queries, offsets, t0):
    reqs = [stack_mod.Request(q, s) for q, s in queries]
    pool = ThreadPoolExecutor(max_workers=OPEN_WORKERS)
    futs = []
    for r, off in zip(reqs, offsets):
        r.due = t0 + float(off)
        delay = r.due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futs.append(pool.submit(stack_mod.serve, stk, coal, r))
    return reqs, pool, futs


def drive_closed(stk, coal, stream, sessions, t_end):
    reqs, lock = [], threading.Lock()

    def session():
        while True:
            with lock:
                if time.perf_counter() >= t_end:
                    return
                q, s = next(stream)
                r = stack_mod.Request(q, s)
                reqs.append(r)
            r.due = time.perf_counter()
            stack_mod.serve(stk, coal, r)

    threads = [threading.Thread(target=session, daemon=True)
               for _ in range(sessions)]
    for t in threads:
        t.start()
    return reqs, threads


def warm_up(stk, coal, queries, sessions):
    """The mix's shapes before the window: plans one at a time, then as
    many sessions at once as the window will have."""
    for q, s in queries[:WARM_SEQUENTIAL]:
        stack_mod.serve(stk, coal, stack_mod.Request(q, s))
    rest = iter(queries[WARM_SEQUENTIAL:])
    lock = threading.Lock()

    def session():
        while True:
            with lock:
                nxt = next(rest, None)
            if nxt is None:
                return
            r = stack_mod.Request(*nxt)
            stack_mod.serve(stk, coal, r)
            if r.error:
                raise RuntimeError(f"warm-up plan failed: {r.error}")

    with ThreadPoolExecutor(max_workers=sessions) as pool:
        for f in [pool.submit(session) for _ in range(sessions)]:
            f.result()


def program_plans(reqs: list, n: int) -> tuple[list, reference.Plans, int]:
    """The judged queries and what the program planned for them; a
    request that raised, never returned or left no MLP thresholds is
    missing."""
    good, spec, avg, count, order = [], [], [], [], []
    missing = 0
    for r in reqs:
        sp = np.concatenate(r.spec) if r.spec else np.empty(0)
        if not r.ok or r.order is None or len(sp) != len(r.nodes) \
                or sorted(r.order) != sorted(r.nodes):
            missing += 1
            continue
        good.append((r.nodes, r.qseed))
        spec.extend(sp)
        avg.extend(r.thr[n_] for n_ in r.nodes)
        count.extend(int(round(r.sel[n_] * n)) for n_ in r.nodes)
        order.append([r.nodes.index(n_) for n_ in r.order])
    spec = np.asarray(spec, np.float64)
    avg = np.asarray(avg, np.float64)
    plans = reference.Plans(spec=spec, kvb=2.0 * avg - spec, avg=avg,
                            count=np.asarray(count, np.int64), order=order)
    return good, plans, missing


def run_cell(bench_dir: pathlib.Path, bench: dict, cell: dict, *, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             overrides: dict | None = None, fault=None
             ) -> tuple[dict, dict]:
    """One run of ``cell``: (the result line's object without ``checks``,
    the numbers compared with their limits). ``overrides`` shrinks the
    configuration (the CPU tests); ``fault(stack)`` breaks the program
    under the timed path (the tests of the check)."""
    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json")
                     .read_text())
    cfg = merge(cfg, overrides or {})
    mix = traffic.load_mix(bench_dir / "traffic" / f"{cell['traffic']}.json")
    limits = json.loads((bench_dir / "limits" / f"{cell['name']}.json")
                        .read_text())
    name = cell["name"]
    e2e = [m["name"] for m in bench["end_to_end"] if applies(m, name)]
    readers = [(m["name"], m["unit"], load_reader(bench_dir, m["name"]))
               for m in bench["per_layer"] if trace and applies(m, name)]
    dev = torch.device(device)
    kv = cfg["kvbatch"]
    vlm_ref = vlmcheck.reference_module(bench_dir, str(kv["vlm"]))
    vlmcheck.check_layout(vlm_ref, bool(kv.get("smoke", False)),
                          stack_mod.vlm_layout(stack_mod.port_vlm(kv).cfg))

    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    copy = HostCopy((int(cfg["rows"]), int(cfg["dim"])), dev)
    tree, store, params, sample = build_inputs(cfg, seed, dev)
    # the VLM reference's rows, taken before the program holds the store
    sample_embs = sample_rows(store, sample)
    sync(dev)
    phases["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    host = copy.fill_from(store)
    del copy
    phases["host_copy"] = time.perf_counter() - t
    t = time.perf_counter()
    spans = stack_mod.Spans()
    stk = stack_mod.build(cfg, tree, store, host, params, sample, seed,
                          spans)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()     # set-up's transients
    phases["stack"] = time.perf_counter() - t
    # part of the stack's: the KV-batch VLM's weights, prefill and press
    phases["vlm_build"] = stk.kvstore.build_s
    # the decode recorder patches the program's module until unwrapped
    try:
        if fault is not None:
            fault(stk)
        coal = stack_mod.CoalescerSpan(stk.coalescer)
        sessions = int(mix.get("sessions", stk.coalescer.cfg.max_batch))
        warm = traffic.QueryStream(tree, mix, seed, purpose=13).take(
            int(mix.get("warmup_queries", 64)))
        t = time.perf_counter()
        warm_up(stk, coal, warm, sessions)
        sync(dev)
        phases["warm_up"] = time.perf_counter() - t
        print("[bench] set-up seconds " + json.dumps(
            {k: round(v, 3) for k, v in phases.items()}), file=sys.stderr)
        # keep set-up's objects out of the cyclic collector for the window, as
        # a long-running server does: a full collection over them stalled
        # every thread for some 130 ms twice a window
        gc.collect()
        gc.freeze()

        # the window
        reg = stk.obs.registry
        snap0 = reg.snapshot()["counters"]
        hist_names = ("serve.queue_wait_ms",)
        hist0 = {h: reg.histogram(h).count for h in hist_names}
        idx0 = stk.index.stats() if stk.index is not None else None
        spans.launches.clear()
        stream = traffic.QueryStream(tree, mix, seed)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            with torch.profiler.record_function("bench.mark"):
                mark_pc = time.perf_counter()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        t_end = t0 + seconds
        if mix["loop"] == "open":
            offsets = traffic.open_schedule(mix, seconds, seed)
            reqs, pool, futs = drive_open(stk, coal, stream.take(len(offsets)),
                                          offsets, t0)
            wait(futs, timeout=max(0.0, t_end + LATE_S - time.perf_counter()))
            pool.shutdown(wait=False, cancel_futures=True)
        else:
            reqs, threads = drive_closed(stk, coal, stream, sessions, t_end)
            for t in threads:
                t.join(timeout=max(0.0, t_end + LATE_S - time.perf_counter()))
        sync(dev)
        t_done = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        gc.unfreeze()
        idle = [r for r in reqs if not r.done]

        ok = [r for r in reqs if r.ok]
        failed = len(reqs) - len(ok)
        metrics: dict[str, dict] = {}
        if not trace:
            values = end_to_end(reqs, t_end, seconds, setup_s)
            units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
            for m in e2e:
                if values.get(m) is not None:
                    metrics[m] = {"value": values[m], "unit": units[m]}
        snap1 = reg.snapshot()["counters"]
        counters = {k: snap1[k] - snap0.get(k, 0) for k in snap1}
        hists = {h: reg.histogram(h).values()[hist0[h]:] for h in hist_names}
        idx = None
        if idx0 is not None:
            idx1 = stk.index.stats()
            idx = {k: idx1[k] - idx0[k] for k in ("probes", "launches",
                                                    "rows_scanned",
                                                    "rows_full_equiv")}
        tr = (summarize_profile(prof, mark_pc, t0, t_done, reqs,
                                spans.launches)
              if prof is not None else None)
        ctx = Context(requests=reqs, window_s=seconds,
                      launches=list(spans.launches), counters=counters,
                      hists=hists, index=idx, rows=int(store.shape[0]),
                      dim=int(store.shape[1]), trace=tr, setup=phases)
        for mname, unit, read in readers:
            v = read(ctx)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": unit}

        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": int(
                           torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0)}
        result = {"correct": False, "attempted": len(reqs), "failed": failed,
                  "metrics": metrics, "device": device_info}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            ops = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:10]
            result["breakdown"] = {
                "device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": sorted(([k, v] for k, v in tr.gaps.items()),
                                    key=lambda kv: -kv[1])[:10]}
        lateness = [r.start - r.due for r in reqs if r.done]
        tail = end_to_end(reqs, t_end, seconds, setup_s)["plan_p95_ms"]
        thirds = np.array_split(np.asarray(
            [(r.end - r.due) * 1e3 for r in reqs if r.ok]), 3)
        print(f"[bench] {name}: {len(reqs)} plans, {failed} failed, "
              f"{len(idle)} unreturned; generator late by up to "
              f"{max(lateness, default=0.0) * 1e3:.3f} ms; p95 from due "
              f"{tail} ms; median ms by third "
              f"of the window {[round(float(np.median(t)), 3) for t in thirds if len(t)]}",
              file=sys.stderr)
        for r in [r for r in reqs if r.error][:3]:
            print(f"[bench] failed plan {r.nodes}: {r.error}", file=sys.stderr)

        good, got, missing = program_plans(reqs, int(tree.n))
        stack_mod.record_cache(stk.kvstore, stk.vlm)
    finally:
        stk.unwrap()

    # free the program's state before the reference runs
    vlm_rec = stk.vlm
    if not idle:
        stk.close()
    del stk, coal, store, host, spans, reqs, ctx, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    vlm_numbers = vlmcheck.judge(vlm_ref, kv, seed, sample_embs, vlm_rec,
                                 dev)
    sync(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[bench] the VLM's reference: {len(vlm_rec.rows)} rows, "
          f"{len(vlm_rec.decodes)} of {vlm_rec.decode_calls} decodes, "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    images = corpus.make_images(tree, seed, dev)
    q = reference.Queries.of(good)
    ref, ref_at_got = reference.solve(tree, images, params, sample, q,
                                      "fp64", extra_thr=got.avg)
    del images
    numbers = reference.judge(q, got, ref, ref_at_got, missing, int(tree.n))
    numbers.update(vlm_numbers)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    result["correct"] = bool(good) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return result, checks


def main(t_start: float, argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_dir = pathlib.Path(__file__).resolve().parent
    bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = run_cell(bench_dir, bench, cell, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark may not import JAX "
              f"or the JAX package", file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

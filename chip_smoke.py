#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failed check exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time and ptxas' register use;
3. each kernel against its plain PyTorch version on the card:
   - probe at N = 2^20 x 1152 with B in {1, 3, 37, 200}, T in {1, 4},
     k in {1, 128}, plus ragged cases: counts equal except for rows whose
     plain distance lies within 1e-5 of a threshold, top-k within 1e-4, and
     a predicate's B = 1 results bitwise equal to its row of a B = 37 batch;
   - assign with C in {32, 512}: >= 99.9% agreement, every disagreement a
     near-tie (score gap < 1e-4);
4. the main path: ``build_stack("wildlife", n_images=2**20)`` on the card and
   ``serve_sequential`` over 5 queries x 3 filters with every estimator,
   with both kernels' launch counters set to 0 just before and read just
   after; each estimator's selectivities are held against a plain recount
   and its median q-error is printed;
5. both kernels held against their plain versions again on the main
   path's own store (the same checks as phase 3), the probe timed at
   B in {37, 200} beside its bound, and one ``{"kernels": [...]}`` line:
   launches on the main path, max error against the plain version, kernel /
   plain / library ms (CUDA events) at the main path's shapes, and the
   bound (bytes or operations over the card's peak rates);
6. the card's name and power limit, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_ROWS = 2**20
DIM = 1152
# Published peaks (dense, no sparsity): device-memory rate in bytes/s and
# fp32 CUDA-core rate in FLOP/s, matched on the name nvidia-smi gives.
PEAKS = [("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12)]

COUNT_TOL = 1e-5     # a count may differ only for rows this close to a thr
TOPK_TOL = 1e-4      # top-k distances, as the Pallas kernel is held
TIE_TOL = 1e-4       # an assignment may differ only on such a score gap


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def peaks(name: str) -> tuple[float, float]:
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    fail(f"no peak rates known for {name!r}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 3


def unit_rows(n, d, gen, dev):
    import torch

    x = torch.randn((n, d), generator=gen, device=dev)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def probe_case(store, preds, thr, k, label, errs):
    """Kernel vs plain on one input; returns (kernel counts, kernel top-k)."""
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref

    kc, kt = ops.cosine_probe_batch(store, preds, thr, k=k)
    k_eff = max(1, min(k, store.shape[0]))
    pc, pt = ref.cosine_probe_batch_ref(store, preds, thr, k_eff)
    torch.cuda.synchronize()
    check(kc.shape == pc.shape and kt.shape == pt.shape,
          f"{label}: shapes {tuple(kc.shape)}/{tuple(kt.shape)} vs "
          f"{tuple(pc.shape)}/{tuple(pt.shape)}")
    dists = 1.0 - preds @ store.T                                 # (B, N)
    near = (torch.abs(dists[:, None, :] - thr[:, :, None]) < COUNT_TOL
            ).sum(dim=-1)                                         # (B, T)
    diff = torch.abs(kc.long() - pc.long())
    check(bool((diff <= near).all()),
          f"{label}: counts differ beyond the near-threshold rows "
          f"(max diff {int(diff.max())}, near {int(near.max())})")
    err = float(torch.max(torch.abs(kt - pt)))
    check(err <= TOPK_TOL, f"{label}: top-k error {err}")
    errs.append(err)
    print(f"  probe {label}: ok (count diffs {int(diff.sum())}, near rows "
          f"{int(near.sum())}, top-k err {err:.2e})", flush=True)
    return kc, kt


def check_probe(dev, gen, errs):
    import torch

    store = unit_rows(MAIN_ROWS, DIM, gen, dev)
    pool = unit_rows(200, DIM, gen, dev)
    # a predicate near a store row, so some distances are small
    pool[1] = store[MAIN_ROWS // 3] + 0.02 * pool[1]
    pool[1] /= torch.linalg.vector_norm(pool[1])
    dists = 1.0 - pool @ store.T
    srt = torch.sort(dists, dim=1).values
    qs = torch.tensor([0.0005, 0.01, 0.3, 0.5], device=dev)
    thr_pool = srt[:, (qs * (MAIN_ROWS - 1)).long()] + 1e-7       # (200, 4)
    del dists, srt
    for b in (1, 3, 37, 200):
        for t in (1, 4):
            for k in (1, 128):
                probe_case(store, pool[:b].contiguous(),
                           thr_pool[:b, -t:].contiguous(), k,
                           f"N={MAIN_ROWS} B={b} T={t} k={k}", errs)
    # B = 1 bitwise equal to the same predicate inside a B = 37 batch
    bc, bt = probe_case(store, pool[:37].contiguous(),
                        thr_pool[:37].contiguous(), 128, "B=37 T=4 k=128",
                        errs)
    from repro_torch.kernels.cosine_topk import ops

    for j in (0, 1, 20, 36):
        c1, t1 = ops.cosine_probe(store, pool[j], thr_pool[j], k=128)
        check(torch.equal(c1, bc[j]) and torch.equal(t1, bt[j]),
              f"predicate {j}: B=1 result is not bitwise its B=37 row")
    print("  probe B=1 == row of B=37: bitwise", flush=True)
    # ragged shapes: N not a slab multiple, d not a multiple of 4, k > slab
    for n, d, b, k in ((257, 96, 7, 8), (257, 97, 3, 300), (5000, DIM, 5, 1500),
                       (4096, 768, 130, 128)):
        st = unit_rows(n, d, gen, dev)
        pr = unit_rows(b, d, gen, dev)
        dd = torch.sort(1.0 - pr @ st.T, dim=1).values
        thr = dd[:, [n // 5, n // 2, n - 2]] + 1e-7
        probe_case(st, pr, thr.contiguous(), k, f"N={n} d={d} B={b} k={k}",
                   errs)
    del store


def assign_case(x, cent, label, errs):
    """Kernel vs plain assignment: >= 99.9% agreement, and every
    disagreement a near-tie (score gap < TIE_TOL)."""
    import torch
    from repro_torch.kernels.kmeans import ops, ref

    ka = ops.assign(x, cent).long()
    pa = ref.assign_ref(x, cent).long()
    scores = torch.sum(cent * cent, dim=1)[None, :] - 2.0 * (x @ cent.T)
    gap = torch.abs(scores.gather(1, ka[:, None])
                    - scores.gather(1, pa[:, None]))[:, 0]
    agree = float((ka == pa).float().mean())
    check(agree >= 0.999, f"assign {label}: agreement {agree}")
    worst = float(gap.max())
    check(worst < TIE_TOL, f"assign {label}: disagreement with score gap "
                           f"{worst}")
    errs.append(worst)
    print(f"  assign {label}: ok (agreement {agree:.6f}, "
          f"{int((ka != pa).sum())} near-tie rows, max gap {worst:.2e})",
          flush=True)


def check_assign(dev, gen, errs):
    import torch

    x = unit_rows(MAIN_ROWS, DIM, gen, dev)
    for c in (32, 512):
        ids = torch.randperm(MAIN_ROWS, generator=gen, device=dev)[:c]
        cent = (x[ids] + 0.05 * unit_rows(c, DIM, gen, dev)).contiguous()
        assign_case(x, cent, f"C={c}", errs)
    del x


# ------------------------------------------------------------------ phase 4


def main_path(dev):
    import numpy as np
    import torch
    from repro_torch.core.metrics import q_error, summarize_q_errors
    from repro_torch.core.optimizer import generate_queries
    from repro_torch.kernels.cosine_topk import kernel as ct_kernel
    from repro_torch.kernels.cosine_topk import ref as ct_ref
    from repro_torch.kernels.kmeans import kernel as km_kernel
    from repro_torch.launch.serve import build_stack, serve_sequential

    ct_kernel.launches = 0
    km_kernel.launches = 0
    t0 = time.perf_counter()
    timings = {}
    corpus, estimators = build_stack("wildlife", n_images=MAIN_ROWS,
                                     device=dev, timings=timings)
    queries = generate_queries(corpus, n_queries=5, n_filters=3, seed=0)
    results = serve_sequential(corpus, estimators, queries, seed=0)
    torch.cuda.synchronize()
    launches = {"cosine_topk": ct_kernel.launches,
                "kmeans_assign": km_kernel.launches}
    wall = time.perf_counter() - t0
    print(f"main path: {wall:.1f} s wall; build phases (host clock) "
          + ", ".join(f"{k}={v:.1f}" for k, v in timings.items())
          + f"; launches {launches}", flush=True)
    hist = estimators["specificity"].hist
    check(hist.embeddings.is_cuda and hist.embeddings.shape == (MAIN_ROWS, DIM),
          f"histogram store is {hist.embeddings.device} "
          f"{tuple(hist.embeddings.shape)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    store = hist.embeddings
    n = corpus.images.shape[0]
    for name, res in results.items():
        if name == "oracle":
            continue
        qs, recount = [], 0
        for r in res:
            check(r.vlm_calls > 0 and len(r.plan.filter_order) == 3,
                  f"{name}: empty cascade")
            for node, est in zip(r.plan.filter_order, r.plan.estimates):
                sel = est.selectivity
                check(np.isfinite(sel) and 0.0 <= sel <= 1.0,
                      f"{name}: selectivity {sel}")
                qs.append(q_error(sel, corpus.true_selectivity(node), n))
                if est.threshold is None:
                    continue
                emb = torch.as_tensor(corpus.text_embedding(node, 0),
                                      device=dev)
                thr = torch.tensor([[est.threshold]], dtype=torch.float32,
                                   device=dev)
                pc, _ = ct_ref.cosine_probe_batch_ref(store, emb[None], thr, 1)
                dist = 1.0 - store @ emb
                near = int((torch.abs(dist - thr[0, 0]) < COUNT_TOL).sum())
                got = round(sel * n)
                check(abs(got - int(pc[0, 0])) <= near,
                      f"{name}: count {got} vs plain {int(pc[0, 0])} "
                      f"({near} near-threshold rows)")
                recount += 1
        s = summarize_q_errors(qs)
        print(f"  {name:14s} median q-error {s['median']:.4f} "
              f"(p95 {s['p95']:.4f}, n={s['n']}; {recount} selectivities "
              f"recounted by the plain probe)", flush=True)
    profile_serve(corpus, estimators, queries)
    return corpus, estimators, launches


def profile_serve(corpus, estimators, queries):
    """One more serve pass over the same queries under torch.profiler: the
    host wall time, the device's busy time (the sum of its kernels) and the
    kernels that take it. Launch counts were read before this pass."""
    import contextlib
    import io

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve_sequential

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            serve_sequential(corpus, estimators, queries, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    plans = len(queries) * (len(estimators) - 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"serve pass (profiled): {wall * 1e3:.1f} ms wall for "
          f"{len(queries)} queries x {len(estimators) - 1} estimators "
          f"({wall * 1e3 / plans:.2f} ms per plan + cascade); device busy "
          f"{busy:.2f} ms, idle share "
          + (f"{1 - busy / (wall * 1e3):.4f}" if busy else "not measured"),
          flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:90]}")


# ------------------------------------------------------------------ phase 5


def measure(dev, gen, name_card, corpus, estimators, launches, errs):
    """Both kernels at the main path's shapes on its own store: checked
    against their plain versions as in phase 3, then timed."""
    import numpy as np
    import torch
    from repro_torch.kernels.cosine_topk import kernel as ct_kernel
    from repro_torch.kernels.cosine_topk import ops as ct_ops
    from repro_torch.kernels.cosine_topk import ref as ct_ref
    from repro_torch.kernels.kmeans import ops as km_ops
    from repro_torch.kernels.kmeans import ref as km_ref

    bw, flops = peaks(name_card)

    def bound(nbytes, nops):
        tb, to = nbytes / bw * 1e3, nops / flops * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def probe_cost(b, t, k):
        return (4 * (n * d + b * d + b * t) + 4 * (b * t + b * k),
                2 * n * d * b + n * b * (1 + t))

    spec = estimators["specificity"]
    store = spec.hist.embeddings
    n, d = store.shape
    nodes = corpus.predicate_nodes()[:3]
    embs = np.stack([corpus.text_embedding(x, 0) for x in nodes])
    preds = torch.as_tensor(embs, device=dev)
    thr = torch.as_tensor(spec.model.thresholds(embs)[:, None], device=dev)
    b, t, k = preds.shape[0], 1, 1

    probe_case(store, preds, thr, k, f"main-path store B={b} T={t} k={k}",
               errs["cosine_topk"])
    probe = {
        "ms": time_ms(lambda: ct_ops.cosine_probe_batch(store, preds, thr,
                                                        k=k), 20),
        "kernel_only_ms": time_ms(lambda: ct_kernel.probe_blocks(
            store, preds, thr, kk=k, n_valid=n), 20),
        "plain_ms": time_ms(lambda: ct_ref.cosine_probe_batch_ref(
            store, preds, thr, k), 20),
    }

    def library_chain():
        dist = 1.0 - torch.matmul(preds, store.T)
        (dist[:, None, :] <= thr[:, :, None]).sum(dim=-1)
        torch.topk(dist, k, dim=1, largest=False)

    probe["library_ms"] = time_ms(library_chain, 20)
    p_bytes, p_ops = probe_cost(b, t, k)

    # wider batches (a coalesced serving batch): one store pass per tile of
    # up to 8 predicates, where the Pallas batch kernel reads it once for
    # B <= 128; not on the main path, timed to show what the tiles cost
    for wb in (37, 200):
        wp = unit_rows(wb, d, gen, dev)
        wt = torch.full((wb, 1), 0.5, device=dev)
        wbytes, wops = probe_cost(wb, 1, 1)
        row = {"B": wb, "store_passes": -(-wb // ct_kernel.tile_width(wb)),
               "ms": time_ms(lambda: ct_ops.cosine_probe_batch(
                   store, wp, wt, k=1), 5),
               "plain_ms": time_ms(lambda: ct_ref.cosine_probe_batch_ref(
                   store, wp, wt, 1), 5)}
        row["bound_ms"], row["bound_by"] = bound(wbytes, wops)
        print(f"  probe B={wb}: {row['store_passes']} store passes, "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']})", flush=True)
    del wp, wt

    # the main path's k-means starts from these 32 rows (its seeded draw)
    c = 32
    init = np.random.default_rng(0).choice(n, size=c, replace=False)
    cent = store[torch.as_tensor(init, device=dev)].contiguous()
    assign_case(store, cent, f"main-path store C={c}", errs["kmeans_assign"])
    assign = {
        "ms": time_ms(lambda: km_ops.assign(store, cent), 20),
        "plain_ms": time_ms(lambda: km_ref.assign_ref(store, cent), 20),
        "library_ms": time_ms(lambda: torch.cdist(store, cent).argmin(1), 20),
    }
    a_bytes = 4 * (n * d + c * d) + 4 * n
    a_ops = 2 * n * d * c + n * c

    rows = []
    for name, src, replaces, lib, m, nbytes, nops, shape in (
            ("cosine_topk", "src/repro_torch/csrc/cosine_topk.cu",
             "src/repro/kernels/cosine_topk/kernel.py:153",
             "chain: torch.matmul + compare-sum + torch.topk", probe,
             p_bytes, p_ops, f"N={n} d={d} B={b} T={t} k={k}"),
            ("kmeans_assign", "src/repro_torch/csrc/kmeans_assign.cu",
             "src/repro/kernels/kmeans/kernel.py:31",
             "torch.cdist(x, c).argmin(1)", assign, a_bytes, a_ops,
             f"N={n} d={d} C={c}")):
        bms, by = bound(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(errs[name]), **m,
                     "bound_ms": bms, "bound_by": by, "library_call": lib,
                     "shape": shape})
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {card_line} | torch: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all(["cosine_topk", "kmeans_assign"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"cosine_topk": [], "kmeans_assign": []}
    t0 = time.perf_counter()
    check_probe(dev, gen, errs["cosine_topk"])
    check_assign(dev, gen, errs["kmeans_assign"])
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    corpus, estimators, launches = main_path(dev)
    rows = measure(dev, gen, card_line, corpus, estimators, launches, errs)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

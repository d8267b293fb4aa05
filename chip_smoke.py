#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failed check exits non-zero and prints no result:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build all six CUDA sources from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the build time and ptxas' register
   use; then the repository's ``cuda``-marked tests
   (``pytest -m cuda tests/test_torch_cuda_*.py``, free of JAX) in a
   subprocess: every one must run and pass;
3. each kernel against its plain PyTorch version on the card:
   - probe at N = 2^20 x 1152 with B in {1, 3, 37, 200}, T in {1, 4},
     k in {1, 128}, plus ragged cases (k past a block's rows and past what
     the merge sorts in shared memory): counts equal except for rows whose
     plain distance lies within 1e-5 of a threshold, top-k within 1e-4, a
     predicate's B = 1 results bitwise equal to its row of a B = 37 and a
     B = 200 batch (the full scan at k 8 and 128; the masked and rowmask
     launches at k 1, 8 and 128), and an unaligned buffer bitwise the
     aligned one;
   - the masked probe (ragged n_valid 0, 1, 1023, 1025, N), the rowmask
     probe (masks of density 0.01, 0.5, 0.97 and all dead) at B in
     {1, 3, 37}, T in {1, 4}, k in {1, 128}, and the compound launch (and,
     or; B in {2, 3, 8}; full, ragged n_valid, masked), with the same
     limits; a gathered subset's counts, top-k and compound counts bitwise
     those of the full store with every other row masked;
   - compound predicates of 9, 16 and 100 conjuncts (and, or; full,
     ragged n_valid, masked) on the 2^20 store, with planted rows and
     thresholds in wide gaps: each count equal to the AND/OR of the
     conjuncts' full-scan row sets exactly, and ``count_compound`` at 9;
   - small buffers: masked and rowmask launches at m in {1, 31, 32, 33,
     1023, 1025, 5923, 16384} x k in {1, 64, m} x B in {1, 3, 9}, with
     n_valid and with sparse and dense masks;
   - assign with C in {32, 512}: >= 99.9% agreement, every disagreement a
     near-tie (score gap < 1e-4) (the ``cuda`` tests also hold C in {1, 31,
     33, 100, 511}, the scalar-load path and duplicated centroids);
   - flash attention at the reference kernel test's cases (2e-5 in float32,
     2e-2 in bfloat16), at the bf16 kernel's edges (sq and sk of 200 and
     300, not multiples of its 128-row tiles; sq != sk without the causal
     mask; a window of 50, shorter than one key tile; D 16 and 32), at the
     prefill's S 2880, H 32, Hkv 8, D 128 bf16 on B = 2, and at the
     calibration pass's B 2, S 32;
   - decode at the test's cases (2e-5), an fp8 e4m3 cache (1e-4) and the
     batched prompt decode's B 32, L 1168, Hkv 8, rep 4, bf16 (2e-2), with
     one length for all, ragged per-sequence lengths, lengths that leave
     whole 64-slot work units empty (1, 5, 63, 64, 65, ...), a length on a
     unit boundary and valid = L; kv_valid = [0, 5, L] in float32 and
     bf16, whose empty sequence is a zero row from both versions;
   - every attention output also against the plain version computed in
     float32 without the final rounding: relative Frobenius error <= 1e-2
     and no output row (one head's D values) off by more than 2e-2
     relative, limits that bf16 rounding (about 1e-3) cannot reach but a
     dropped or doubled key tile does;
   - Expected-Attention scores at the test's cases and at the build's
     B 32, S 2880, Hkv 8, rep 4, bf16: rtol 1e-5, and the kept positions
     equal wherever the top-keep is well posed;
4. the main path: ``build_stack("wildlife", n_images=2**20)`` on the card,
   with the KV-batch store at the full width of ``llava-next-8b`` (32
   layers, d 4096, sample 32, rate 0.6: 1152 of 2880 positions kept, as
   the reference's ``build_stack``) and the machinery on, then
   ``serve_sequential`` over 5 queries x 3 filters with every estimator;
   the five serving kernels' launch counters are set to 0 just before and
   read just after (the training backward is phase 7's); every
   assignment must take the tensor-core path and every
   Expected-Attention score the vector path. Prints the build phases
   (``kvstore_s`` among them), peak device memory, the measured
   batched-decode latency and each estimator's median q-error;
   selectivities are held against a plain recount; one more serve
   pass and one more batched decode run under torch.profiler for the
   device's busy time and idle share. Then the KV-
   batch slice on the smoke config twice from the same parameters and
   inputs, kernels on the card and plain versions on the CPU: the answer
   logits agree within 2e-2 (bf16);
   - the index path: ``build_clustered_store`` at K = 512 over the main
     path's store, then the same queries served with ``compound=True``
     through estimators whose histogram carries the index (the main path's
     corpus, specificity model and KV-batch store), ``kth_smallest_
     distance``, ``count_within``, 37- and 200-predicate batches and a
     9-conjunct
     ``count_compound``; counters set to 0 before and read after. Every
     selectivity and prefix selectivity equals the full-scan kernel's
     count, every k-th distance, the batch and the compound counts are
     bitwise the full scan's. Prints the build seconds, the scan
     fraction, the launches (the build's C = 512 assignments: Lloyd's
     iterations + 1) and the wall per plan against the full-scan pass, and
     profiles one more compound pass;
   - the mutable path: ``MutableClusteredStore`` at K = 512 over the same
     store, 2^14 inserts in batches, 2^13 deletes of base and tail rows, a
     background rebuild with probes and a delete while it runs; after every
     step counts, top-k, k-th distance and a compound count through a
     ``SemanticHistogram(index=...)`` are bitwise a fresh kernel scan of
     the live rows. Prints the build and rebuild seconds, the peak device
     memory and the launches (assign: the build's iterations + 1, the
     incremental rebuild's 2 + 1);
   - the concurrent path: ``serve_concurrent`` at 16 planner threads,
     window 4 ms, max_batch 64, a 1024 x 12-bit cache, 64 queries x 3
     filters, 2 passes, the ensemble, on the main path's stores, four
     times: the full scan, the K = 512 index with compound plans, the
     mutable store under 2000 rows/s of ingest (at least one background
     rebuild; every flush checked under the store's lock to be bitwise a
     fresh scan of the live rows and its first predicate probed alone)
     and chaos ("seed=1,fail=0.3,delay=0.2,delay-ms=5,kill-at=3") on the
     index with a 1000 ms deadline and degraded answers. Counts zeroed
     before each run and read after; each run's counters reconcile, no
     query fails, every probe entry point lies on the run's path (no
     ``*_tiled`` at max_batch 64), every coalesced selectivity is bitwise
     the uncoalesced probe of its predicate and every degraded interval
     holds it, pass 2 is all cache hits where nothing mutates, and a
     flush of 9 or more predicates took the wide scan. Prints QPS and the
     registry's request-latency p50/p95/p99, probes against predicates,
     flush sizes, launches by entry point and scan, and the device idle
     share of one profiled concurrent pass beside the sequential one;
     writes the metrics snapshot and one trace a run to a temporary
     directory, and parses them;
5. every kernel held against its plain version again at the main path's
   shapes, timed beside its bound (CUDA events; probe, assign, flash,
   decode and EA also their kernels alone, under torch.profiler), and one
   ``{"kernels": [...]}`` line: launches on the main path, max error
   against the plain version, kernel / plain / library ms and the bound
   (bytes or operations over the card's peak rates). The six masked and
   rowmask entry points and the compound launch have a row each, timed at
   the index's and the hot tail's real shapes (the wrapper by CUDA events
   beside its kernels alone under torch.profiler, at most two kernels a
   call), with the gather's own time. Assign has two rows, the main
   path's C = 32 and the index's C = 512, each beside its chain
   (x @ c.T + argmin), ``torch.cdist(...).argmin(1)``, the earlier design
   (the scalar-load path) and two bounds (the fp32 operations, and the
   bf16 products the kernel issues); EA beside its earlier design and
   ``torch.sum``'s read rate over as many bytes. The probe's rows also
   carry ``concurrent_launches``: their launches over the concurrent
   phase's four runs, and ``sharded_launches``: their launches over the
   sharded phase (the assign row: all its assignments);
6. the model zoo (after phase 5's timings), counts zeroed before each run
   and read after; every model freed before the sharded phase:
   - ``h2o-danube-1.8b`` at full width and depth (24 layers, d 2560,
     32/8 heads, D 80, window 4096; seeded weights drawn on the card):
     ``make_prefill_step`` at B = 2, S = 8192 (past the window: the flash
     kernel's window mask and the ring's roll both run), layer 0's ring
     compressed by ``compress_cache`` at rate 0.6 (EA at D 80, rep 4,
     against the plain scores), then 16 ``make_decode_step`` steps into
     the ring. Prints prefill ms, decode ms a step (CUDA events), the
     launches (flash 24 a prefill, decode 24 a step) and
     ``plain_attention_calls`` (must be 0), peak memory; checks layer 0's
     flash output on its real q, k, v against the plain version on the
     first and last 256 queries, each decode step's layer-0 attention
     against the plain decode (2e-2, bf16), and the prefill's and every
     step's logits against a teacher-forced full forward (0.15, the
     reference test's bf16 tolerance);
   - one full-width layer each, through ``lm.block_apply`` on seeded
     hidden states (B 1, S 2048, then 8 decode steps): ``llama3-405b``
     (16384 wide, 128/8 heads: rep 16, fp8 e4m3 serve cache; EA at rep 16
     on that cache), ``siglip-text-so400m`` (D 72, MHA; B 4),
     ``llava-next-34b`` (rep 7, fp8 cache) and ``deepseek-v2-lite-16b``'s
     MoE layer with MLA (64 experts of 1408, top 6, 2 shared; MLA on the
     plain route, so ``plain_attention_calls`` is positive and printed);
     each layer's flash call and decode steps against the plain versions,
     the MoE dispatch against a direct per-expert sum and MLA's absorbed
     decode against its expanded prefill (float32, 1e-3);
   - ``mamba2-130m`` whole (24 layers, d 768): prefill B 2 x S 4096 and 8
     decode steps (SSD in plain torch, no attention launch), the logits
     against a teacher-forced full forward;
   - every registered smoke config (the ten assigned archs and the paper
     stack) in float32 and bfloat16: a prefill and 2 decode steps through
     the kernels, then the same params and inputs through the plain
     attention, the logits within 1e-4 (float32) and 5e-2 (bfloat16,
     whose kernels round P to bf16);
   - six kernel rows timed at the new shapes (flash D 80 and 72, decode
     D 80 rep 4 bf16 and D 128 rep 16 fp8, EA D 80 and rep 16 fp8) beside
     their bounds, plain versions and library calls;
7. the train phase (after the zoo; counts zeroed before the smollm-360m
   run and read after): ``FlashAttention`` at the training shapes
   (smollm D 64 rep 3; h2o D 80 rep 4 at S 4096, and with its 4096
   window at S 8192; D 128), bf16 and float32: the kernel's output and
   row log-sum-exp against the plain chunked forward (ATTN_TOL; lse 1e-4
   in both dtypes), and in float32 the gradients (the backward kernel)
   against autograd through direct attention (1e-3 relative
   Frobenius); every assigned smoke config in float32, one 2-microbatch
   ``make_train_step`` through the kernels and then through the plain
   route (``sdpa_plain`` under autograd) from one state: flash launches
   exactly one per attention call (attention layers x 2 microbatches x 2
   for remat, for the gradients and again for the step) and backward
   launches one per attention call and microbatch, losses within
   1e-4, gradients within 1e-3 relative, parameters within 1e-5 where
   the clipped gradient is at least 1e-6 and elsewhere within the
   measured gradient gap's bound (the share printed); ``smollm-360m`` at
   full width and depth through ``launch/train.py``'s ``build`` and
   ``execute`` (``--no-smoke --seq 4096 --batch 8 --microbatches 2
   --steps 8``, its data pipeline's step-0 batch every step; bf16
   params, AdamW in float32, remat full): the loss
   down 10% or more and finite, one injected failure retried and the
   retried step bitwise the unfailed one, the runner's step-8 checkpoint
   restored bitwise; step ms (CUDA events), tokens/s, 6 N tokens over
   the step time against the card's bf16 peak (``analysis/roofline.py``),
   peak memory, flash launches a
   step (128: remat runs every forward twice) and backward launches a
   step (64); the replayed step runs
   under ``analysis.cost.CostMode`` (phase 9 reads its count); then the
   flash forward
   with lse at the training shape (B 4, S 4096, 15/5 heads, D 64, bf16)
   beside its bound, the plain forward and SDPA's forward, and the
   backward kernel held to the plain flash backward there (5e-2 relative
   Frobenius a gradient, two calls bitwise equal) and timed beside it,
   its bound and SDPA's backward (two rows of the kernels line);
8. the sharded phase (after the train phase), S = 4 shards of the 2^20
   store on the one card (views of its row blocks), counts zeroed before
   its calls and read after (the unsharded probes it is held to are
   uncounted): the sharded full scan at B = 1, 3, 27 and 200,
   ``count_within``, ``kth_smallest_batch`` at k = N/S + 1 and compound
   and/or of 3 and 9 conjuncts, each bitwise the unsharded kernel probe;
   the same calls through a contiguous sharded index (K = 256 a shard)
   and a boundary-balanced one (global K = 1024, two assignment slices a
   step, the host splitter), with their build seconds, boundary masses
   and per-shard scan fractions; the sharded probes timed beside the
   unsharded ones (B = 1, 3, 200) and one profiled sharded serve pass;
   the sharded mutable store through 2^12 inserts, 2,049 deletes and a
   background rebuild (remainder rows held back), each step bitwise a
   fresh scan; ``serve_concurrent`` over the balanced index through a
   3-replica fleet with 5 ms hedges, then fleet chaos
   ("seed=1,replica-kill=1@3,partition=2@1-40"): the fleet reconciles
   fleet-wide and per replica, no query fails, every answer is bitwise a
   lone unsharded replica's, the kill and the partition fire;
   then the threads still alive and one torch.profiler window (does it
   still see device time?), beside the phase-5 rows whose kernels-alone
   time fell back to CUDA events;
9. the tooling phase (after the sharded phase): three dry-run cells
   through ``launch/dryrun.py`` ``run_cell`` on the meta device
   (``smollm-360m train_4k pod``, ``h2o-danube-1.8b prefill_32k pod``,
   ``llama3-405b decode_32k multipod``), each artifact read back and
   checked, with its per-device bytes, counted FLOPs and bytes, model
   FLOPs, compute and memory terms at the card's peaks
   (``analysis/roofline.py``) and bottleneck; phase 7's smollm-360m step
   (B 8 x S 4096, 2 microbatches, remat full, AdamW) counted on the meta
   device (``analysis/cost.py``) against the measured steady step: the
   two terms, the step over the larger, the model-FLOPs MFU, the
   counted-FLOPs share and the backward's share of the counted bytes (one
   fused op a layer a microbatch, beside the plain chunked backward
   counted alone), beside phase 7's replayed step counted on the
   card under the same mode (its FLOPs less than the meta count by the
   flash forward's and backward's, the kernels' visible (query, key)
   pairs, within 1%: the kernels' ctypes launches are unseen);
   ``two_stage_allreduce`` on the card over 2 pods x 4 data
   shards of one (64, 32) gradient: int8 within 0.02 of 8 g, float32
   the exact sum within float32 rounding, both bitwise the CPU's, the
   wire bytes a device per axis; ``plan_mesh(500, model_parallel=16)``
   (31, 16), and ``elastic_restore`` of phase 7's step-8 checkpoint onto
   ``make_local_mesh``'s placements on the card, bitwise the final state
   (seconds printed);
10. the ``{"kernels": [...]}`` line (phases 5, 6 and 7), the card's name
   and power limit, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_ROWS = 2**20
DIM = 1152
KERNELS = ["cosine_topk", "kmeans_assign", "flash_attention",
           "decode_attention", "expected_attention", "flash_attention_bwd"]

TRAIN_ONLY = ("flash_attention_bwd",)   # launched by the train path alone
CUDA_TESTS = 96      # the cuda-marked tests in tests/test_torch_cuda_*.py
COUNT_TOL = 1e-5     # a count may differ only for rows this close to a thr
TOPK_TOL = 1e-4      # top-k distances, as the Pallas kernel is held
TIE_TOL = 1e-4       # an assignment may differ only on such a score gap
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_kernels.py
REL_FRO, REL_ROW = 1e-2, 2e-2   # attention against float32, whole and per row
FP8_TOL = 1e-4
EA_RTOL = 1e-5
KEEP_TIE = 1e-5      # top-keep compared where keep-th/(keep+1)-th differ more
# the KV-batch path at full width (llava-next-8b, the main path's sample)
SAMPLE, N_PATCH, HEADS, KV_HEADS, HEAD_DIM = 32, 2880, 32, 8, 128
RATE, PROMPT_LEN = 0.6, 6
KEEP = 1152                   # ceil(2880 * (1 - RATE))
CAPACITY = KEEP + 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def peaks(name: str) -> tuple[float, float, float]:
    """(device-memory bytes/s, fp32 CUDA-core FLOP/s, bf16 tensor-core
    FLOP/s) of the card, from ``repro_torch.analysis.roofline.PEAKS`` (the
    published dense rates, matched on the name nvidia-smi gives)."""
    from repro_torch.analysis.roofline import peaks as card_peaks

    try:
        p = card_peaks(name)
    except KeyError:
        fail(f"no peak rates known for {name!r}")
    return p.hbm_bw, p.fp32, p.bf16


def ptxas_summary(log: str) -> list[str]:
    """One line a kernel from nvcc's ``-Xptxas -v`` output: its name
    (demangled where ``c++filt`` is present, template arguments kept,
    parameters dropped), registers, and spills."""
    import shutil

    names, lines, name, spill = [], [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            names.append(name)
            lines.append(f"{line.split(':', 1)[1].strip()}; {spill}")
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True).stdout
        if len(out.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                     for n in out.splitlines()]
    return [f"{n}: {l}" for n, l in zip(names, lines)]


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


def cuda_tests() -> int:
    """The repository's ``cuda``-marked tests (``tests/test_torch_cuda_*.py``,
    which import no JAX) in a subprocess: every one must run and pass.
    Returns the number passed."""
    files = sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "tests").glob("test_torch_cuda_*.py"))
    check(bool(files), "no tests/test_torch_cuda_*.py")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                        "no:cacheprovider", "-m", "cuda", *files], cwd=ROOT,
                       capture_output=True, text=True, timeout=900, env=env)
    lines = r.stdout.strip().splitlines()
    tail = lines[-1] if lines else ""
    passed = re.search(r"(\d+) passed", tail)
    print(f"pytest -m cuda, {len(files)} files: {tail} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(r.returncode == 0 and passed is not None
          and not re.search(r"failed|error|skipped|deselected", tail),
          f"pytest -m cuda: exit {r.returncode}\n{r.stdout[-4000:]}\n"
          f"{r.stderr[-2000:]}")
    return int(passed.group(1))


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
                           f"N={MAIN_ROWS} B={b} T={t} k={k}",
                           errs["cosine_topk"])
    # B = 1 bitwise equal to the same predicate inside a B = 37 and a
    # B = 200 batch: the full scan, and (below) the masked and rowmask
    # launches
    from repro_torch.kernels.cosine_topk import ops

    for b, k in ((37, 128), (200, 128), (200, 8)):
        bc, bt = probe_case(store, pool[:b].contiguous(),
                            thr_pool[:b].contiguous(), k, f"B={b} T=4 k={k}",
                            errs["cosine_topk"])
        for j in (0, 1, 20, 36) + ((100, 199) if b == 200 else ()):
            c1, t1 = ops.cosine_probe(store, pool[j], thr_pool[j], k=k)
            check(torch.equal(c1, bc[j]) and torch.equal(t1, bt[j]),
                  f"predicate {j}: B=1 result is not bitwise its B={b} row "
                  f"(k={k})")
        print(f"  probe B=1 == row of B={b} (k={k}): bitwise", flush=True)
    check_masked(store, pool, thr_pool, gen, errs)
    check_compound_many(store, gen, errs)
    check_small_buffers(dev, gen, errs)
    # ragged shapes: N not a block multiple, d not a multiple of 4, k past a
    # block's rows, and k past what the merge sorts in shared memory
    for n, d, b, k in ((257, 96, 7, 8), (257, 97, 3, 300), (5000, DIM, 5, 1500),
                       (4096, 768, 130, 128), (20000, DIM, 2, 6000)):
        st = unit_rows(n, d, gen, dev)
        pr = unit_rows(b, d, gen, dev)
        dd = torch.sort(1.0 - pr @ st.T, dim=1).values
        thr = dd[:, [n // 5, n // 2, n - 2]] + 1e-7
        probe_case(st, pr, thr.contiguous(), k, f"N={n} d={d} B={b} k={k}",
                   errs["cosine_topk"])
    # an unaligned base: the scalar-load path gives a row the bits of the
    # 16-byte path
    st = unit_rows(3001, DIM, gen, dev)
    pr = unit_rows(3, DIM, gen, dev)
    thr = torch.full((3, 1), 0.97, device=dev)
    a = ops.cosine_probe_batch(st[1:], pr, thr, k=64)
    flat = torch.empty(3000 * DIM + 1, device=dev)
    shifted = flat[1:].view(3000, DIM)
    shifted.copy_(st[1:])
    b = ops.cosine_probe_batch(shifted, pr, thr, k=64)
    check(shifted.data_ptr() % 16 != 0 and torch.equal(a[0], b[0])
          and torch.equal(a[1], b[1]),
          "an unaligned buffer's rows are not bitwise the aligned ones'")
    print("  probe unaligned base == aligned: bitwise", flush=True)
    del store


def entry_of(base, b):
    from repro_torch.kernels.cosine_topk import kernel

    return kernel.entry_name(base, b) if b > 1 else base.replace(
        "_batch", "")


def live_rows(n, n_valid, mask, dev):
    import torch

    live = torch.arange(n, device=dev) < n_valid
    return live if mask is None else live & (mask != 0)


def masked_case(store, preds, thr, k, label, errs, *, n_valid=None,
                mask=None, verbose=True):
    """A masked (``n_valid``) or rowmask (``mask``) launch against its plain
    version, with probe_case's limits; at B = 1 the scalar entry point is
    also bitwise the batched one."""
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref

    n = store.shape[0]
    b = preds.shape[0]
    k_eff = max(1, min(k, n))
    if mask is None:
        base = "cosine_probe_batch_masked"
        kc, kt = ops.cosine_probe_batch_masked(store, n_valid, preds, thr, k=k)
        pc, pt = ref.cosine_probe_batch_masked_ref(store, n_valid, preds, thr,
                                                   k_eff)
    else:
        base = "cosine_probe_batch_rowmask"
        kc, kt = ops.cosine_probe_batch_rowmask(store, mask, preds, thr, k=k)
        pc, pt = ref.cosine_probe_batch_rowmask_ref(store, mask, preds, thr,
                                                    k_eff)
    if b == 1:
        one = (ops.cosine_probe_masked(store, n_valid, preds[0], thr[0], k=k)
               if mask is None else
               ops.cosine_probe_rowmask(store, mask, preds[0], thr[0], k=k))
        check(torch.equal(one[0], kc[0]) and torch.equal(one[1], kt[0]),
              f"{label}: the scalar entry point is not bitwise the batched")
    torch.cuda.synchronize()
    live = live_rows(n, n if n_valid is None else n_valid, mask, store.device)
    dists = 1.0 - preds @ store.T
    near = ((torch.abs(dists[:, None, :] - thr[:, :, None]) < COUNT_TOL)
            & live[None, None, :]).sum(dim=-1)
    diff = torch.abs(kc.long() - pc.long())
    check(bool((diff <= near).all()),
          f"{label}: counts differ beyond the near-threshold rows "
          f"(max diff {int(diff.max())}, near {int(near.max())})")
    fin = torch.isfinite(pt)
    check(torch.equal(fin, torch.isfinite(kt)),
          f"{label}: the kernel's top-k has another number of live rows")
    err = float(torch.max(torch.abs(kt[fin] - pt[fin]))) if fin.any() else 0.0
    check(err <= TOPK_TOL, f"{label}: top-k error {err}")
    errs[entry_of(base, b)].append(err)
    if verbose:
        print(f"  {label}: ok (count diffs {int(diff.sum())}, near rows "
              f"{int(near.sum())}, top-k err {err:.2e})", flush=True)
    return kc, kt


def compound_case(store, preds, thr, mode, label, errs, *, n_valid=None,
                  mask=None):
    """The compound launch against its plain version: the counts may differ
    only by rows within COUNT_TOL of some conjunct's threshold."""
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref

    n = store.shape[0]
    got = int(ops.cosine_compound_count(store, preds, thr, mode=mode,
                                        n_valid=n_valid, mask=mask))
    want = int(ref.cosine_compound_count_ref(store, preds, thr, mode=mode,
                                             n_valid=n_valid, mask=mask))
    live = live_rows(n, n if n_valid is None else n_valid, mask, store.device)
    near = int(((torch.abs(1.0 - preds @ store.T - thr[:, None]) < COUNT_TOL)
                .any(dim=0) & live).sum())
    check(abs(got - want) <= near, f"{label}: count {got} vs plain {want} "
                                   f"({near} near-threshold rows)")
    errs["cosine_compound"].append(float(abs(got - want)))
    print(f"  {label}: ok ({got} rows, plain {want}, near rows {near})",
          flush=True)
    return got


def check_masked(store, pool, thr_pool, gen, errs):
    """The masked, rowmask and compound launches against their plain
    versions on the 2^20 x 1152 store, and a gathered subset bitwise the
    full store with every other row masked."""
    import torch
    from repro_torch.kernels.cosine_topk import ops

    n, dev = store.shape[0], store.device
    for nv in (0, 1, 1023, 1025, n):
        pairs = ((1, 1), (4, 128), (1, 128), (4, 1)) if nv in (1025, n) \
            else ((1, 1), (4, 128))
        for b in (1, 3, 37):
            for t, k in pairs:
                masked_case(store, pool[:b].contiguous(),
                            thr_pool[:b, -t:].contiguous(), k,
                            f"masked n_valid={nv} B={b} T={t} k={k}", errs,
                            n_valid=nv)
    for density in (0.01, 0.5, 0.97, 0.0):
        mask = (torch.rand((n,), generator=gen, device=dev) < density
                ).to(torch.int32)
        for b in (1, 3, 37):
            for t, k in ((1, 1), (4, 128)):
                masked_case(store, pool[:b].contiguous(),
                            thr_pool[:b, -t:].contiguous(), k,
                            f"rowmask density={density} B={b} T={t} k={k}",
                            errs, mask=mask)
    # B = 200 (past the reference's block_b: the B-tiled entry points), and
    # each predicate alone bitwise its row of the batch
    half = (torch.rand((n,), generator=gen, device=dev) < 0.5).to(torch.int32)
    for what, kw in (("masked n_valid=1000001", {"n_valid": 1_000_001}),
                     ("rowmask density=0.5", {"mask": half})):
        for k in (1, 8, 128):
            bc, bt = masked_case(store, pool, thr_pool, k,
                                 f"{what} B=200 T=4 k={k}", errs, **kw)
            for j in (0, 1, 100, 199):
                one = (ops.cosine_probe_masked(store, kw["n_valid"], pool[j],
                                               thr_pool[j], k=k)
                       if "n_valid" in kw else
                       ops.cosine_probe_rowmask(store, kw["mask"], pool[j],
                                                thr_pool[j], k=k))
                check(torch.equal(one[0], bc[j]) and torch.equal(one[1], bt[j]),
                      f"{what} predicate {j}: B=1 is not bitwise its B=200 "
                      f"row (k={k})")
        print(f"  {what}: B=1 == row of B=200 (k 1, 8, 128): bitwise",
              flush=True)
    for mode in ("and", "or"):
        for b in (2, 3, 8):
            for where, kw in (("full", {}), ("n_valid=1025", {"n_valid": 1025}),
                              ("n_valid=600000", {"n_valid": 600_000}),
                              ("mask 0.5", {"mask": half})):
                compound_case(store, pool[:b].contiguous(),
                              thr_pool[:b, 2 + (b % 2)].contiguous(), mode,
                              f"compound {mode} B={b} {where}", errs, **kw)
    # a gathered subset is bitwise the full store with every other row dead
    sub_ids = torch.randperm(n, generator=gen, device=dev)[:100_000]
    sub = store[sub_ids].contiguous()
    mask = torch.zeros((n,), dtype=torch.int32, device=dev)
    mask[sub_ids] = 1
    padded = torch.cat([sub, store[:5000]])
    for b, k in ((3, 128), (37, 1)):
        p, t = pool[:b].contiguous(), thr_pool[:b].contiguous()
        a = ops.cosine_probe_batch(sub, p, t, k=k)
        for c, tk in (ops.cosine_probe_batch_rowmask(store, mask, p, t, k=k),
                      ops.cosine_probe_batch_masked(padded, len(sub), p, t,
                                                    k=k)):
            check(torch.equal(a[0], c) and torch.equal(a[1], tk),
                  f"B={b}: a gathered subset is not bitwise the masked store")
    for mode in ("and", "or"):
        p, t = pool[:3].contiguous(), thr_pool[:3, 3].contiguous()
        check(int(ops.cosine_compound_count(sub, p, t, mode=mode))
              == int(ops.cosine_compound_count(store, p, t, mode=mode,
                                               mask=mask)),
              f"compound {mode}: a subset is not bitwise the masked store")
    print("  gathered subset == masked full store: bitwise (counts, top-k, "
          "compound)", flush=True)


SMALL_M = (1, 31, 32, 33, 1023, 1025, 5923, 16384)   # small-buffer rows
PLANTED = 4096       # rows planted near the compound conjuncts' centre


def check_small_buffers(dev, gen, errs):
    """The masked and rowmask launches on small buffers, where a launch
    takes blocks of fewer rows: m in SMALL_M x k in {1, 64, m} x B in
    {1, 3, 9}, each as a prefix of m live rows (``n_valid``, 5 dead rows
    after it) and with a sparse (a quarter live) and a dense (nine tenths)
    mask over m + 5 rows, with probe_case's limits."""
    import torch

    pool = unit_rows(9, DIM, gen, dev)
    cases = 0
    for m in SMALL_M:
        buf = unit_rows(m + 5, DIM, gen, dev)
        near = buf[m // 2] + 0.05 * pool[0]       # small distances too
        preds = torch.cat([(near / torch.linalg.vector_norm(near))[None],
                           pool[1:]])
        dd = torch.sort(1.0 - preds @ buf[:m].T, dim=1).values
        thr = dd[:, [(m - 1) // 4, (m - 1) // 2]] + 1e-7
        masks = {f"mask {dens}": (torch.rand((m + 5,), generator=gen,
                                             device=dev) < dens
                                  ).to(torch.int32) for dens in (0.25, 0.9)}
        for b in (1, 3, 9):
            p, t = preds[:b].contiguous(), thr[:b].contiguous()
            for k in sorted({1, 64, m}):
                masked_case(buf, p, t, k, f"small m={m} B={b} k={k} "
                            "n_valid", errs, n_valid=m, verbose=False)
                for name, mask in masks.items():
                    masked_case(buf, p, t, k, f"small m={m} B={b} k={k} "
                                f"{name}", errs, mask=mask, verbose=False)
                cases += 3
        print(f"  small buffers m={m}: ok (B 1, 3, 9; k 1, 64, m; n_valid, "
              "masks 0.25 and 0.9)", flush=True)
    print(f"  small buffers: {cases} masked and rowmask launches against "
          "the plain version", flush=True)


def check_compound_many(store, gen, errs):
    """Compound predicates of 9, 16 and 100 conjuncts (more than the 8 of
    one predicate tile), and and or, over all rows, a ragged ``n_valid``
    and a mask, on the 2^20 store: each count equals the AND/OR of the
    conjuncts' full-scan row sets exactly. PLANTED rows are planted around
    a centre at radii that spread their distances, the conjuncts lie near
    the centre, and each threshold is the midpoint of a gap wider than
    2 * COUNT_TOL between adjacent plain distances, so no row lies near a
    threshold: each conjunct's full-scan kernel count equals its plain
    row set's size, and the kernel's compound count must equal the plain
    AND/OR bit for bit. ``SemanticHistogram.count_compound`` agrees at 9."""
    import torch
    from repro_torch.core.histogram import SemanticHistogram
    from repro_torch.kernels.cosine_topk import ops, ref

    n, d, dev = store.shape[0], store.shape[1], store.device
    centre = unit_rows(1, d, gen, dev)
    ids = torch.randperm(n, generator=gen, device=dev)[:PLANTED]
    radius = 0.2 + 1.3 * torch.rand((PLANTED, 1), generator=gen, device=dev)
    rows = centre + radius * unit_rows(PLANTED, d, gen, dev)
    store[ids] = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    preds = centre + 0.3 * unit_rows(100, d, gen, dev)
    preds = preds / torch.linalg.vector_norm(preds, dim=1, keepdim=True)
    dist = ref.cosine_distances(store, preds)                  # (100, n)
    srt = torch.sort(dist, dim=1).values[:, :PLANTED + 1]
    gaps = srt[:, 1:] - srt[:, :-1]
    thr = torch.empty(100, device=dev)
    for j in range(100):       # ranks from a half to 0.95 of the planted
        ok = torch.nonzero(gaps[j] > 2 * COUNT_TOL).flatten()
        target = int(PLANTED * (0.5 + 0.45 * j / 99))
        i = ok[torch.argmin(torch.abs(ok - target))]
        thr[j] = 0.5 * (srt[j, i] + srt[j, i + 1])
    match = dist <= thr[:, None]                               # (100, n)
    near = int((torch.abs(dist - thr[:, None]) < COUNT_TOL).sum())
    check(near == 0, f"compound: {near} rows within {COUNT_TOL} of a "
                     "threshold")
    fc, _ = ops.cosine_probe_batch(store, preds, thr[:, None].contiguous(),
                                   k=1)
    check(torch.equal(fc[:, 0], match.sum(dim=1, dtype=torch.int32)),
          "compound: a conjunct's full-scan kernel count is not its plain "
          "row set's size")
    half = (torch.rand((n,), generator=gen, device=dev) < 0.5
            ).to(torch.int32)
    for b in (9, 16, 100):
        for mode in ("and", "or"):
            hit = match[:b].all(dim=0) if mode == "and" \
                else match[:b].any(dim=0)
            for where, kw in (("full", {}), ("n_valid=600000",
                                             {"n_valid": 600_000}),
                              ("mask 0.5", {"mask": half})):
                live = live_rows(n, kw.get("n_valid", n), kw.get("mask"),
                                 dev)
                want = int((hit & live).sum())
                got = int(ops.cosine_compound_count(
                    store, preds[:b], thr[:b], mode=mode, **kw))
                check(got == want, f"compound {mode} B={b} {where}: {got} "
                                   f"vs the AND/OR of full scans {want}")
                errs["cosine_compound"].append(0.0)
                print(f"  compound {mode} B={b} {where}: {got} rows, the "
                      "AND/OR of full scans exactly", flush=True)
            if b == 9:
                hist = SemanticHistogram(store)
                got = hist.count_compound(preds[:9].cpu().numpy(),
                                          thr[:9].cpu().numpy(), mode=mode)
                check(got == int(hit.sum()),
                      f"count_compound {mode} of 9: {got} vs "
                      f"{int(hit.sum())}")
    del dist, srt, gaps, match


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
    for c in (32, 512, 1024):      # 1024: two slices of the kernel's 512
        ids = torch.randperm(MAIN_ROWS, generator=gen, device=dev)[:c]
        cent = (x[ids] + 0.05 * unit_rows(c, DIM, gen, dev)).contiguous()
        assign_case(x, cent, f"C={c}", errs)
    del x


def close_case(label, got, want, tol, errs, exact=None):
    """Kernel output against the plain version within atol = rtol = tol.
    ``exact``, the plain version in float32 without the final rounding,
    also holds the output's relative Frobenius error to REL_FRO and each
    row's (last axis) relative error to REL_ROW, beside the error that
    rounding ``exact`` to the output's dtype alone makes."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    err = float((g - w).abs().max())
    check(bool(torch.allclose(g, w, atol=tol, rtol=tol)),
          f"{label}: max error {err} beyond atol = rtol = {tol}")
    errs.append(err)
    rel = ""
    if exact is not None:
        def rel_errs(x):
            d = x.float() - exact
            fro = float(torch.linalg.vector_norm(d)
                        / torch.linalg.vector_norm(exact))
            row = float((torch.linalg.vector_norm(d, dim=-1)
                         / torch.linalg.vector_norm(exact, dim=-1)).max())
            return fro, row
        fro, row = rel_errs(got)
        fro0, row0 = rel_errs(exact.to(got.dtype))
        check(fro <= REL_FRO and row <= REL_ROW,
              f"{label}: relative error {fro:.2e} (worst row {row:.2e}) "
              f"against float32, limits {REL_FRO} and {REL_ROW}")
        rel = (f"; against float32: relative {fro:.2e}, worst row "
               f"{row:.2e}, rounding alone {fro0:.2e} / {row0:.2e}")
    print(f"  {label}: ok (max err {err:.2e}, tol {tol}{rel})", flush=True)


def flash_case(q, k, v, label, errs, *, causal=True, window=None):
    from repro_torch.kernels.flash_attention import ops, ref

    close_case(f"flash {label}",
               ops.flash_attention(q, k, v, causal=causal, window=window),
               ref.flash_attention_ref(q, k, v, causal=causal, window=window),
               ATTN_TOL[str(q.dtype).split(".")[-1]], errs,
               exact=ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                             causal=causal, window=window))


def decode_case(q, k, v, valid, label, errs, tol):
    from repro_torch.kernels.decode_attention import ops, ref

    close_case(f"decode {label}", ops.decode_attention(q, k, v, kv_valid=valid),
               ref.decode_attention_ref(q, k, v, kv_valid=valid), tol, errs,
               exact=ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                              kv_valid=valid))


def ea_case(k, v, mu, var, keep, label, errs):
    """Scores within rtol 1e-5; kept positions equal to a top-keep of the
    plain scores in every (batch, kv head) whose keep-th and (keep+1)-th
    scores differ by more than 1e-5 relative."""
    import torch
    from repro_torch.kernels.expected_attention import ops, ref

    got = ops.ea_scores(k, v, mu, var)
    want = ref.ea_scores_ref(k, v, mu, var)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"ea {label}: shape {tuple(got.shape)} or non-finite")
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= EA_RTOL, f"ea {label}: relative error {rel}")
    _, _, idx = ops.compress(k, v, mu, var, keep=keep)
    srt = torch.sort(want.transpose(1, 2).double(), dim=-1, descending=True)
    gap = (srt.values[..., keep - 1] - srt.values[..., keep]) \
        / srt.values[..., keep - 1]                              # (B, Hkv)
    plain = torch.sort(srt.indices[..., :keep], dim=-1).values   # (B,Hkv,keep)
    posed = gap > KEEP_TIE
    same = (plain == idx.transpose(1, 2)).all(dim=-1)
    check(bool(same[posed].all()),
          f"ea {label}: kept positions differ on a well-posed top-keep")
    errs.append(float((got - want).abs().max()))
    print(f"  ea {label}: ok (max rel err {rel:.2e}; kept positions equal "
          f"on {int(posed.sum())} of {posed.numel()} well-posed heads)",
          flush=True)


def check_attention(dev, gen, errs):
    """The three KV-batch kernels at the reference tests' cases and at the
    main path's shapes."""
    import torch

    def rn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    bf = torch.bfloat16
    for B, S, hkv, rep, D, causal, window in (
            (1, 640, 2, 2, 64, True, None), (2, 512, 1, 3, 128, True, 256),
            (1, 384, 2, 1, 64, False, None), (1, 300, 1, 1, 128, True, None)):
        for dt in (torch.float32, bf):
            flash_case(rn(B, S, hkv * rep, D, dtype=dt), rn(B, S, hkv, D, dtype=dt),
                       rn(B, S, hkv, D, dtype=dt),
                       f"B={B} S={S} Hkv={hkv} rep={rep} D={D} causal={causal} "
                       f"window={window} {dt}", errs["flash_attention"],
                       causal=causal, window=window)
    # the bf16 kernel's 128-row q and key tiles: ragged sq and sk, sq != sk,
    # a window shorter than one key tile, and the narrow head sizes
    for B, sq, sk, hkv, rep, D, causal, window in (
            (2, 200, 200, 2, 2, 128, True, None),
            (1, 200, 300, 2, 2, 128, False, None),
            (1, 700, 700, 2, 2, 128, True, 50),
            (1, 300, 300, 2, 2, 16, True, None),
            (1, 300, 300, 2, 2, 32, True, None)):
        flash_case(rn(B, sq, hkv * rep, D, dtype=bf), rn(B, sk, hkv, D, dtype=bf),
                   rn(B, sk, hkv, D, dtype=bf),
                   f"B={B} sq={sq} sk={sk} Hkv={hkv} rep={rep} D={D} "
                   f"causal={causal} window={window} bf16",
                   errs["flash_attention"], causal=causal, window=window)
    for B, S in ((2, N_PATCH), (2, 32)):     # prefill at B = 2; calibration
        flash_case(rn(B, S, HEADS, HEAD_DIM, dtype=bf),
                   rn(B, S, KV_HEADS, HEAD_DIM, dtype=bf),
                   rn(B, S, KV_HEADS, HEAD_DIM, dtype=bf),
                   f"main path B={B} S={S} H={HEADS} Hkv={KV_HEADS} bf16",
                   errs["flash_attention"])

    for B, L, hkv, rep, D, valid in ((2, 1000, 2, 4, 64, 777),
                                     (4, 4096, 1, 2, 128, None),
                                     (1, 300, 4, 1, 32, 5),
                                     (3, 129, 2, 2, 64, 129)):
        decode_case(rn(B, 1, hkv * rep, D), rn(B, L, hkv, D), rn(B, L, hkv, D),
                    valid, f"B={B} L={L} Hkv={hkv} rep={rep} D={D} "
                    f"valid={valid}", errs["decode_attention"],
                    ATTN_TOL["float32"])
    fp8 = torch.float8_e4m3fn
    decode_case(rn(2, 1, 4, 64), rn(2, 500, 2, 64, dtype=fp8, scale=0.25),
                rn(2, 500, 2, 64, dtype=fp8, scale=0.25), 400,
                "fp8 e4m3 cache", errs["decode_attention"], FP8_TOL)
    k = rn(SAMPLE, CAPACITY, KV_HEADS, HEAD_DIM, dtype=bf)
    v = rn(SAMPLE, CAPACITY, KV_HEADS, HEAD_DIM, dtype=bf)
    ragged = torch.randint(1, CAPACITY + 1, (SAMPLE,), generator=gen,
                           device=dev, dtype=torch.int32)
    # per-sequence lengths that leave whole work units (64 slots) empty,
    # end on a unit boundary, or fill the cache
    short = torch.tensor([1, 5, 63, 64, 65, 128, 640, CAPACITY] * 4,
                         dtype=torch.int32, device=dev)[:SAMPLE]
    for valid, label in ((KEEP + 1, "first prompt step"),
                         (KEEP + PROMPT_LEN, "last prompt step"),
                         (ragged, "ragged per-sequence lengths"),
                         (short, "short per-sequence lengths"),
                         (1024, "valid on a unit boundary"),
                         (CAPACITY, "valid = L")):
        decode_case(rn(SAMPLE, 1, HEADS, HEAD_DIM, dtype=bf), k, v, valid,
                    f"main path B={SAMPLE} L={CAPACITY} {label} bf16",
                    errs["decode_attention"], ATTN_TOL["bfloat16"])

    # a sequence with no valid slot: a zero row from the kernel and from
    # the plain version, no NaN; the other rows against the plain version
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    lengths = torch.tensor([0, 5, CAPACITY], dtype=torch.int32, device=dev)
    for dt in (torch.float32, bf):
        q = rn(3, 1, HEADS, HEAD_DIM, dtype=dt)
        k3 = rn(3, CAPACITY, KV_HEADS, HEAD_DIM, dtype=dt)
        v3 = rn(3, CAPACITY, KV_HEADS, HEAD_DIM, dtype=dt)
        got = da_ops.decode_attention(q, k3, v3, kv_valid=lengths)
        want = da_ref.decode_attention_ref(q, k3, v3, kv_valid=lengths)
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"decode kv_valid=[0, 5, L] {dt}: non-finite output")
        check(not bool(got[0].any()) and not bool(want[0].any()),
              f"decode kv_valid=[0, 5, L] {dt}: the empty sequence's row "
              "is not 0")
        close_case(f"decode kv_valid=[0, 5, L={CAPACITY}] {dt} (row 0 is "
                   "0 on both)", got[1:], want[1:],
                   ATTN_TOL[str(dt).split(".")[-1]],
                   errs["decode_attention"])

    for B, S, hkv, rep, D, keep in ((2, 512, 2, 2, 64, 100),
                                    (1, 1000, 4, 1, 32, 128),
                                    (1, 130, 1, 4, 128, 13)):
        for dt in (torch.float32, bf):
            ea_case(rn(B, S, hkv, D, dtype=dt), rn(B, S, hkv, D, dtype=dt),
                    rn(hkv, rep, D, scale=0.2),
                    torch.rand((hkv, rep, D), generator=gen, device=dev) * 0.1,
                    keep, f"B={B} S={S} Hkv={hkv} rep={rep} D={D} {dt}",
                    errs["expected_attention"])
    ea_case(rn(SAMPLE, N_PATCH, KV_HEADS, HEAD_DIM, dtype=bf),
            rn(SAMPLE, N_PATCH, KV_HEADS, HEAD_DIM, dtype=bf),
            rn(KV_HEADS, HEADS // KV_HEADS, HEAD_DIM, scale=0.2),
            torch.rand((KV_HEADS, HEADS // KV_HEADS, HEAD_DIM), generator=gen,
                       device=dev) * 0.1, KEEP,
            f"main path B={SAMPLE} S={N_PATCH} bf16", errs["expected_attention"])


# ------------------------------------------------------------------ phase 4


LAUNCHERS = {"kmeans_assign": "kmeans.kernel",
             "flash_attention_bwd": "flash_attention.backward"}


def kernel_modules() -> dict:
    """name -> the launcher module that holds the kernel's ``launches``."""
    import importlib

    return {name: importlib.import_module(
        f"repro_torch.kernels.{LAUNCHERS.get(name, f'{name}.kernel')}")
        for name in KERNELS}


def main_path(dev):
    import numpy as np
    import torch
    from repro_torch.core.metrics import q_error, summarize_q_errors
    from repro_torch.core.optimizer import generate_queries
    from repro_torch.kernels.cosine_topk import ref as ct_ref
    from repro_torch.launch.serve import build_stack, serve_sequential

    mods = kernel_modules()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    timings = {}
    corpus, estimators = build_stack("wildlife", n_images=MAIN_ROWS,
                                     sample=SAMPLE, device=dev,
                                     timings=timings)
    queries = generate_queries(corpus, n_queries=5, n_filters=3, seed=0)
    results = serve_sequential(corpus, estimators, queries, seed=0)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()
                if name not in TRAIN_ONLY}
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"main path: {wall:.1f} s wall; build phases (host clock) "
          + ", ".join(f"{k}={v:.1f}" for k, v in timings.items())
          + f"; launches {launches}; peak device memory {peak / 2**30:.2f} "
            f"GiB", flush=True)
    kvb = estimators["kvbatch"]
    store = kvb.store
    check(kvb.run_machinery and store.params["embed"].is_cuda
          and store.cfg.name == "llava-next-8b"
          and store.cfg.num_layers == 32 and store.cfg.d_model == 4096,
          f"KV-batch store is {store.cfg.name} on "
          f"{store.params['embed'].device}")
    nb = len(store.sample_ids)      # the unique medoids of the k-means
    check(1 <= nb <= SAMPLE and store.cache_len == KEEP
          and store.cache_capacity == CAPACITY,
          f"KV-batch store: {nb} images, keep {store.cache_len}, capacity "
          f"{store.cache_capacity}")
    for layer in store.cache:
        for t in layer.values():
            check(t.shape == (nb, CAPACITY, KV_HEADS, HEAD_DIM)
                  and bool(torch.isfinite(t).all()),
                  f"compressed cache {tuple(t.shape)} or non-finite")
    machine_s = kvb._machinery_latency()
    check(machine_s > 0, f"machinery latency {machine_s}")
    print(f"KV-batch store: {store.cfg.name}, {nb} images "
          f"x {store.cache_len} of {N_PATCH} positions kept (capacity "
          f"{store.cache_capacity}), {store.bytes_total / 2**30:.3f} GiB "
          f"compressed, build {store.build_s:.2f} s; batched prompt decode "
          f"({kvb.prompt_len} tokens) {machine_s * 1e3:.2f} ms", flush=True)
    hist = estimators["specificity"].hist
    check(hist.embeddings.is_cuda and hist.embeddings.shape == (MAIN_ROWS, DIM),
          f"histogram store is {hist.embeddings.device} "
          f"{tuple(hist.embeddings.shape)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check_paths("main path")

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
                if name in ("kvbatch", "ensemble"):
                    check(est.extra["machine_cpu_s"] == machine_s,
                          f"{name}: estimate carries machinery time "
                          f"{est.extra['machine_cpu_s']}, measured "
                          f"{machine_s}")
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
    seq_profile = profile_serve(corpus, estimators, queries)
    return corpus, estimators, launches, seq_profile


def profiled(fn) -> tuple[float, float, list]:
    """Run ``fn`` once under torch.profiler: (host wall ms, device busy ms
    as the sum of its kernels and copies, the five busiest names)."""
    import contextlib
    import io

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall * 1e3, sum(by_name.values()), top


FELL_BACK: list[str] = []   # kernel_alone_ms labels that took event times


def kernel_alone_ms(fn, label: str, events_ms: float, reps: int = 3,
                    count: bool = False, windows: int = 3,
                    by_name: dict | None = None):
    """Device time of one call's kernels under torch.profiler's
    key_averages: the mean duration of each kernel over ``reps`` runs of
    ``fn``, summed over the kernels (each launched once a call). The
    profiler now and then drops the record of a launch from the ctypes
    libraries, so each kernel's mean over the records it kept is used, not
    a sum over a window; and now and then a whole window keeps no device
    record (in any phase, with no thread of the port alive), so up to
    ``windows`` windows are tried. If none saw device time, says so
    (``FELL_BACK``) and returns the CUDA-event time ``events_ms``. With
    ``count``, returns (ms, the number of kernels a call: the most records
    of one kernel's name over the ``reps`` runs, summed over names, each
    divided by ``reps``). ``by_name``, where given, gets each kernel's mean
    ms under its profiler key."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        kept = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        if kept:
            break
    means = [e.device_time_total / e.count for e in kept]
    if by_name is not None:
        by_name.update({e.key: e.device_time_total / e.count / 1e3
                        for e in kept})
    kernels = sum(-(-e.count // reps) for e in kept)
    if not means:
        FELL_BACK.append(label)
        print(f"  {label}: the profiler saw no device time in {windows} "
              f"windows; kernel alone = the CUDA-event time", flush=True)
        return (events_ms, 0) if count else events_ms
    ms = sum(means) / 1e3
    return (ms, kernels) if count else ms


def print_profile(label: str, wall: float, busy: float, top: list) -> None:
    print(f"{label}: {wall:.1f} ms wall; device busy {busy:.2f} ms, idle "
          "share " + (f"{1 - busy / wall:.4f}" if busy else "not measured"),
          flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:90]}")


def profile_serve(corpus, estimators, queries):
    """One more serve pass over the same queries, and one more batched
    prompt decode, each under torch.profiler: the host wall time, the
    device's busy time and the kernels that take it. Launch counts were
    read before these passes. Returns the serve pass's (wall ms, busy
    ms)."""
    import numpy as np
    from repro_torch.core.kvbatch import batched_prompt_decode
    from repro_torch.launch.serve import serve_sequential

    wall, busy, top = profiled(lambda: serve_sequential(
        corpus, estimators, queries, seed=0))
    plans = len(queries) * (len(estimators) - 1)
    print_profile(f"serve pass (profiled), {len(queries)} queries x "
                  f"{len(estimators) - 1} estimators "
                  f"({wall / plans:.2f} ms per plan + cascade)",
                  wall, busy, top)
    seq = (wall, busy)
    kvb = estimators["kvbatch"]
    prompt = np.arange(kvb.prompt_len) % kvb.store.cfg.vocab_size
    print_profile(f"batched prompt decode (profiled), {kvb.prompt_len} "
                  f"tokens x {kvb.store.cfg.num_layers} layers",
                  *profiled(lambda: batched_prompt_decode(kvb.store,
                                                          prompt)))
    return seq


def slice_check(dev):
    """The KV-batch slice on the smoke config from the same parameters,
    patch embeddings and calibration tokens, kernels on the card against
    the plain versions on the CPU: in bf16 keeping every position (answer
    logits within 2e-2; which positions a top-keep picks is not comparable
    across bf16 roundings), and in float32 at the main path's rate 0.6
    (within 1e-4)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.kvbatch import assemble_store, batched_prompt_decode
    from repro_torch.models import nn
    from repro_torch.models.steps import model_specs

    base = get_config("llava-next-8b", smoke=True)
    cpu = torch.device("cpu")
    prompt = np.arange(PROMPT_LEN) % base.vocab_size
    for dtype, rate, tol in ((torch.bfloat16, 0.0, ATTN_TOL["bfloat16"]),
                             (torch.float32, RATE, 1e-4)):
        cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype)
        params = nn.init_params(model_specs(cfg),
                                torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        patches = torch.randn((SAMPLE, cfg.vlm.num_patch_tokens, cfg.d_model),
                              generator=gen).to(dtype)
        calib = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
        out = {}
        for where in (cpu, dev):
            store = assemble_store(
                cfg, nn.tree_map(lambda t: t.to(where), params),
                patches.to(where), calib.to(where), np.arange(SAMPLE),
                rate=rate)
            out[where.type], _ = batched_prompt_decode(store, prompt)
        close_case(f"slice {cfg.name} {dtype} rate {rate}: store + "
                   f"{PROMPT_LEN}-token decode, card vs CPU",
                   torch.from_numpy(out["cuda"]), torch.from_numpy(out["cpu"]),
                   tol, [])


# ------------------------------------------- the index and mutable phases

INDEX_CLUSTERS = 512     # ~sqrt(N)/2 at 2^20, the assignment kernel's cap
INSERTS, INSERT_BATCH, DELETES = 2**14, 2**10, 2**13
LATE = 256               # base and tail rows deleted while the rebuild runs


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (the fresh full scans a path is checked
    against) leave the probe kernel's launch counters as they were."""
    from repro_torch.kernels.cosine_topk import kernel

    total, by_entry = kernel.launches, dict(kernel.entry_launches)
    by_path = dict(kernel.path_launches)
    try:
        yield
    finally:
        kernel.launches = total
        kernel.entry_launches.clear()
        kernel.entry_launches.update(by_entry)
        kernel.path_launches.update(by_path)


def zero_counts():
    from repro_torch.models import layers

    for mod in kernel_modules().values():
        mod.launches = 0
        for path in getattr(mod, "path_launches", {}):
            mod.path_launches[path] = 0
    kernel_modules()["cosine_topk"].entry_launches.clear()
    layers.plain_attention_calls = 0


def check_paths(where: str) -> None:
    """Every assignment since the counts were zeroed took the tensor-core
    path and every Expected-Attention score the vector path (the store and
    the caches lie on 16-byte boundaries)."""
    for name in ("kmeans_assign", "expected_attention"):
        paths = kernel_modules()[name].path_launches
        check(paths["scalar"] == 0,
              f"{where}: {name} launches by path {paths}, expected no "
              "scalar-load launch")


def read_counts() -> dict:
    import torch

    torch.cuda.synchronize()
    mods = kernel_modules()
    out = {name: mod.launches for name, mod in mods.items()}
    out.update(mods["cosine_topk"].entry_launches)
    out.update({f"scan_{path}": n for path, n
                in mods["cosine_topk"].path_launches.items()})
    return out


def full_counts(store, embs, thrs, k=1):
    """The full-scan kernel's counts and top-k for host predicates."""
    import torch
    from repro_torch.kernels.cosine_topk import ops

    dev = store.device
    return ops.cosine_probe_batch(
        store, torch.as_tensor(embs, dtype=torch.float32, device=dev),
        torch.as_tensor(thrs, dtype=torch.float32, device=dev).reshape(
            len(embs), -1), k=k)


def index_path(dev, corpus, estimators, queries):
    """The cluster-pruned index at K = 512 over the main path's store, served
    with compound plans through estimators whose histogram carries it (the
    main path's corpus, specificity model and KV-batch store), then the
    user calls that reach the other masked entry points: kth_smallest_
    distance and count_within (one predicate) and batches of 37 and 200
    predicates (the last past block_b, the B-tiled entry point).
    Every selectivity and prefix selectivity is held to the full-scan
    kernel's count exactly, every k-th distance bitwise."""
    import numpy as np
    import torch
    from repro_torch.core.estimators import (
        EnsembleEstimator,
        KVBatchEstimator,
        SpecificityEstimator,
    )
    from repro_torch.core.histogram import SemanticHistogram
    from repro_torch.index import build_clustered_store
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.launch.serve import serve_sequential

    hist = estimators["specificity"].hist
    store, n = hist.embeddings, hist.n
    model = estimators["specificity"].model
    names = ("specificity", "kvbatch", "ensemble", "oracle")
    full_est = {name: estimators[name] for name in names}
    quiet = contextlib.redirect_stdout(io.StringIO())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet:      # compound plans through the full-store compound scan
        serve_sequential(corpus, full_est, queries, seed=0, compound=True)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0

    zero_counts()
    t0 = time.perf_counter()
    index = build_clustered_store(store, INDEX_CLUSTERS, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # Lloyd's iterations, then the final assignment
    want = inspect.signature(build_clustered_store).parameters["iters"] \
        .default + 1
    got = kernel_modules()["kmeans_assign"].launches
    check(got == want, f"index build: {got} assign launches, expected {want}")
    check_paths("index build")
    print(f"index build: {got} assign launches at C={INDEX_CLUSTERS}, "
          f"{build_s:.2f} s", flush=True)
    hist_idx = SemanticHistogram(store, index=index)
    spec = SpecificityEstimator(corpus, hist_idx, model)
    kvb = KVBatchEstimator(corpus, hist_idx, estimators["kvbatch"].store)
    idx_est = {"specificity": spec, "kvbatch": kvb,
               "ensemble": EnsembleEstimator(spec, kvb),
               "oracle": estimators["oracle"]}
    kvb._machinery_latency()     # its one timed decode, as the main path's
    torch.cuda.synchronize()
    index.reset_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        results = serve_sequential(corpus, idx_est, queries, seed=0,
                                   compound=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_stats = index.stats()
    nodes = corpus.predicate_nodes()
    # coalesced batches of 37 and of 200 (past block_b: the B-tiled entry
    # point), each predicate a node's embedding under another seed
    many = np.stack([corpus.text_embedding(x, seed)
                     for seed in range(-(-200 // len(nodes))) for x in nodes])
    wide, w200 = many[:37], many[:200]
    wide_thr, w200_thr = model.thresholds(wide), model.thresholds(w200)
    one = wide[:3]
    kth = [(j, k, hist_idx.kth_smallest_distance(one[j], k))
           for j in range(3) for k in (1, 64, 1000)]
    within = [hist_idx.count_within(one[j], float(wide_thr[j]))
              for j in range(3)]
    wide_c, wide_t = hist_idx.probe_batch(wide, wide_thr, k=8)
    w200_c, w200_t = hist_idx.probe_batch(w200, w200_thr, k=8)
    comp9 = {mode: hist_idx.count_compound(wide[:9], wide_thr[:9], mode=mode)
             for mode in ("and", "or")}
    launches = read_counts()
    plans = len(queries) * (len(idx_est) - 1)
    print(f"index: K={index.k_clusters} over {n} rows built in {build_s:.2f} s "
          f"(radii p50 {float(np.median(index.radii)):.4f}); compound serve "
          f"pass {serve_s * 1e3:.1f} ms = {serve_s / plans * 1e3:.2f} ms per "
          f"plan + cascade, without the index {full_s / plans * 1e3:.2f} ms; "
          f"scan fraction {serve_stats['scan_fraction']:.4f} over "
          f"{serve_stats['probes']} probes, {serve_stats['launches']} scans; "
          f"launches {launches}", flush=True)

    with uncounted():
        checked = 0
        for name, res in results.items():
            if name == "oracle":
                continue
            for r in res:
                check(len(r.plan.filter_order) == 3 and r.vlm_calls > 0,
                      f"index {name}: empty cascade")
                embs = np.stack([corpus.text_embedding(x, 0)
                                 for x in r.plan.filter_order])
                thrs = np.asarray([e.threshold for e in r.plan.estimates])
                fc, _ = full_counts(store, embs, thrs)
                got = [round(e.selectivity * n) for e in r.plan.estimates]
                check(got == fc[:, 0].tolist(),
                      f"index {name}: counts {got} vs the full scan's "
                      f"{fc[:, 0].tolist()}")
                checked += 3
                if r.plan.prefix_sels is None:
                    continue
                for i in range(1, 3):
                    want = int(ops.cosine_compound_count(
                        store, torch.as_tensor(embs[:i + 1], device=dev),
                        torch.as_tensor(thrs[:i + 1], dtype=torch.float32,
                                        device=dev), mode="and"))
                    check(round(r.plan.prefix_sels[i] * n) == want,
                          f"index {name}: prefix {i} count "
                          f"{r.plan.prefix_sels[i] * n} vs the full "
                          f"compound scan's {want}")
                    checked += 1
        check(results["ensemble"][0].plan.prefix_sels is not None,
              "the ensemble's plans were not compound")
        for j, k, got in kth:
            _, ft = ops.cosine_probe(store, torch.as_tensor(one[j], device=dev),
                                     torch.zeros((1,), device=dev), k=k)
            check(got == float(ft[k - 1]),
                  f"kth_smallest({j}, {k}) {got} vs the full scan's "
                  f"{float(ft[k - 1])}")
        fc2, ft2 = full_counts(store, w200, w200_thr, k=8)
        check(torch.equal(w200_c, fc2) and torch.equal(w200_t, ft2),
              "B=200 pruned probe is not bitwise the full scan")
        fc, ft = full_counts(store, wide, wide_thr, k=8)
        check(torch.equal(wide_c, fc) and torch.equal(wide_t, ft),
              "B=37 pruned probe is not bitwise the full scan")
        check(within == fc[:3, 0].tolist(),
              f"count_within {within} vs {fc[:3, 0].tolist()}")
        for mode, got in comp9.items():
            want = int(ops.cosine_compound_count(
                store, torch.as_tensor(wide[:9], device=dev),
                torch.as_tensor(wide_thr[:9], dtype=torch.float32,
                                device=dev), mode=mode))
            check(got == want, f"count_compound {mode} of 9 through the "
                               f"index: {got} vs the full scan's {want}")
    print(f"  index: {checked} selectivities and prefix selectivities equal "
          f"the full-scan kernel's counts; {len(kth)} k-th distances, the "
          f"B=37 and B=200 probes and 9-conjunct compound counts {comp9} "
          f"bitwise the full scan's", flush=True)
    print_profile("compound serve pass with the index (profiled)",
                  *profiled(lambda: serve_sequential(corpus, idx_est, queries,
                                                     seed=0, compound=True)))
    for name in ("cosine_probe_masked", "cosine_probe_batch_masked",
                 "cosine_probe_batch_masked_tiled", "cosine_compound"):
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the index path")
    # the shapes phase 5 times: the first plan's probes
    emb3 = np.stack([corpus.text_embedding(x, 0) for x in queries[0]])
    thr3 = model.thresholds(emb3)
    shapes = {"index": index, "p3": emb3, "t3": thr3, "p37": wide,
              "t37": wide_thr, "p200": w200, "t200": w200_thr}
    return launches, shapes


def mutable_path(dev, store, shapes):
    """The mutable store over the main path's store: 2^14 inserts in
    batches, 2^13 deletes of base and tail rows, probes through a
    SemanticHistogram(index=...), and a background rebuild with probes and
    a delete while it runs. After every step counts, top-k, k-th distances
    and compound counts are bitwise a fresh kernel scan of the live rows."""
    import numpy as np
    import torch
    from repro_torch.core.histogram import SemanticHistogram
    from repro_torch.index import MutableClusteredStore
    from repro_torch.kernels.cosine_topk import ops

    p3, t3 = shapes["p3"], shapes["t3"]
    p37, t37 = shapes["p37"], shapes["t37"]
    p200, t200 = shapes["p200"], shapes["t200"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    ms = MutableClusteredStore(store, INDEX_CLUSTERS, seed=0,
                               auto_rebuild=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assign_build = kernel_modules()["kmeans_assign"].launches
    check(assign_build == ms.iters + 1,
          f"mutable build: {assign_build} assign launches, expected "
          f"{ms.iters + 1}")
    hist = SemanticHistogram(store, index=ms)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    steps = []

    def verify(tag):
        c3, k3 = hist.probe_batch(p3, t3, k=128)
        c37, k37 = hist.probe_batch(p37, t37, k=8)
        c200, k200 = hist.probe_batch(p200, t200, k=8)
        within = hist.count_within(p3[0], float(t3[0]))
        kth = hist.kth_smallest_distance(p3[1], 100)
        comp = hist.count_compound(p3, t3)
        with uncounted():
            fresh = ms.live_rows()
            check(fresh.shape[0] == ms.n_live == hist.n,
                  f"{tag}: {fresh.shape[0]} live rows vs n {hist.n}")
            fc, ft = full_counts(fresh, p3, t3, k=128)
            gc, gt = full_counts(fresh, p37, t37, k=8)
            hc, ht = full_counts(fresh, p200, t200, k=8)
            want = int(ops.cosine_compound_count(
                fresh, torch.as_tensor(p3, device=dev),
                torch.as_tensor(t3, dtype=torch.float32, device=dev),
                mode="and"))
            check(torch.equal(c3, fc) and torch.equal(k3, ft)
                  and torch.equal(c37, gc) and torch.equal(k37, gt)
                  and torch.equal(c200, hc) and torch.equal(k200, ht),
                  f"{tag}: the mutable probe is not bitwise a fresh scan")
            check(within == int(fc[0, 0]) and kth == float(ft[1, 99])
                  and comp == want,
                  f"{tag}: scalar / k-th / compound differ from a fresh "
                  f"scan ({within}, {kth}, {comp} vs {int(fc[0, 0])}, "
                  f"{float(ft[1, 99])}, {want})")
            del fresh
        steps.append(tag)

    verify("built")
    near = store[torch.as_tensor(rng.choice(store.shape[0], INSERTS), device=dev)]
    near = near + 0.05 * unit_rows(INSERTS, store.shape[1], gen, dev)
    near = near / torch.linalg.vector_norm(near, dim=1, keepdim=True)
    tail_ids = []
    for i in range(0, INSERTS, INSERT_BATCH):
        tail_ids.extend(ms.insert(near[i:i + INSERT_BATCH]).tolist())
        verify(f"insert {i + INSERT_BATCH}")
    base_dead = rng.choice(store.shape[0], DELETES // 2, replace=False)
    tail_dead = rng.choice(tail_ids, DELETES // 2, replace=False)
    dead = np.concatenate([base_dead, tail_dead])
    rng.shuffle(dead)
    for i in range(0, DELETES, INSERT_BATCH):
        ms.delete(dead[i:i + INSERT_BATCH])
        verify(f"delete {i + INSERT_BATCH}")
    tail_snapshot = (ms._tail_emb[:ms._tail_len].clone(),
                     ms._tail_mask[:ms._tail_len].clone())
    gate, entered = threading.Event(), threading.Event()

    def hold():
        entered.set()
        check(gate.wait(timeout=300), "the rebuild's swap was never released")

    ms._pre_swap_hook = hold
    check(ms.rebuild(wait=False), "no rebuild started")
    check(entered.wait(timeout=300), "the rebuild never reached its swap")
    verify("mid-rebuild")
    late = np.concatenate([
        rng.choice(np.setdiff1d(np.arange(store.shape[0]), base_dead), LATE,
                   replace=False),
        rng.choice(np.setdiff1d(tail_ids, tail_dead), LATE, replace=False)])
    ms.delete(late)
    verify("delete mid-rebuild")
    check(ms.generation == 0, "the swap landed before it was released")
    gate.set()
    ms.drain_rebuild(timeout=600)
    ms._pre_swap_hook = None
    check(not ms._rebuild_thread.is_alive() and ms.generation == 1,
          f"rebuild did not finish (generation {ms.generation})")
    st = ms.stats()
    check(st["base_dead"] == 2 * LATE and st["tail_rows"] == 0,
          f"after the swap: {st['base_dead']} dead base rows, "
          f"{st['tail_rows']} tail rows (expected {2 * LATE} and 0)")
    verify("rebuilt")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    assign_rebuild = launches["kmeans_assign"] - assign_build
    want = (ms.rebuild_iters if ms.last_rebuild_incremental else ms.iters) + 1
    check(assign_rebuild == want, f"mutable rebuild: {assign_rebuild} assign "
                                  f"launches, expected {want}")
    check_paths("mutable phase")
    print(f"mutable: assign launches at C={INDEX_CLUSTERS}: build "
          f"{assign_build} ({build_s:.2f} s), rebuild {assign_rebuild} "
          f"({ms.last_rebuild_s:.2f} s)", flush=True)
    print(f"mutable: K={INDEX_CLUSTERS} built in {build_s:.2f} s; {INSERTS} "
          f"inserts, {DELETES + 2 * LATE} deletes, background rebuild "
          f"{ms.last_rebuild_s:.2f} s (incremental "
          f"{ms.last_rebuild_incremental}); {len(steps)} steps bitwise a "
          f"fresh scan; n_live {ms.n_live}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    for name in ("cosine_probe_rowmask", "cosine_probe_batch_rowmask",
                 "cosine_probe_batch_rowmask_tiled", "cosine_compound",
                 "cosine_probe_batch_masked"):
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the mutable path")
    shapes["tail"] = tail_snapshot
    return launches


# ------------------------------------------------------- the concurrent phase

CONC_THREADS, CONC_WINDOW_MS, CONC_MAX_BATCH = 16, 4.0, 64
CONC_CACHE, CONC_BITS, CONC_QUERIES, CONC_PASSES = 1024, 12, 64, 2
INGEST_RATE = 2000.0     # rows a second asked of the ingest thread
# a rebuild once the hot tail holds ~21 rows: the ingest thread, one row a
# call under the GIL beside 16 planners, lands tens of rows a second
INGEST_TAIL_FRAC = 2e-5
CHAOS = "seed=1,fail=0.3,delay=0.2,delay-ms=5,kill-at=3"
CHAOS_DEADLINE_MS = 1000.0
# the probe's entry points each run may reach (no *_tiled at max_batch 64)
CONC_ENTRIES = {
    "full": {"cosine_probe_batch"},
    "index": {"cosine_probe_batch_masked", "cosine_probe_masked",
              "cosine_compound"},
    "mutable": {"cosine_probe_batch_masked", "cosine_probe_masked",
                "cosine_probe_batch_rowmask", "cosine_probe_rowmask"},
    "chaos": {"cosine_probe_batch_masked", "cosine_probe_masked"},
}


def _stack_on(corpus, estimators, hist):
    """The main path's estimators over another histogram (the same corpus,
    specificity model and KV-batch store)."""
    from repro_torch.core.estimators import (
        EnsembleEstimator,
        KVBatchEstimator,
        SpecificityEstimator,
    )

    spec = SpecificityEstimator(corpus, hist, estimators["specificity"].model)
    kvb = KVBatchEstimator(corpus, hist, estimators["kvbatch"].store)
    return {"specificity": spec, "kvbatch": kvb,
            "ensemble": EnsembleEstimator(spec, kvb),
            "oracle": estimators["oracle"]}


def _exact_sel(hist, node, corpus, thr):
    """The uncoalesced ``probe_batch`` of one predicate (uncounted):
    (count / n, count)."""
    import numpy as np

    with uncounted():
        c, _ = hist.probe_batch(corpus.text_embedding(node, 0)[None],
                                np.asarray([[thr]], np.float32), k=1,
                                use_cache=False)
    count = int(c[0, 0])
    return count / hist.n, count


def _flush_checker(ms, hist, bad):
    """Wrap ``hist.probe_batch`` for the ingest run: each flush's probe,
    the same predicates scanned fresh over the live rows and its first
    predicate probed alone all run under the store's lock, so at one store
    version; the coalesced answers must be bitwise both (the checking
    launches are uncounted)."""
    import torch

    orig = hist.probe_batch

    def checked(preds, thresholds, **kw):
        with ms._lock:
            counts, topk = orig(preds, thresholds, **kw)
            with uncounted():
                fresh = ms.live_rows()
                fc, ft = full_counts(fresh, preds, thresholds)
                del fresh
                one_c, one_t = orig(preds[:1], thresholds[:1], **kw)
            if not (torch.equal(counts, fc) and torch.equal(topk, ft)
                    and torch.equal(counts[:1], one_c)
                    and torch.equal(topk[:1], one_t)):
                bad.append((len(preds), ms.version))
        return counts, topk

    hist.probe_batch = checked
    return orig


def exact_plans_of(tag, run, h, corpus):
    """Every estimate of a concurrent run bitwise the uncoalesced probe of
    its predicate through ``h`` (a degraded one: its interval holds that
    selectivity)."""
    exact, checked, inside = {}, 0, 0
    for _, _, res in run.results:
        for node, e in zip(res.plan.filter_order, res.plan.estimates):
            key = (int(node), e.threshold)
            if key not in exact:
                exact[key] = _exact_sel(h, node, corpus, e.threshold)[0]
            if e.extra.get("degraded"):
                lo, hi = e.extra["sel_interval"]
                check(lo - 1e-12 <= exact[key] <= hi + 1e-12,
                      f"{tag}: degraded interval [{lo}, {hi}] misses "
                      f"the exact selectivity {exact[key]}")
                inside += 1
            else:
                check(e.selectivity == exact[key],
                      f"{tag}: coalesced selectivity {e.selectivity} is "
                      f"not the uncoalesced probe's {exact[key]}")
                checked += 1
    print(f"  {tag}: {checked} coalesced selectivities bitwise the "
          f"uncoalesced probe ({len(exact)} predicates); {inside} "
          f"degraded intervals hold the exact selectivity", flush=True)
    return checked, inside


def concurrent_run(tag, out, corpus, ests, queries, **kw):
    """One ``serve_concurrent`` run of the phase's settings, its launch
    counts zeroed before and read after, a sample=1 trace of it written to
    the directory ``out`` and read back; returns (run, launches, hub,
    flush spans)."""
    import torch
    from repro_torch.launch.serve import coalescer_totals, serve_concurrent
    from repro_torch.obs import ObsHub, Tracer

    path = out / f"trace_{tag}.jsonl"
    tracer = Tracer(str(path), sample=1)
    hub = ObsHub(tracer=tracer)
    index = ests["ensemble"].hist.index
    if index is not None:
        index.obs = hub
    torch.cuda.synchronize()
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        run = serve_concurrent(
            corpus, ests, queries, est_name="ensemble", seed=0,
            concurrency=CONC_THREADS, window_ms=CONC_WINDOW_MS,
            max_batch=CONC_MAX_BATCH, cache_size=CONC_CACHE,
            cache_bits=CONC_BITS, passes=CONC_PASSES, obs=hub, **kw)
    launches = read_counts()
    totals = coalescer_totals(run.stats)
    hub.write_trace_summary(totals)
    tracer.close()
    if index is not None:
        index.obs = None
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    summary = recs[-1]
    check(summary["kind"] == "summary"
          and summary["requests"] == totals["requests"]
          and sum(1 for r in recs if r["kind"] == "submit")
          == totals["requests"],
          f"{tag}: the trace's submit spans and summary do not match the "
          f"counters ({summary})")
    return run, launches, hub, [r for r in recs if r["kind"] == "flush"]


def report_run(tag, run, launches, hub, flushes):
    """Print a run's numbers; check what every run must hold."""
    import collections

    import numpy as np

    st = run.stats
    buckets = ("probe_scored", "cache_hits", "coalesced_dups", "shed",
               "degraded", "errors")
    check(st["requests"] == sum(st[b] for b in buckets)
          and all(p["requests"] == sum(p[b] for b in buckets)
                  for p in run.passes),
          f"{tag}: counters do not reconcile: {st}")
    check(not run.failures, f"{tag}: failed queries {run.failures[:3]}")
    check(len(run.results) == CONC_QUERIES * CONC_PASSES
          and all(r is not None for _, _, r in run.results),
          f"{tag}: {len(run.results)} results")
    entries = {k for k, n in launches.items() if k.startswith("cosine_")
               and k != "cosine_topk" and n}
    check(launches["cosine_topk"] > 0, f"{tag}: no probe launch")
    check(entries <= CONC_ENTRIES[tag],
          f"{tag}: probe launches {sorted(entries - CONC_ENTRIES[tag])} on "
          f"a path this run should not reach")
    snap = hub.registry.snapshot()
    req = snap["histograms"]["serve.request_ms"]
    ok = [f for f in flushes if f["outcome"] == "ok"]
    sizes = collections.Counter(f["batch"] for f in ok)
    probe_ms = float(np.sum([f["probe_ms"] for f in ok]))
    combine_ms = float(np.sum([f["combine_ms"] for f in ok]))
    wait_ms = float(np.mean([f["queue_wait_ms"] for f in ok])) if ok else 0.0
    n_preds = CONC_QUERIES * CONC_PASSES * 3
    print(f"concurrent {tag}: {len(run.results)} queries in "
          f"{run.wall_s:.3f} s, {snap['gauges']['serve.qps']:.2f} QPS; "
          f"request latency p50 {req['p50']:.3f} p95 {req['p95']:.3f} p99 "
          f"{req['p99']:.3f} ms (registry, {req['count']} requests); "
          f"{st['probes_fired']} probes for {n_preds} predicates requested "
          f"({st['predicates_probed']} probed, {st['cache_hits']} cache "
          f"hits, {st['coalesced_dups']} in-flight dups, {st['degraded']} "
          f"degraded)", flush=True)
    print(f"  flush sizes (B: flushes) {dict(sorted(sizes.items()))}; "
          f"probe {probe_ms:.3f} ms and combine {combine_ms:.3f} ms over "
          f"the ok flushes, queue wait {wait_ms:.3f} ms a flush; per pass "
          + "; ".join(f"{p['requests']} req, {p['cache_hits']} hits, "
                      f"{p['predicates_probed']} probed"
                      for p in run.passes), flush=True)
    print(f"  launches {launches}", flush=True)
    return sizes


def concurrent_path(dev, corpus, estimators, shapes, seq_profile):
    """The concurrent serve path at full size: ``serve_concurrent`` with 16
    planner threads, a 4 ms window, max_batch 64, a 1024 x 12-bit cache,
    64 queries x 3 filters, 2 passes, the ensemble estimator, over the main
    path's store and KV-batch store. Four runs: (1) the full scan, (2) the
    K = 512 index with compound plans, (3) the mutable store at K = 512
    under ingest with at least one background rebuild, (4) chaos on the
    index with a deadline and degraded answers. Returns the probe's
    launches by entry point summed over the runs."""
    import collections

    import torch
    from repro_torch.core.histogram import SemanticHistogram
    from repro_torch.core.optimizer import generate_queries
    from repro_torch.index import MutableClusteredStore
    from repro_torch.kernels.cosine_topk import kernel
    from repro_torch.launch.serve import serve_concurrent
    from repro_torch.obs import report as obs_report

    queries = generate_queries(corpus, n_queries=CONC_QUERIES, n_filters=3,
                               seed=0)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    out = Path(tmp.name)      # the runs' traces and the metrics snapshot
    hist = estimators["specificity"].hist
    store, n = hist.embeddings, hist.n
    index = shapes["index"]
    totals: collections.Counter = collections.Counter()
    all_sizes: collections.Counter = collections.Counter()

    def exact_plans(tag, run, h):
        exact_plans_of(tag, run, h, corpus)

    # 1. the full scan; its snapshot is written as --metrics-json would be
    ests = _stack_on(corpus, estimators, hist)
    run, launches, hub, flushes = concurrent_run("full", out, corpus,
                                                 ests, queries)
    all_sizes += report_run("full", run, launches, hub, flushes)
    ok = [f for f in flushes if f["outcome"] == "ok"]
    wide = sum(1 for f in ok if f["batch"] > kernel.MAX_TILE)
    check(launches["scan_wide"] == wide
          and launches["scan_narrow"] == len(ok) - wide
          and launches["cosine_topk"] == run.stats["probes_fired"],
          f"full: {wide} flushes of B > 8 and {len(ok) - wide} of B <= 8 "
          f"against launches {launches}")
    check(run.passes[1]["cache_hits"] == run.passes[1]["requests"],
          f"full: pass 2 {run.passes[1]}, not all cache hits")
    exact_plans("full", run, hist)
    snap = obs_report.build_snapshot(registry=hub.registry,
                                     coalescer=run.stats)
    obs_report.write_json(snap, str(out / "metrics.json"))
    back = json.loads((out / "metrics.json").read_text())
    check(back["coalescer"]["reconciles"] and back["schema"] == 1
          and back["serve"]["queries"] == CONC_QUERIES * CONC_PASSES
          and {"coalescer", "latency_ms", "qerror", "degraded_answers",
               "serve", "registry"} <= set(back),
          f"metrics.json: {sorted(back)}")
    totals.update({k: v for k, v in launches.items()
                   if k.startswith(("cosine_", "scan_"))})

    # 2. the K = 512 index with compound plans
    hist_idx = SemanticHistogram(store, index=index)
    ests = _stack_on(corpus, estimators, hist_idx)
    run, launches, hub, flushes = concurrent_run("index", out, corpus,
                                                 ests, queries,
                                                 compound=True)
    all_sizes += report_run("index", run, launches, hub, flushes)
    check(run.passes[1]["cache_hits"] == run.passes[1]["requests"],
          f"index: pass 2 {run.passes[1]}, not all cache hits")
    check(all(r.plan.prefix_sels is not None for _, _, r in run.results),
          "index: a plan was not compound")
    exact_plans("index", run, hist_idx)
    totals.update({k: v for k, v in launches.items()
                   if k.startswith(("cosine_", "scan_"))})

    # 3. the mutable store under ingest: every flush checked at its version
    torch.cuda.synchronize()
    ms = MutableClusteredStore(store, INDEX_CLUSTERS, seed=0,
                               rebuild_tail_frac=INGEST_TAIL_FRAC)
    hist_mut = SemanticHistogram(store, index=ms)
    bad: list = []
    _flush_checker(ms, hist_mut, bad)
    ests = _stack_on(corpus, estimators, hist_mut)
    v0 = ms.version
    run, launches, hub, flushes = concurrent_run(
        "mutable", out, corpus, ests, queries, ingest_rate=INGEST_RATE)
    all_sizes += report_run("mutable", run, launches, hub, flushes)
    st = ms.stats()
    check(not bad, f"mutable: {len(bad)} flushes not bitwise a fresh scan "
                   f"at their version: {bad[:3]}")
    print(f"  mutable: {st['inserts']} inserts, {st['deletes']} deletes, "
          f"versions {v0} -> {st['version']}, {st['rebuilds']} background "
          f"rebuilds (last {st['last_rebuild_s']} s), {len(flushes)} "
          f"flushes each bitwise a fresh scan of the live rows and its "
          f"first predicate probed alone", flush=True)
    check(st["rebuilds"] >= 1 and launches["kmeans_assign"] > 0,
          f"mutable: {st['rebuilds']} background rebuilds, "
          f"{launches['kmeans_assign']} assign launches")
    totals.update({k: v for k, v in launches.items()
                   if k.startswith(("cosine_", "scan_"))})
    del ms, hist_mut, ests
    torch.cuda.empty_cache()

    # 4. chaos on the index, with a deadline and degraded answers
    ests = _stack_on(corpus, estimators, hist_idx)
    run, launches, hub, flushes = concurrent_run(
        "chaos", out, corpus, ests, queries, chaos_spec=CHAOS,
        deadline_ms=CHAOS_DEADLINE_MS, degraded_ok=True)
    all_sizes += report_run("chaos", run, launches, hub, flushes)
    st = run.stats
    check(st["chaos"]["launches"] >= 3 and st["chaos"]["injected_kills"] == 1
          and st["flusher_restarts"] == 1 and st["errors"] == 0,
          f"chaos: {st['chaos']}, restarts {st['flusher_restarts']}, "
          f"errors {st['errors']}")
    print(f"  chaos: {st['chaos']}; retries {st['retries']}, degraded "
          f"{st['degraded']}, breaker {st['breaker']}", flush=True)
    exact_plans("chaos", run, hist_idx)
    totals.update({k: v for k, v in launches.items()
                   if k.startswith(("cosine_", "scan_"))})

    big = [b for b in all_sizes if b > kernel.MAX_TILE]
    check(bool(big) and totals["scan_wide"] > 0,
          f"no flush of 9 or more predicates took the wide scan: sizes "
          f"{dict(all_sizes)}, launches {dict(totals)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (min(big), max(big)):
        shape = kernel.launch_shape(n, b, 1, 1, sms)
        check(shape[0] == kernel.WIDE_ROWS and kernel.wide_fits(DIM),
              f"launch_shape({n}, {b}) {shape} is not the wide scan")
        print(f"  B={b}: launch_shape {shape} (rows, partial blocks, kb, "
              f"int32 partials): the wide scan", flush=True)
    check(not any(k.endswith("_tiled") for k, v in totals.items() if v),
          f"a *_tiled entry launched at max_batch {CONC_MAX_BATCH}")

    # one profiled concurrent pass (a fresh cache: every predicate probed)
    ests = _stack_on(corpus, estimators, hist)
    ests["kvbatch"]._machinery_latency()
    wall, busy, top = profiled(lambda: serve_concurrent(
        corpus, ests, queries, est_name="ensemble", seed=0,
        concurrency=CONC_THREADS, window_ms=CONC_WINDOW_MS,
        max_batch=CONC_MAX_BATCH, cache_size=CONC_CACHE,
        cache_bits=CONC_BITS, passes=1))
    print_profile(f"concurrent pass (profiled), {CONC_QUERIES} queries, "
                  f"{CONC_THREADS} threads ({wall / CONC_QUERIES:.2f} ms "
                  f"per plan + cascade); serve_sequential's pass: idle "
                  f"share {1 - seq_profile[1] / seq_profile[0]:.4f}",
                  wall, busy, top)
    print(f"concurrent phase: probe launches by entry point over the four "
          f"runs {dict(totals)}", flush=True)
    tmp.cleanup()
    return dict(totals)


# --------------------------------------------------- the sharded phase

SHARDS = 4
SHARD_CLUSTERS = 256     # K a shard: sqrt(2^18) / 2, as K = 512 at 2^20
# the balanced build's split_radius: the contiguous build's radius at this
# quantile, and at most SPLIT_EXTRA clusters added by the host splitter
SPLIT_QUANTILE, SPLIT_EXTRA = 0.98, 32
FLEET_REPLICAS, FLEET_HEDGE_MS = 3, 5.0
# kill replica 1 at the third fleet dispatch, partition replica 2 over the
# first 40: both fire within a run's few hundred dispatches
FLEET_CHAOS = "seed=1,replica-kill=1@3,partition=2@1-40"
SHARD_INSERTS, SHARD_DELETES = 2**12, 2**11


def fleet_report(tag, run, launches, hub):
    """Print a fleet run's numbers; check what every fleet run must hold:
    the fleet-wide and per-replica reconciliation, no failed query, every
    result present."""
    from repro_torch.launch.fleet import FLEET_BUCKETS
    from repro_torch.obs import report as obs_report

    st = run.stats
    snap = obs_report.build_snapshot(registry=hub.registry, fleet=st)
    fl = snap["fleet"]
    check(fl["reconciles"] and all(r["reconciles"] for r in fl["replicas"])
          and st["requests"] == sum(st[b] for b in FLEET_BUCKETS),
          f"{tag}: fleet counters do not reconcile: "
          f"{ {k: st[k] for k in ('requests',) + FLEET_BUCKETS} }")
    check(not run.failures, f"{tag}: failed queries {run.failures[:3]}")
    check(len(run.results) == CONC_QUERIES * CONC_PASSES
          and all(r is not None for _, _, r in run.results),
          f"{tag}: {len(run.results)} results")
    check(launches["cosine_topk"] > 0, f"{tag}: no probe launch")
    req = snap["registry"]["histograms"]["serve.request_ms"]
    print(f"fleet {tag}: {len(run.results)} queries in {run.wall_s:.3f} s, "
          f"{snap['registry']['gauges']['serve.qps']:.2f} QPS; request "
          f"latency p50 {req['p50']:.3f} p95 {req['p95']:.3f} p99 "
          f"{req['p99']:.3f} ms (registry, {req['count']} requests); "
          f"{st['requests']} fleet requests, {st['failovers']} failovers, "
          f"{st['hedges']} hedges fired, cache hit rate "
          f"{st['cache']['hit_rate']:.4f}, healthy "
          f"{st['healthy_replicas']}/{st['replica_count']}", flush=True)
    for r in st["replicas"]:
        c = r["coalescer"]
        print(f"  replica {r['rid']}: alive {r['alive']}, {r['requests']} "
              f"requests ({r['probe_scored']} scored, {r['cache_hits']} "
              f"cache hits, {r['hedge_cancelled']} hedge losers), "
              f"{c['probes_fired']} probes fired, dispatch EWMA "
              f"{r['ewma_ms']} ms", flush=True)
    print("  fleet reconciliation OK; per pass "
          + "; ".join(f"{p['requests']} req, {p['cache_hits']} hits"
                      for p in run.passes), flush=True)
    print(f"  launches {launches}", flush=True)
    return st


def sharded_path(dev, corpus, estimators, shapes, seq_profile):
    """The sharded probes and the fleet at full size, S = 4 shards on one
    card: (1) the sharded full scan at B = 1, 3, 27, 200 and
    ``kth_smallest_batch`` at k > N / S; (2) the contiguous (K = 256 a
    shard) and boundary-balanced sharded indexes through the same calls
    and compound and/or; (3) the sharded mutable store through inserts,
    deletes and a background rebuild; (4) ``serve_concurrent`` over the
    balanced index through a 3-replica fleet with hedging, then fleet
    chaos. Every probe bitwise the unsharded kernel probe, every fleet
    answer bitwise a lone unsharded replica's. Launch counts are zeroed
    before the phase's calls and read after them; the unsharded probes it
    is checked against are uncounted. Returns the phase's launches."""
    import numpy as np
    import torch
    from repro_torch.core.histogram import SemanticHistogram
    from repro_torch.core.optimizer import generate_queries
    from repro_torch.index import (
        MutableClusteredStore,
        build_sharded_clustered_store,
    )
    from repro_torch.kernels.cosine_topk import ops
    from repro_torch.launch.mesh import make_probe_mesh
    from repro_torch.launch.serve import serve_sequential

    hist = estimators["specificity"].hist
    store, n = hist.embeddings, hist.n
    model = estimators["specificity"].model
    mesh = make_probe_mesh(SHARDS)
    check(mesh.shard_devices == (torch.device("cuda", 0),) * SHARDS,
          f"mesh devices {mesh.shard_devices} on a one-card machine")
    rows = n // SHARDS
    p3, t3 = shapes["p3"], shapes["t3"]
    p200, t200 = shapes["p200"], shapes["t200"]
    p27 = np.stack([corpus.text_embedding(x, 0)
                    for x in corpus.predicate_nodes()])
    t27 = model.thresholds(p27)
    cases = (("B=1", p3[:1], t3[:1], 128), ("B=3", p3, t3, 128),
             ("B=27", p27, t27, 8), ("B=200", p200, t200, 8))
    kth_k = rows + 1
    print(f"sharded: mesh {mesh.shape} on {sorted({str(d) for d in mesh.devices})}"
          f", {rows} rows a shard (views of the store)", flush=True)
    with uncounted():     # the unsharded probes everything is held to
        want = {label: full_counts(store, p, t, k=k)
                for label, p, t, k in cases}
        _, top = ops.cosine_probe_batch(
            store, torch.as_tensor(p3, device=dev),
            torch.zeros((3, 1), device=dev), k=kth_k)
        want_kth = top[:, kth_k - 1].cpu().numpy()
        want_comp = {(mode, b): int(ops.cosine_compound_count(
            store, torch.as_tensor(p27[:b], device=dev),
            torch.as_tensor(t27[:b], dtype=torch.float32, device=dev),
            mode=mode)) for mode in ("and", "or") for b in (3, 9)}
        torch.cuda.synchronize()

    def drive(h, tag):
        """The phase's calls through one histogram, each held bitwise to
        the unsharded probe."""
        for label, p, t, k in cases:
            c, tp = h.probe_batch(p, t, k=k)
            wc, wt = want[label]
            check(torch.equal(c, wc) and torch.equal(tp, wt),
                  f"{tag} {label}: not bitwise the unsharded probe")
        within = h.count_within(p3[0], float(t3[0]))
        check(within == int(want["B=3"][0][0, 0]),
              f"{tag}: count_within {within}")
        kth = h.kth_smallest_batch(p3, kth_k)
        check(np.array_equal(kth, want_kth),
              f"{tag}: kth_smallest_batch at k={kth_k} {kth} vs {want_kth}")
        for (mode, b), w in want_comp.items():
            got = h.count_compound(p27[:b], t27[:b], mode=mode)
            check(got == w, f"{tag}: compound {mode} of {b}: {got} vs {w}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    full = SemanticHistogram(store, mesh=mesh)
    drive(full, "sharded full scan")
    print(f"  sharded full scan: B = 1, 3, 27, 200, count_within, "
          f"kth_smallest_batch at k={kth_k} (> N/S) and compound and/or of "
          f"3 and 9 bitwise the unsharded probe", flush=True)

    # the indexes
    t0 = time.perf_counter()
    idx_c = build_sharded_clustered_store(store, SHARD_CLUSTERS, SHARDS,
                                          seed=0)
    torch.cuda.synchronize()
    build_c = time.perf_counter() - t0
    radii = np.concatenate([cs.radii for cs in idx_c.shards])
    split = float(np.quantile(radii, SPLIT_QUANTILE))
    k_global = SHARD_CLUSTERS * SHARDS
    t0 = time.perf_counter()
    idx_b = build_sharded_clustered_store(
        store, SHARD_CLUSTERS, SHARDS, seed=0, balance="boundary",
        split_radius=split, max_clusters=k_global + SPLIT_EXTRA)
    torch.cuda.synchronize()
    build_b = time.perf_counter() - t0
    check_paths("sharded builds")
    mass_c, mass_b = idx_c.boundary_mass(), idx_b.boundary_mass()
    cm = idx_b.contiguous_mass
    print(f"  sharded index builds: contiguous K={SHARD_CLUSTERS} a shard "
          f"{build_c:.2f} s; balanced (global K={k_global} in "
          f"{-(-k_global // 512)} assignment slices, split_radius "
          f"{split:.4f}: {sum(cs.k_clusters for cs in idx_b.shards)} "
          f"fragments) {build_b:.2f} s; boundary mass a shard: contiguous "
          f"build {np.round(mass_c, 1).tolist()} (spread "
          f"{mass_c.max() - mass_c.min():.1f}), balanced "
          f"{np.round(mass_b, 1).tolist()} (spread "
          f"{mass_b.max() - mass_b.min():.1f}; its contiguous "
          f"counterfactual {np.round(cm, 1).tolist()})", flush=True)
    idx_hists = {}
    for tag, idx in (("contiguous", idx_c), ("balanced", idx_b)):
        h = SemanticHistogram(store, mesh=mesh, index=idx)
        idx.reset_stats()
        drive(h, f"pruned {tag}")
        st = idx.stats()
        print(f"  pruned {tag}: bitwise the unsharded probe; scan fraction "
              f"{st['scan_fraction']:.4f} over {st['probes']} probes, per "
              f"shard {[round(p['scan_fraction'], 4) for p in st['per_shard']]}"
              f" (spread {st['spread']:.4f}, max shard rows "
              f"{st['max_shard_rows_scanned']})", flush=True)
        idx_hists[tag] = h
    launches = read_counts()
    phase = dict(launches)

    with uncounted():     # timings: the sharded probes against the unsharded
        for label, p, t, k in cases:
            if label == "B=27":
                continue
            ms_u = time_ms(lambda: hist.probe_batch(p, t, k=k), 10)
            ms_s = time_ms(lambda: full.probe_batch(p, t, k=k), 10)
            ms_b = time_ms(lambda: idx_hists["balanced"].probe_batch(
                p, t, k=k), 10)
            print(f"  timing {label}, k={k}: unsharded {ms_u:.4f} ms, "
                  f"sharded full scan (S={SHARDS}) {ms_s:.4f} ms, sharded "
                  f"balanced index {ms_b:.4f} ms (CUDA events, host "
                  f"included)", flush=True)
    queries = generate_queries(corpus, n_queries=5, n_filters=3, seed=0)
    ests = _stack_on(corpus, estimators, full)
    ests["kvbatch"]._machinery_latency()
    with uncounted():
        wall, busy, top = profiled(lambda: serve_sequential(
            corpus, ests, queries, seed=0))
    print_profile(f"sharded full-scan serve pass (profiled), S={SHARDS}; "
                  f"the unsharded pass: idle share "
                  f"{1 - seq_profile[1] / seq_profile[0]:.4f}",
                  wall, busy, top)
    del idx_hists["contiguous"], idx_c
    torch.cuda.empty_cache()

    # the sharded mutable store
    zero_counts()
    t0 = time.perf_counter()
    ms = MutableClusteredStore(store, SHARD_CLUSTERS, mesh=mesh, seed=0,
                               auto_rebuild=False)
    torch.cuda.synchronize()
    mbuild = time.perf_counter() - t0
    mhist = SemanticHistogram(store, mesh=mesh, index=ms)
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    steps = []

    def verify(tag):
        c3, k3 = mhist.probe_batch(p3, t3, k=128)
        c200, k200 = mhist.probe_batch(p200, t200, k=8)
        kth = mhist.kth_smallest_distance(p3[1], 100)
        comp = mhist.count_compound(p3, t3)
        with uncounted():
            fresh = ms.live_rows()
            fc, ft = full_counts(fresh, p3, t3, k=128)
            hc, ht = full_counts(fresh, p200, t200, k=8)
            wc = int(ops.cosine_compound_count(
                fresh, torch.as_tensor(p3, device=dev),
                torch.as_tensor(t3, dtype=torch.float32, device=dev),
                mode="and"))
            check(torch.equal(c3, fc) and torch.equal(k3, ft)
                  and torch.equal(c200, hc) and torch.equal(k200, ht)
                  and kth == float(ft[1, 99]) and comp == wc,
                  f"sharded mutable {tag}: not bitwise a fresh scan")
            del fresh
        steps.append(tag)

    verify("built")
    near = store[torch.as_tensor(rng.choice(n, SHARD_INSERTS), device=dev)]
    near = near + 0.05 * unit_rows(SHARD_INSERTS, DIM, gen, dev)
    near = near / torch.linalg.vector_norm(near, dim=1, keepdim=True)
    tail_ids = []
    for i in range(0, SHARD_INSERTS, INSERT_BATCH):
        tail_ids.extend(ms.insert(near[i:i + INSERT_BATCH]).tolist())
        verify(f"insert {i + INSERT_BATCH}")
    dead = np.concatenate([rng.choice(n, SHARD_DELETES // 2, replace=False),
                           rng.choice(tail_ids, SHARD_DELETES // 2 + 1,
                                      replace=False)])
    ms.delete(dead)
    verify("delete")
    gate, entered = threading.Event(), threading.Event()

    def hold():
        entered.set()
        check(gate.wait(timeout=300), "the rebuild's swap was never released")

    n_live = ms.n_live
    ms._pre_swap_hook = hold
    check(ms.rebuild(wait=False), "no sharded rebuild started")
    check(entered.wait(timeout=300), "the sharded rebuild never swapped")
    verify("mid-rebuild")
    gate.set()
    ms.drain_rebuild(timeout=600)
    ms._pre_swap_hook = None
    st = ms.stats()
    check(ms.generation == 1 and st["base_rows"] == n_live - n_live % SHARDS
          and st["tail_rows"] == n_live % SHARDS,
          f"sharded rebuild: generation {ms.generation}, base "
          f"{st['base_rows']}, tail {st['tail_rows']} of {n_live} live")
    verify("rebuilt")
    mlaunch = read_counts()
    for key, v in mlaunch.items():
        phase[key] = phase.get(key, 0) + v
    print(f"  sharded mutable: build {mbuild:.2f} s, background rebuild "
          f"{ms.last_rebuild_s:.2f} s (incremental "
          f"{ms.last_rebuild_incremental}), {SHARD_INSERTS} inserts, "
          f"{len(dead)} deletes, {len(steps)} steps bitwise a fresh scan; "
          f"{n_live % SHARDS} remainder rows held back in the tail; "
          f"per-shard scan fractions of the new base "
          f"{[round(p['scan_fraction'], 4) for p in ms.stats()['base_stats']['per_shard']]}"
          f"; launches {mlaunch}", flush=True)
    del ms, mhist
    torch.cuda.empty_cache()

    # the fleet over the balanced index
    fqueries = generate_queries(corpus, n_queries=CONC_QUERIES, n_filters=3,
                                seed=0)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    out = Path(tmp.name)
    hist_b = idx_hists["balanced"]
    for tag, kw in (("fleet", dict(hedge_ms=FLEET_HEDGE_MS)),
                    ("fleet chaos", dict(chaos_spec=FLEET_CHAOS))):
        ests = _stack_on(corpus, estimators, hist_b)
        run, fl_launch, hub, _ = concurrent_run(
            tag.replace(" ", "_"), out, corpus, ests, fqueries,
            replicas=FLEET_REPLICAS, **kw)
        st = fleet_report(tag, run, fl_launch, hub)
        exact_plans_of(tag, run, hist, corpus)
        for key, v in fl_launch.items():
            phase[key] = phase.get(key, 0) + v
        if "chaos_spec" in kw:
            cs = st["chaos"]
            check(cs["injected_kills"] == 1 and cs["injected_partitions"] >= 1
                  and not st["replicas"][1]["alive"] and st["failovers"] >= 1,
                  f"fleet chaos: {cs}, failovers {st['failovers']}")
            print(f"  fleet chaos fired: replica 1 killed at dispatch 3, "
                  f"{cs['injected_partitions']} dispatches to replica 2 "
                  f"partitioned, over {cs['dispatches']} dispatches; "
                  f"{st['failovers']} failovers, no degraded answer needed",
                  flush=True)
    tmp.cleanup()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"sharded phase: peak device memory {peak / 2**30:.2f} GiB; probe "
          f"and assign launches over the phase "
          f"{ {k: v for k, v in phase.items() if v} }", flush=True)
    for name in ("cosine_probe", "cosine_probe_batch",
                 "cosine_probe_batch_tiled", "cosine_probe_masked",
                 "cosine_probe_batch_masked",
                 "cosine_probe_batch_masked_tiled", "cosine_compound",
                 "cosine_probe_batch_rowmask", "kmeans_assign"):
        check(phase.get(name, 0) > 0,
              f"{name} was not launched on the sharded path")
    return phase


# ------------------------------------------------------------------ phase 5


def measure(dev, gen, name_card, corpus, estimators, launches, errs):
    """Every kernel at the main path's shapes (the probe and assign on its
    own store): checked against its plain version as in phase 3, then
    timed beside its bound, its plain version and a library yardstick."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cosine_topk import kernel as ct_kernel
    from repro_torch.kernels.cosine_topk import ops as ct_ops
    from repro_torch.kernels.cosine_topk import ref as ct_ref
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.expected_attention import kernel as ea_kernel
    from repro_torch.kernels.expected_attention import ops as ea_ops
    from repro_torch.kernels.expected_attention import ref as ea_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.kmeans import kernel as km_kernel
    from repro_torch.kernels.kmeans import ops as km_ops
    from repro_torch.kernels.kmeans import ref as km_ref

    bw, f32_peak, bf16_peak = peaks(name_card)

    def bound(nbytes, nops, peak=f32_peak):
        tb, to = nbytes / bw * 1e3, nops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def probe_cost(b, t, k):
        return (4 * (n * d + b * d + b * t) + 4 * (b * t + b * k),
                2 * n * d * b + n * b * (1 + t))

    def probe_library(p, t, k):
        def run():
            dist = 1.0 - torch.matmul(p, store.T)
            (dist[:, None, :] <= t[:, :, None]).sum(dim=-1)
            torch.topk(dist, k, dim=1, largest=False)
        return run

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
        "plain_ms": time_ms(lambda: ct_ref.cosine_probe_batch_ref(
            store, preds, thr, k), 20),
        "library_ms": time_ms(probe_library(preds, thr, k), 20),
    }
    probe["kernel_only_ms"], kernels = kernel_alone_ms(
        lambda: ct_ops.cosine_probe_batch(store, preds, thr, k=k), "probe",
        probe["ms"], count=True)
    check(kernels <= 2, f"probe: {kernels} kernels a call")
    p_bytes, p_ops = probe_cost(b, t, k)

    # the scalar probe (B = 1, the cosine_probe_blocks entry point) and wider
    # batches (a coalesced serving batch; past 8 predicates the wide scan
    # reads the store once for any B, where the Pallas batch kernel reads it
    # once for B <= 128); not on the main path
    one_p, one_t = preds[:1].contiguous(), thr[:1].contiguous()
    rows_wide = [(1, one_p, one_t, lambda: ct_ops.cosine_probe(
        store, one_p[0], one_t[0], k=1), 20)]
    for wb in (37, 200):
        wp = unit_rows(wb, d, gen, dev)
        wt = torch.full((wb, 1), 0.5, device=dev)
        rows_wide.append((wb, wp, wt, lambda wp=wp, wt=wt:
                          ct_ops.cosine_probe_batch(store, wp, wt, k=1), 5))
    for wb, wp, wt, fn, iters in rows_wide:
        row = {"B": wb, "store_passes": ct_kernel.store_passes(wb, d),
               "ms": time_ms(fn, iters),
               "plain_ms": time_ms(lambda: ct_ref.cosine_probe_batch_ref(
                   store, wp, wt, 1), iters),
               "library_ms": time_ms(probe_library(wp, wt, 1), iters)}
        row["bound_ms"], row["bound_by"] = bound(*probe_cost(wb, 1, 1))
        alone, kernels = kernel_alone_ms(fn, f"probe B={wb}", row["ms"],
                                         count=True)
        check(kernels <= 2, f"probe B={wb}: {kernels} kernels a call")
        print(f"  probe B={wb}: {row['store_passes']} store passes, "
              f"{row['ms']:.3f} ms (kernels alone {alone:.3f} ms, {kernels} "
              f"a call), plain {row['plain_ms']:.3f} ms, library chain "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']})", flush=True)
    del rows_wide

    # assign at the main path's C = 32 (its k-means starts from these rows,
    # its seeded draw) and the index's C = 512 (build_clustered_store's first
    # draw, the same seed)
    assign_rows = []
    for c, name, iters in ((32, "kmeans_assign", 20),
                           (INDEX_CLUSTERS, "kmeans_assign_c512", 3)):
        init = np.random.default_rng(0).choice(n, size=c, replace=False)
        cent = store[torch.as_tensor(init, device=dev)].contiguous()
        errs.setdefault(name, [])
        assign_case(store, cent, f"main-path store C={c}", errs[name])
        check(km_kernel.vector_path(store, cent),
              f"assign C={c}: the store does not take the tensor-core path")
        row = {
            "ms": time_ms(lambda: km_ops.assign(store, cent), iters),
            "plain_ms": time_ms(lambda: km_ref.assign_ref(store, cent),
                                iters),
            "library_ms": time_ms(lambda: torch.cdist(store, cent).argmin(1),
                                  max(2, iters // 4)),
            "earlier_ms": time_ms(lambda: km_kernel.assign_scalar(store, cent),
                                  iters),
        }
        row["kernel_only_ms"] = kernel_alone_ms(
            lambda: km_ops.assign(store, cent), f"assign C={c}", row["ms"])
        a_bytes = 4 * (n * d + c * d) + 4 * n
        # the bound two ways: the function's fp32 operations on the CUDA
        # cores, and what the kernel issues (three bf16 products of the
        # split operands) on the tensor cores; the row's bound is the second
        fp32_ms, fp32_by = bound(a_bytes, 2 * n * d * c + n * c)
        bms, by = bound(a_bytes, 3 * 2 * n * d * c, bf16_peak)
        rows_a_block, _ = km_kernel.tile(c)
        blocks = -(-n // rows_a_block)
        print(f"  assign C={c}: {row['ms']:.4f} ms (kernels alone "
              f"{row['kernel_only_ms']:.4f} ms, torch.profiler), chain "
              f"x @ c.T + argmin {row['plain_ms']:.4f} ms "
              f"({'under' if row['ms'] < row['plain_ms'] else 'OVER'} it), "
              f"torch.cdist + argmin {row['library_ms']:.4f} ms, earlier "
              f"design (the scalar-load path) {row['earlier_ms']:.4f} ms; "
              f"bound {bms:.4f} ms ({by}, issued bf16 products at "
              f"{bf16_peak / 1e12:.0f} TFLOP/s; share "
              f"{bms / row['ms']:.3f}), fp32 rule {fp32_ms:.4f} ms "
              f"({fp32_by}); device-memory bytes: the store once "
              f"({n * d * 4 / 1e9:.3f} GB, each row in one of {blocks} blocks "
              f"of {rows_a_block} rows: {n * d * 4 / row['ms'] / 1e9:.3f} "
              f"TB/s at this time), centroids re-read from L2 "
              f"{blocks * c * d * 4 / 1e9:.2f} GB", flush=True)
        assign_rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/kmeans_assign.cu",
            "replaces": "src/repro/kernels/kmeans/kernel.py:31",
            "launches": launches[name], "max_abs_err": max(errs[name]),
            **row, "bound_ms": bms, "bound_by": by, "bound_fp32_ms": fp32_ms,
            "bound_fp32_by": fp32_by,
            "library_call": "torch.cdist(x, c).argmin(1); plain: the chain "
                            "x @ c.T + argmin", "shape": f"N={n} d={d} C={c}"})

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # flash: one prefill layer (B = the main path's sample, S 2880, H 32,
    # Hkv 8, D 128, bf16). The plain version would build (B, 32, 2880, 2880)
    # f32 scores, so it is checked on two images and timed two at a time.
    B = len(estimators["kvbatch"].store.sample_ids)
    S, H, Hk, D = N_PATCH, HEADS, KV_HEADS, HEAD_DIM
    q, kk, vv = rn(B, S, H, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    flash_case(q[:2], kk[:2], vv[:2], f"main-path inputs B=2 of {B}",
               errs["flash_attention"])
    flash = {
        "ms": time_ms(lambda: fa_ops.flash_attention(q, kk, vv), 3, 1),
        "plain_ms": time_ms(lambda: [fa_ref.flash_attention_ref(
            q[i:i + 2], kk[i:i + 2], vv[i:i + 2]) for i in range(0, B, 2)],
            1, 1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            is_causal=True, enable_gqa=True), 3, 1),
    }
    flash["kernel_only_ms"] = kernel_alone_ms(
        lambda: fa_ops.flash_attention(q, kk, vv), "flash", flash["ms"])
    f_bytes = 2 * (2 * q.numel() + 2 * kk.numel())
    f_ops = 4 * B * H * D * (S * (S + 1) // 2)
    del q, kk, vv

    # decode: the six prompt steps of one layer (cache 1168, valid
    # 1153..1158, bf16), timed as one pass over the six and reported per step
    q = rn(B, 1, H, D)
    kc, vc = rn(B, CAPACITY, Hk, D), rn(B, CAPACITY, Hk, D)
    valids = [KEEP + i + 1 for i in range(PROMPT_LEN)]
    decode_case(q, kc, vc, valids[-1], f"main-path B={B} valid={valids[-1]}",
                errs["decode_attention"], ATTN_TOL["bfloat16"])
    decode = {
        "ms": time_ms(lambda: [da_ops.decode_attention(
            q, kc, vc, kv_valid=n_ok) for n_ok in valids], 20) / PROMPT_LEN,
        "plain_ms": time_ms(lambda: [da_ref.decode_attention_ref(
            q, kc, vc, kv_valid=n_ok) for n_ok in valids], 20) / PROMPT_LEN,
        "library_ms": time_ms(lambda: [F.scaled_dot_product_attention(
            q.transpose(1, 2), kc[:, :n_ok].transpose(1, 2),
            vc[:, :n_ok].transpose(1, 2), enable_gqa=True)
            for n_ok in valids], 20) / PROMPT_LEN,
    }
    decode["kernel_only_ms"] = kernel_alone_ms(
        lambda: [da_ops.decode_attention(q, kc, vc, kv_valid=n_ok)
                 for n_ok in valids], "decode", decode["ms"])
    d_bytes = 2 * (2 * q.numel()) + sum(
        2 * 2 * B * Hk * n_ok * D for n_ok in valids) / PROMPT_LEN
    d_ops = 4 * B * H * D * sum(valids) / PROMPT_LEN
    # what a plain read reaches here: torch.sum over as many contiguous
    # bytes as a decode step reads (the decode row's "read_ms")
    flat = torch.empty(int(d_bytes) // 2, dtype=torch.bfloat16, device=dev)
    flat.normal_(generator=gen)
    decode["read_ms"] = time_ms(lambda: torch.sum(flat, dtype=torch.float32),
                                20)
    print(f"  torch.sum over {d_bytes / 1e6:.1f} MB contiguous: "
          f"{decode['read_ms']:.4f} ms = "
          f"{d_bytes / decode['read_ms'] / 1e9:.3f} TB/s", flush=True)
    del flat
    for label, row in (("probe", probe), ("flash", flash),
                       ("decode", decode)):
        print(f"  {label}: wrapper {row['ms']:.4f} ms (CUDA events), kernels "
              f"alone {row['kernel_only_ms']:.4f} ms (torch.profiler), "
              f"library {row['library_ms']:.4f} ms", flush=True)

    # Expected-Attention scores: one layer's full prefill cache
    rep = H // Hk
    kf, vf = rn(B, S, Hk, D), rn(B, S, Hk, D)
    mu = rn(Hk, rep, D, scale=0.2, dtype=torch.float32)
    var = torch.rand((Hk, rep, D), generator=gen, device=dev) * 0.1
    ea_case(kf, vf, mu, var, KEEP, f"main-path B={B} S={S}",
            errs["expected_attention"])
    check(ea_kernel.vector_path(kf, vf),
          "ea: the main path's caches do not take the vector path")
    ea = {
        "ms": time_ms(lambda: ea_ops.ea_scores(kf, vf, mu, var), 20),
        "plain_ms": time_ms(lambda: ea_ref.ea_scores_ref(kf, vf, mu, var), 5),
        "library_ms": None,    # no one PyTorch call computes the scores
        "earlier_ms": time_ms(lambda: ea_kernel.ea_scores_scalar(kf, vf, mu,
                                                                 var), 20),
    }
    ea["kernel_only_ms"] = kernel_alone_ms(
        lambda: ea_ops.ea_scores(kf, vf, mu, var), "ea", ea["ms"])
    e_bytes = 2 * 2 * kf.numel() + 2 * 4 * mu.numel() + 4 * B * S * Hk
    e_ops = B * S * Hk * (4 * rep * D + 2 * D)
    del kf, vf
    # what a plain read reaches here: torch.sum over as many contiguous
    # bytes as the scores read (K and V)
    flat = torch.empty(2 * B * S * Hk * D, dtype=torch.bfloat16, device=dev)
    flat.normal_(generator=gen)
    ea["read_ms"] = time_ms(lambda: torch.sum(flat, dtype=torch.float32), 20)
    del flat
    print(f"  ea: {ea['ms']:.4f} ms (kernels alone {ea['kernel_only_ms']:.4f} "
          f"ms, torch.profiler) = {e_bytes / ea['ms'] / 1e9:.3f} TB/s; "
          f"earlier design (the scalar-load path) {ea['earlier_ms']:.4f} ms; "
          f"plain chain {ea['plain_ms']:.4f} ms; torch.sum over "
          f"{4 * B * S * Hk * D / 1e6:.1f} MB contiguous {ea['read_ms']:.4f} "
          f"ms = {4 * B * S * Hk * D / ea['read_ms'] / 1e9:.3f} TB/s",
          flush=True)

    rows = []
    for name, replaces, lib, m, (bms, by), shape in (
            ("cosine_topk", "src/repro/kernels/cosine_topk/kernel.py:153",
             "chain: torch.matmul + compare-sum + torch.topk", probe,
             bound(p_bytes, p_ops), f"N={n} d={d} B={b} T={t} k={k}"),
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:74",
             "F.scaled_dot_product_attention(is_causal, enable_gqa)", flash,
             bound(f_bytes, f_ops, bf16_peak),
             f"B={B} S={S} H={H} Hkv={Hk} D={D} causal bf16"),
            ("decode_attention",
             "src/repro/kernels/decode_attention/kernel.py:62",
             "F.scaled_dot_product_attention(enable_gqa) on the valid slots",
             decode, bound(d_bytes, d_ops, bf16_peak),
             f"B={B} L={CAPACITY} valid={valids[0]}..{valids[-1]} H={H} "
             f"Hkv={Hk} D={D} bf16"),
            ("expected_attention",
             "src/repro/kernels/expected_attention/kernel.py:41",
             "none (no one PyTorch call); plain: the torch chain", ea,
             bound(e_bytes, e_ops), f"B={B} S={S} Hkv={Hk} rep={rep} D={D} "
             "bf16")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(errs[name]), **m,
                     "bound_ms": bms, "bound_by": by, "library_call": lib,
                     "shape": shape})
    return rows[:1] + assign_rows + rows[1:]


NEW_ROWS = [   # entry point -> the TPU kernel (or XLA scan) it replaces
    ("cosine_probe_masked", "src/repro/kernels/cosine_topk/kernel.py:266"),
    ("cosine_probe_batch_masked",
     "src/repro/kernels/cosine_topk/kernel.py:328"),
    ("cosine_probe_batch_masked_tiled",
     "src/repro/kernels/cosine_topk/kernel.py:551"),
    ("cosine_probe_rowmask", "src/repro/kernels/cosine_topk/kernel.py:398"),
    ("cosine_probe_batch_rowmask",
     "src/repro/kernels/cosine_topk/kernel.py:456"),
    ("cosine_probe_batch_rowmask_tiled",
     "src/repro/kernels/cosine_topk/kernel.py:503"),
    ("cosine_compound", "src/repro/index/clustered.py:83 _compound_masked_xla "
     "and src/repro/index/mutable.py:92 _tail_compound_xla (jitted XLA, not "
     "Pallas)"),
]


def measure_index(dev, name_card, shapes, launches, errs):
    """The seven entry points of the index and mutable paths at their real
    shapes: the masked probes on the rows the K = 512 index gathers for the
    first query's plan (B = 3), a 64-nearest cover of one predicate (B = 1)
    and a 37-predicate batch; the rowmask probes on the mutable phase's hot
    tail; the compound launch on the first query's conjunction. Each is
    checked against its plain version, then timed beside its plain version,
    the matmul + compare-sum + topk chain on the same rows and its bound
    (the live rows of the m, which are all the kernel reads, plus the mask).
    The gather's own time is beside it."""
    import numpy as np
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref

    bw, f32_peak, _ = peaks(name_card)
    index = shapes["index"]
    d = index.embeddings.shape[1]

    def tens(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    p3, t3 = tens(shapes["p3"]), tens(shapes["t3"])[:, None]
    p37, t37 = tens(shapes["p37"]), tens(shapes["t37"])[:, None]
    p200, t200 = tens(shapes["p200"]), tens(shapes["t200"])[:, None]

    def library(buf, p, t, k):
        def run():
            dist = 1.0 - torch.matmul(p, buf.T)
            (dist[:, None, :] <= t[:, :, None]).sum(dim=-1)
            torch.topk(dist, min(k, buf.shape[0]), dim=1, largest=False)
        return run

    def bound(m, b, t, k, mask, live):
        """The live rows read (the kernel reads no dead row), the mask,
        predicates, thresholds and outputs; the live rows' operations."""
        nbytes = 4 * (live * d + b * d + b * t + b * t + b * k) + 4 * m * mask
        tb, to = nbytes / bw * 1e3, (2 * live * d * b + live * b * (1 + t)) \
            / f32_peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    rows = []

    def timed(name, m, b, t, k, fn, plain, lib, mask, live):
        """Time ``fn`` (one call of the entry point) by CUDA events and its
        kernels alone under torch.profiler, which also counts them."""
        bms, by = bound(m, b, t, k, mask, m if live is None else live)
        iters = 50 if b <= 37 else 10
        ms = time_ms(fn, iters, 10 if b <= 37 else 2)
        alone, kernels = kernel_alone_ms(fn, name, ms, count=True)
        check(kernels <= 2, f"{name}: {kernels} kernels a call (at most 2: "
                            "the scan and the merge)")
        print(f"  {name}: m={m} B={b}: wrapper {ms:.4f} ms (CUDA events), "
              f"kernels alone {alone:.4f} ms ({kernels} a call, "
              f"torch.profiler), plain {plain:.4f} ms, library chain "
              f"{lib:.4f} ms ({'at or under' if ms <= lib else 'OVER'} it), "
              f"bound {bms:.4f} ms ({by})", flush=True)
        return {"ms": ms, "kernel_only_ms": alone, "kernels_a_call": kernels,
                "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "library_ms": lib}

    def row(name, replaces, m, b, t, k, fn, plain, lib, extra, mask=0,
            live=None):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/cosine_topk.cu",
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": max(errs[name]),
                     **timed(name, m, b, t, k, fn, plain, lib, mask, live),
                     "library_call": "chain: torch.matmul + compare-sum + "
                                     "torch.topk on the same rows",
                     **extra})
        if "gather_ms" in extra:
            print(f"    gather {extra['gather_ms']:.4f} ms", flush=True)

    where = dict(NEW_ROWS)
    # the scalar launch where kth_smallest makes it: its first chunk, the
    # clusters of lowest lower bound up to chunk_rows rows
    lb, _ = index.cluster_bounds(shapes["p3"][:1])
    order = np.argsort(lb[0], kind="stable")
    first = order[:int(np.searchsorted(np.cumsum(index.sizes[order]),
                                       index.chunk_rows)) + 1]
    for name, ph, th, k, need in (
            ("cosine_probe_masked", shapes["p3"][:1], shapes["t3"][:1], 64,
             None),
            ("cosine_probe_batch_masked", shapes["p3"], shapes["t3"], 1,
             False),
            ("cosine_probe_batch_masked_tiled", shapes["p37"], shapes["t37"],
             8, True)):
        p, t = tens(ph), tens(th)[:, None]
        if need is None:
            ids = first
        else:
            ids = index.plan_scan(ph, th[:, None], k=k,
                                  need_topk=need).scan_ids
            if not len(ids):    # every cluster resolved: the top-k cover
                ids = index.plan_scan(ph, th[:, None], k=k).scan_ids
        buf, m = index._gather(ids)
        b = p.shape[0]
        masked_case(buf, p, t, k, f"{name} at the index's m={m}", errs,
                    n_valid=m)

        def run(buf=buf, m=m, p=p, t=t, k=k, p0=p[0], t0=t[0]):
            if p.shape[0] == 1:
                return ops.cosine_probe_masked(buf, m, p0, t0, k=k)
            return ops.cosine_probe_batch_masked(buf, m, p, t, k=k)

        def plain(buf=buf, m=m, p=p, t=t, k=k):
            return ref.cosine_probe_batch_masked_ref(buf, m, p, t, k)

        def gather(ids=ids):
            return index._gather(ids)

        row(name, where[name], m, b, 1, k, run,
            time_ms(plain, 5), time_ms(library(buf[:m], p, t, k), 20),
            {"gather_ms": time_ms(gather, 20),
             "shape": f"m={m} of {index.n} d={d} B={b} T=1 k={k}",
             "scan_fraction": m / index.n})
        if need:     # the tiled row: also its 200-predicate batch
            p2, t2 = tens(shapes["p200"]), tens(shapes["t200"])[:, None]
            ids2 = index.plan_scan(shapes["p200"], shapes["t200"][:, None],
                                   k=k).scan_ids
            buf2, m2 = index._gather(ids2)
            masked_case(buf2, p2, t2, k, f"{name} B=200 at the index's "
                        f"m={m2}", errs, n_valid=m2)
            rows[-1]["at_b200"] = {
                **timed(name, m2, 200, 1, k, lambda: ops.cosine_probe_batch_masked(
                    buf2, m2, p2, t2, k=k), time_ms(
                        lambda: ref.cosine_probe_batch_masked_ref(
                            buf2, m2, p2, t2, k), 2, 1),
                    time_ms(library(buf2[:m2], p2, t2, k), 5), 0, None),
                "shape": f"m={m2} of {index.n} d={d} B=200 T=1 k={k}"}
            del buf2
        del buf

    temb, tmask = shapes["tail"]
    m = temb.shape[0]
    for name, p, t in (("cosine_probe_rowmask", p3[:1], t3[:1]),
                       ("cosine_probe_batch_rowmask", p3, t3),
                       ("cosine_probe_batch_rowmask_tiled", p37, t37)):
        b = p.shape[0]
        masked_case(temb, p, t, 1, f"{name} on the hot tail", errs,
                    mask=tmask)

        def run(p=p, t=t, p0=p[0], t0=t[0]):
            if p.shape[0] == 1:
                return ops.cosine_probe_rowmask(temb, tmask, p0, t0, k=1)
            return ops.cosine_probe_batch_rowmask(temb, tmask, p, t, k=1)

        def plain(p=p, t=t):
            return ref.cosine_probe_batch_rowmask_ref(temb, tmask, p, t, 1)

        live = int(tmask.sum())
        row(name, where[name], m, b, 1, 1, run,
            time_ms(plain, 5), time_ms(library(temb, p, t, 1), 20),
            {"shape": f"tail m={m} ({live} live) d={d} B={b} T=1 k=1"},
            mask=1, live=live)
        if name.endswith("_tiled"):   # also its 200-predicate batch
            masked_case(temb, p200, t200, 1, f"{name} B=200 on the hot tail",
                        errs, mask=tmask)
            rows[-1]["at_b200"] = {
                **timed(name, m, 200, 1, 1,
                        lambda: ops.cosine_probe_batch_rowmask(
                            temb, tmask, p200, t200, k=1),
                        time_ms(lambda: ref.cosine_probe_batch_rowmask_ref(
                            temb, tmask, p200, t200, 1), 5),
                        time_ms(library(temb, p200, t200, 1), 20), 1, live),
                "shape": f"tail m={m} ({live} live) d={d} B=200 T=1 k=1"}

    plan = index.plan_compound(shapes["p3"], shapes["t3"], mode="and")
    if not plan.m:
        plan = index.plan_compound(shapes["p3"], shapes["t3"], mode="or")
    buf, m = index._gather(plan.scan_ids)
    t1 = t3[:, 0].contiguous()
    compound_case(buf, p3, t1, "and", f"compound at the index's m={m}", errs,
                  n_valid=m)

    def lib_compound():
        match = (1.0 - torch.matmul(p3, buf.T)) <= t1[:, None]
        match.all(dim=0).sum()

    row("cosine_compound", where["cosine_compound"], m, 3, 1, 0,
        lambda: ops.cosine_compound_count(buf, p3, t1, mode="and",
                                          n_valid=m),
        time_ms(lambda: ref.cosine_compound_count_ref(buf, p3, t1,
                                                      mode="and"), 5),
        time_ms(lib_compound, 20),
        {"gather_ms": time_ms(lambda: index._gather(plan.scan_ids), 20),
         "shape": f"m={m} of {index.n} d={d} B=3 conjuncts",
         "library_call": "chain: torch.matmul + compare + all + sum"})
    return rows


# ------------------------------------------------------------------ phase 6

H2O_BATCH, H2O_SEQ, H2O_STEPS = 2, 8192, 16   # longer than the 4096 window
H2O_BLOCK = 256          # query blocks of the plain flash check
LAYER_BATCH, LAYER_SEQ, LAYER_STEPS = 1, 2048, 8
SIGLIP_BATCH = 4
MAMBA_BATCH, MAMBA_SEQ, MAMBA_STEPS = 2, 4096, 8
SMOKE_BATCH, SMOKE_SEQ = 2, 24
TF_TOL = 0.15            # decode vs the teacher-forced full forward, bf16:
                         # tests/test_arch_smoke.py's tolerance
SMOKE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # kernels vs plain, logits
EXACT_TOL = 1e-3         # float32 MoE dispatch and MLA absorbed decode
ZOO_ROWS = [  # (name, source kernel, the TPU kernel it replaces)
    ("flash_attention_d80", "flash_attention",
     "src/repro/kernels/flash_attention/kernel.py:74"),
    ("flash_attention_d72", "flash_attention",
     "src/repro/kernels/flash_attention/kernel.py:74"),
    ("decode_attention_d80_rep4", "decode_attention",
     "src/repro/kernels/decode_attention/kernel.py:62"),
    ("decode_attention_d128_rep16_fp8", "decode_attention",
     "src/repro/kernels/decode_attention/kernel.py:62"),
    ("expected_attention_d80", "expected_attention",
     "src/repro/kernels/expected_attention/kernel.py:41"),
    ("expected_attention_rep16_fp8", "expected_attention",
     "src/repro/kernels/expected_attention/kernel.py:41"),
]


def zoo_config(arch: str, smoke: bool = False):
    """An architecture's registered config (the host rehearsal shrinks it
    here)."""
    from repro_torch.configs import get_config

    return get_config(arch, smoke=smoke)


def zoo_counts() -> dict:
    from repro_torch.models import layers

    mods = kernel_modules()
    return {"flash": mods["flash_attention"].launches,
            "flash_bwd": mods["flash_attention_bwd"].launches,
            "decode": mods["decode_attention"].launches,
            "ea": mods["expected_attention"].launches,
            "plain": layers.plain_attention_calls}


def count_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in zoo_counts().items()}


@contextlib.contextmanager
def counts_kept():
    """Launches inside the block (the checks against plain versions) leave
    the attention kernels' counters and the plain-route count as they
    were."""
    from repro_torch.models import layers

    mods = kernel_modules()
    names = ("flash_attention", "decode_attention", "expected_attention",
             "flash_attention_bwd")
    saved = {n: (mods[n].launches, dict(getattr(mods[n], "path_launches", {})))
             for n in names}
    plain = layers.plain_attention_calls
    try:
        yield
    finally:
        for n, (c, paths) in saved.items():
            mods[n].launches = c
            mods[n].path_launches.update(paths) if paths else None
        layers.plain_attention_calls = plain


@contextlib.contextmanager
def plain_attention():
    """The models' ``sdpa`` routed to the kernels' plain versions (on the
    card), for a run to compare the kernel path with."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import encdec, layers

    def plain(q, k, v, *, causal=True, window=None, q_offset=0,
              kv_valid=None, scale=None):
        if q.shape[1] > 1:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
        return decode_attention_ref(q, k, v, kv_valid=kv_valid, scale=scale)

    saved = layers.sdpa, encdec.sdpa
    layers.sdpa = encdec.sdpa = plain
    try:
        yield
    finally:
        layers.sdpa, encdec.sdpa = saved


def events_ms(fn) -> tuple[float, object]:
    """(device ms of one call by CUDA events, its result)."""
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def qkv_of(p, x, cfg, positions):
    """An attention layer's rope'd q, k and its v on hidden states x (the
    layer's own projections, before the block's norm)."""
    from repro_torch.models.layers import apply_rope, project, rmsnorm

    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    a = p["mixer"]
    return (apply_rope(project(h, a["wq"]), positions, cfg.rope_theta),
            apply_rope(project(h, a["wk"]), positions, cfg.rope_theta),
            project(h, a["wv"]))


def flash_blocks_case(q, k, v, window, label, errs):
    """The flash kernel on a whole (B, S) prefill, held to the plain
    version on its first and last H2O_BLOCK queries (the plain version
    over all S x S scores would not fit)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.layers import sdpa_reference

    S, n = q.shape[1], H2O_BLOCK
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    for q0 in (0, S - n):
        k0 = max(0, q0 - window + 1) if window else 0
        ref = lambda *t: sdpa_reference(  # noqa: E731
            t[0][:, q0:q0 + n], t[1][:, k0:q0 + n], t[2][:, k0:q0 + n],
            causal=True, window=window, q_offset=q0 - k0)
        close_case(f"{label} queries {q0}..{q0 + n - 1}", got[:, q0:q0 + n],
                   ref(q, k, v), ATTN_TOL["bfloat16"], errs,
                   exact=ref(q.float(), k.float(), v.float()))
    return got


def logits_case(label, got, want, tol):
    """Two logits tensors within atol = rtol = tol, finite; prints the
    largest error and how often the argmax agrees."""
    import torch

    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite logits")
    err = float((g - w).abs().max())
    check(bool(torch.allclose(g, w, atol=tol, rtol=tol)),
          f"{label}: max error {err} beyond atol = rtol = {tol}")
    same = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    print(f"  {label}: ok (max err {err:.3e}, tol {tol}; argmax agrees on "
          f"{same:.3f})", flush=True)


def h2o_path(dev, gen, errs, timing):
    """h2o-danube-1.8b at full width and depth: prefill B x S past the
    window, compress layer 0's ring, then decode steps into the ring."""
    import math

    import torch
    from repro_torch.models import lm, nn, steps
    from repro_torch.serving.compress import (calibration_q_stats,
                                              compress_cache)

    cfg = zoo_config("h2o-danube-1.8b")
    L, W = cfg.num_layers, cfg.window
    params = nn.init_params(steps.model_specs(cfg), gen)
    n_params = sum(t.numel() for t in nn.tree_leaves(params))
    B, S, T = H2O_BATCH, H2O_SEQ, H2O_STEPS
    check(S > W, f"h2o: a prefill of {S} does not pass the window {W}")
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), generator=gen,
                         device=dev)
    calib = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                          device=dev)
    prefill = steps.make_prefill_step(cfg, batch=B, max_len=S + T)
    decode = steps.make_decode_step(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    prefill_ms, (last, cache) = events_ms(
        lambda: prefill(params, {"tokens": toks[:, :S]}))
    after_prefill = zoo_counts()
    ring = {n: t.clone() for n, t in cache[0].items()}   # layer 0, prefilled
    qstats = calibration_q_stats(params, cfg, calib)
    after_calib = zoo_counts()
    kc, vc, _ = compress_cache(ring["k"], ring["v"], qstats.mu[0],
                               qstats.var[0], rate=RATE)
    torch.cuda.synchronize()
    step_ms, step_logits, step_q = [], [], []
    for t in range(T):
        ms, (lg, cache) = events_ms(lambda: decode(
            params, cache, {"tokens": toks[:, S + t:S + t + 1]}, S + t))
        step_ms.append(ms)
        step_logits.append(lg)
        with counts_kept():     # layer 0's attention at this step
            x0 = params["embed"][toks[:, S + t:S + t + 1]].to(
                cfg.compute_dtype)
            q, _, _ = qkv_of(params["layers"][0], x0, cfg,
                             torch.tensor([S + t], device=dev))
            decode_case(q, cache[0]["k"], cache[0]["v"], min(S + t + 1, W),
                        f"h2o layer 0 decode step {t}", errs["decode_attention"],
                        ATTN_TOL["bfloat16"])
    counts = zoo_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(after_prefill == {"flash": L, "flash_bwd": 0, "decode": 0, "ea": 0,
                            "plain": 0},
          f"h2o prefill counts {after_prefill}, expected {L} flash launches")
    check(counts["decode"] == L * T and counts["ea"] == 1
          and counts["plain"] == 0
          and counts["flash"] == after_calib["flash"] == 2 * L,
          f"h2o counts {counts}")
    check(cache[0]["k"].shape[1] == W
          and kc.shape[1] == math.ceil(W * (1.0 - RATE)),
          f"h2o ring {tuple(cache[0]['k'].shape)}, compressed "
          f"{tuple(kc.shape)}")
    dec_ms = sum(step_ms[1:]) / max(1, T - 1)
    print(f"h2o-danube-1.8b: {n_params / 1e9:.3f} B params, {L} layers, "
          f"prefill B={B} S={S} (window {W}: ring of {W} slots) "
          f"{prefill_ms:.1f} ms; decode {dec_ms:.3f} ms a step (steps 2.."
          f"{T}; first {step_ms[0]:.3f} ms); launches: prefill flash "
          f"{after_prefill['flash']}, calibration flash "
          f"{after_calib['flash'] - after_prefill['flash']}, EA "
          f"{counts['ea']}, decode {counts['decode']} ({L} a step); "
          f"plain_attention_calls {counts['plain']}; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    timing["h2o"] = {"prefill_ms": prefill_ms, "decode_ms": dec_ms,
                     "flash": counts["flash"], "decode": counts["decode"],
                     "ea": counts["ea"]}

    with counts_kept():
        x0 = params["embed"][toks[:, :S]].to(cfg.compute_dtype)
        q, k, v = qkv_of(params["layers"][0], x0, cfg,
                         torch.arange(S, device=dev))
        del x0
        flash_blocks_case(q, k, v, W, f"h2o layer 0 flash B={B} S={S} D=80",
                          errs["flash_attention"])
        timing["h2o_qkv"] = (q, k, v)
        full, _, _ = lm.lm_apply(params, cfg, tokens=toks,
                                 positions=torch.arange(S + T, device=dev),
                                 mode="prefill")
        logits_case("h2o prefill logits vs the full forward", last,
                    full[:, S - 1], TF_TOL)
        for t in range(T):
            logits_case(f"h2o decode step {t} vs the teacher-forced full "
                        "forward", step_logits[t], full[:, S + t], TF_TOL)
        del full
        mu, var = qstats.mu[0], qstats.var[0]
        ea_case(ring["k"], ring["v"], mu, var, kc.shape[1],
                f"h2o layer 0 ring B={B} S={W} D=80 rep 4 (compress_cache "
                f"rate {RATE})", errs["expected_attention"])
        timing["h2o_ea"] = (ring["k"], ring["v"], mu, var)
        timing["h2o_ring"] = cache[0]
    del params, cache


def one_layer(arch, dev, gen, errs, *, B, S, T, label, layer=0):
    """One full-width layer of ``arch`` (its ``layer``-th kind) through
    ``lm.block_apply``: a prefill of B x S seeded hidden states into a
    cache, then T decode steps. Returns (params, cache, inputs, the
    per-call count deltas, times)."""
    import torch
    from repro_torch.models import lm, nn

    cfg = zoo_config(arch)
    mixer, mlp = lm.stack_kinds(cfg)[layer]
    p = nn.init_params(lm.block_specs(cfg, mixer, mlp), gen)
    cache = nn.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=dev),
                        lm.block_cache_specs(cfg, mixer, B, S + T))
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(
        cfg.compute_dtype)
    xs = torch.randn((T, B, 1, cfg.d_model), generator=gen, device=dev).to(
        cfg.compute_dtype)
    before = zoo_counts()
    pre_ms, (y, cache, aux) = events_ms(lambda: lm.block_apply(
        p, x, cfg=cfg, mixer_kind=mixer, mlp_kind=mlp,
        positions=torch.arange(S, device=dev), cache=cache, cache_index=None,
        mode="prefill"))
    d_prefill = count_delta(before)
    before = zoo_counts()
    ys, dec_ms = [], []
    for t in range(T):
        ms, (yt, cache, _) = events_ms(lambda: lm.block_apply(
            p, xs[t], cfg=cfg, mixer_kind=mixer, mlp_kind=mlp,
            positions=torch.tensor([S + t], device=dev), cache=cache,
            cache_index=S + t, mode="decode"))
        ys.append(yt)
        dec_ms.append(ms)
    d_decode = count_delta(before)
    n_params = sum(t.numel() for t in nn.tree_leaves(p))
    check(bool(torch.isfinite(y).all())
          and all(bool(torch.isfinite(t).all()) for t in ys),
          f"{label}: non-finite layer output")
    print(f"{label}: one layer ({mixer}, {mlp} MLP), {n_params / 1e9:.3f} B "
          f"params; prefill B={B} S={S} {pre_ms:.2f} ms, decode "
          f"{sum(dec_ms[1:]) / max(1, T - 1):.3f} ms a step; launches "
          f"prefill {d_prefill}, decode {d_decode}; cache "
          f"{[str(t.dtype) for t in cache.values()]}", flush=True)
    return cfg, p, cache, (x, xs), (d_prefill, d_decode), (mixer, mlp)


def attention_layer_checks(cfg, p, cache, inputs, label, errs, dev,
                           fp8=False):
    """The layer's flash call and each decode step against the plain
    versions, on the layer's own q, k, v and its cache."""
    import torch

    x, xs = inputs
    S = x.shape[1]
    q, k, v = qkv_of(p, x, cfg, torch.arange(S, device=dev))
    flash_case(q, k, v, f"{label} layer prefill S={S}", errs["flash_attention"])
    for t in range(xs.shape[0]):
        qt, _, _ = qkv_of(p, xs[t], cfg, torch.tensor([S + t], device=dev))
        decode_case(qt, cache["k"], cache["v"], S + t + 1,
                    f"{label} decode step {t}" + (" (fp8 cache)" if fp8
                                                  else ""),
                    errs["decode_attention"], ATTN_TOL["bfloat16"])
    return q, k, v


def moe_plain(p, x, cfg):
    """The MoE layer's function written directly: per expert, its first C
    (token, k) assignments in token order, their SwiGLU weighted by the
    renormalised gates and added back to the tokens; plus the shared
    experts."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.layers import mlp_apply

    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    C = max(1, int(S * K * m.capacity_factor / E))
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gv, gi = torch.topk(probs, K, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for b in range(B):
        flat = gi[b].reshape(-1)                       # (S K,) token order
        for e in range(E):
            sel = (flat == e).nonzero()[:, 0][:C]
            tok, kk = sel // K, sel % K
            h = x[b, tok]
            out = (F.silu(h @ p["we_gate"][e]) * (h @ p["we_up"][e])) \
                @ p["we_down"][e]
            y[b].index_add_(0, tok, out * gv[b, tok, kk, None])
    if m.num_shared:
        y = y + mlp_apply(p["shared"], x)
    return y


def deepseek_checks(cfg, p, dev, gen):
    """In float32: the MoE dispatch against ``moe_plain``, and MLA's
    absorbed decode against its expanded prefill one token longer."""
    import dataclasses

    import torch
    from repro_torch.models import layers, nn

    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    p32 = nn.tree_map(lambda t: t.float(), p)
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device=dev)
    y, aux = layers.moe_apply(p32["mlp"], x, cfg=cfg32)
    want = moe_plain(p32["mlp"], x, cfg32)
    err = float((y - want).abs().max())
    check(bool(torch.allclose(y, want, atol=EXACT_TOL, rtol=EXACT_TOL)),
          f"deepseek MoE dispatch: max error {err} against the direct sum")
    print(f"  deepseek MoE dispatch (64 experts, top 6, 2 shared) vs the "
          f"direct per-expert sum, float32: ok (max err {err:.2e}, tol "
          f"{EXACT_TOL}; drop share {float(aux['moe_drop_frac']):.4f}, "
          f"load-balance loss {float(aux['moe_lb_loss']):.4f})", flush=True)
    S = 64
    x = torch.randn((1, S + 1, cfg.d_model), generator=gen, device=dev) * 0.5
    full, _ = layers.mla_apply(p32["mixer"], x, cfg=cfg32,
                               positions=torch.arange(S + 1, device=dev),
                               mode="prefill")
    cache = nn.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=dev),
                        layers.make_mla_cache_specs(cfg32, 1, S + 1))
    layers.mla_apply(p32["mixer"], x[:, :S], cfg=cfg32,
                     positions=torch.arange(S, device=dev), cache=cache,
                     mode="prefill")
    yt, _ = layers.mla_apply(p32["mixer"], x[:, S:], cfg=cfg32,
                             positions=torch.tensor([S], device=dev),
                             cache=cache, cache_index=S, mode="decode")
    err = float((yt[:, 0] - full[:, S]).abs().max())
    check(bool(torch.allclose(yt[:, 0], full[:, S], atol=EXACT_TOL,
                              rtol=EXACT_TOL)),
          f"deepseek MLA absorbed decode: max error {err} against expanded")
    print(f"  deepseek MLA absorbed decode (576 vs 512, one latent head) vs "
          f"the expanded prefill (192 vs 128), float32: ok (max err "
          f"{err:.2e}, tol {EXACT_TOL})", flush=True)


def mamba_path(dev, gen):
    """mamba2-130m at full width and depth: prefill, decode steps, and the
    decode logits against the teacher-forced full forward."""
    import torch
    from repro_torch.models import lm, nn, steps

    cfg = zoo_config("mamba2-130m")
    params = nn.init_params(steps.model_specs(cfg), gen)
    B, S, T = MAMBA_BATCH, MAMBA_SEQ, MAMBA_STEPS
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), generator=gen,
                         device=dev)
    before = zoo_counts()
    pre_ms, (last, cache) = events_ms(lambda: steps.make_prefill_step(
        cfg, batch=B, max_len=S + T)(params, {"tokens": toks[:, :S]}))
    decode = steps.make_decode_step(cfg)
    dec, step_ms = [], []
    for t in range(T):
        ms, (lg, cache) = events_ms(lambda: decode(
            params, cache, {"tokens": toks[:, S + t:S + t + 1]}, S + t))
        dec.append(lg)
        step_ms.append(ms)
    delta = count_delta(before)
    check(delta == {"flash": 0, "flash_bwd": 0, "decode": 0, "ea": 0,
                    "plain": 0},
          f"mamba2: attention launches {delta} in an attention-free model")
    print(f"mamba2-130m: {cfg.num_layers} layers d={cfg.d_model}, "
          f"{sum(t.numel() for t in nn.tree_leaves(params)) / 1e6:.1f} M "
          f"params; prefill B={B} S={S} {pre_ms:.1f} ms; decode "
          f"{sum(step_ms[1:]) / max(1, T - 1):.3f} ms a step (SSD in plain "
          f"torch: no attention kernel)", flush=True)
    full, _, _ = lm.lm_apply(params, cfg, tokens=toks,
                             positions=torch.arange(S + T, device=dev),
                             mode="prefill")
    logits_case("mamba2 prefill logits vs the full forward", last,
                full[:, S - 1], TF_TOL)
    for t in range(T):
        logits_case(f"mamba2 decode step {t} vs the teacher-forced full "
                    "forward", dec[t], full[:, S + t], TF_TOL)


def smoke_archs(dev, gen):
    """Every registered architecture's smoke config on the card, in
    float32 and bfloat16: a prefill and 2 decode steps through the kernels,
    then the same params and inputs through the plain attention; the
    logits finite and within SMOKE_TOL."""
    import dataclasses

    import torch
    from repro_torch.configs import list_archs
    from repro_torch.models import nn, steps

    archs = list_archs()
    for arch in archs:
        for dtype in ("float32", "bfloat16"):
            cfg = zoo_config(arch, smoke=True)
            if dtype == "float32":
                cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                          compute_dtype=torch.float32)
            params = nn.init_params(steps.model_specs(cfg), gen)
            inputs = steps.stub_inputs(cfg, SMOKE_BATCH, SMOKE_SEQ, gen)
            pos = (inputs["tokens"].shape[1] if cfg.encdec else SMOKE_SEQ)
            enc_len = SMOKE_SEQ if cfg.encdec else 0
            toks = torch.randint(0, cfg.vocab_size, (2, SMOKE_BATCH, 1),
                                 generator=gen, device=dev)

            def run():
                lg, cache = steps.make_prefill_step(
                    cfg, batch=SMOKE_BATCH, max_len=pos + 2,
                    enc_len=enc_len)(params, inputs)
                out = [lg]
                decode = steps.make_decode_step(cfg)
                for t in range(2):
                    lg, cache = decode(params, cache, {"tokens": toks[t]},
                                       pos + t)
                    out.append(lg)
                return out

            before = zoo_counts()
            got = run()
            delta = count_delta(before)
            with plain_attention(), counts_kept():
                want = run()
            attn = not cfg.attention_free
            mla = cfg.mla is not None
            check((delta["flash"] > 0) == (attn and not mla)
                  and (delta["decode"] > 0) == (attn and not mla)
                  and (delta["plain"] > 0) == mla,
                  f"{arch} {dtype}: launches {delta}")
            for t, (g, w) in enumerate(zip(got, want)):
                logits_case(f"smoke {arch} {dtype} "
                            + ("prefill" if t == 0 else f"decode {t}")
                            + f" (launches {delta})" * (t == 0),
                            g, w, SMOKE_TOL[dtype])
    return len(archs)


def zoo_rows(dev, gen, name_card, timing, errs):
    """The zoo's new kernel shapes timed beside their bounds, plain
    versions and library calls: rows of the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.expected_attention import ops as ea_ops
    from repro_torch.kernels.expected_attention import ref as ea_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.layers import sdpa_reference

    bw, f32_peak, bf16_peak = peaks(name_card)
    srcs = {name: (src, replaces) for name, src, replaces in ZOO_ROWS}
    rows = []

    def row(name, run, plain, library, library_call, shape, nbytes, nops,
            peak, iters=20, plain_iters=5):
        """Time ``run`` (CUDA events, then its kernels alone), its plain
        version and the library call; the bound from the bytes and
        operations the function needs."""
        ms = time_ms(run, iters, 2)
        alone = kernel_alone_ms(run, name, ms)
        plain_ms = time_ms(plain, plain_iters, 1)
        lib_ms = None if library is None else time_ms(library, iters, 2)
        tb, to = nbytes / bw * 1e3, nops / peak * 1e3
        bms, by = (tb, "bytes") if tb >= to else (to, "operations")
        src, replaces = srcs[name]
        print(f"  {name}: {ms:.4f} ms (kernels alone {alone:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library {lib_ms}, bound {bms:.4f} ms "
              f"({by}); {shape}", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}.cu",
                     "replaces": replaces,
                     "launches": timing["launches"][name],
                     "max_abs_err": max(errs[src]), "ms": ms,
                     "kernel_only_ms": alone, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_call": library_call,
                     "bound_ms": bms, "bound_by": by, "shape": shape})

    def pairs(S, W):     # visible (query, key) pairs of a causal window
        return sum(min(r + 1, W) if W else r + 1 for r in range(S))

    # flash at D = 80: h2o layer 0's prefill (window 4096); the plain
    # version in blocks of 1024 queries, each over the keys it can see
    q, k, v = timing.pop("h2o_qkv")
    B, S, H, D = q.shape
    W = timing["window"]
    mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril() \
        & ~torch.ones((S, S), dtype=torch.bool, device=dev).tril(-W)
    rep = H // k.shape[2]
    ke, ve = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))

    def plain_blocks():
        for q0 in range(0, S, 1024):
            k0 = max(0, q0 - W + 1)
            sdpa_reference(q[:, q0:q0 + 1024], k[:, k0:q0 + 1024],
                           v[:, k0:q0 + 1024], causal=True, window=W,
                           q_offset=q0 - k0)

    row("flash_attention_d80",
        lambda: fa_ops.flash_attention(q, k, v, window=W), plain_blocks,
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ke, ve,
                                               attn_mask=mask),
        "F.scaled_dot_product_attention(attn_mask: the causal window), K/V "
        "expanded to the query heads",
        f"B={B} S={S} H={H} Hkv={k.shape[2]} D={D} window={W} bf16",
        2 * (2 * q.numel() + 2 * k.numel()), 4 * B * H * D * pairs(S, W),
        bf16_peak, iters=5, plain_iters=1)
    del q, k, v, ke, ve, mask

    # flash at D = 72: siglip-text's layer (MHA), causal
    q, k, v = timing.pop("siglip_qkv")
    B, S, H, D = q.shape
    row("flash_attention_d72", lambda: fa_ops.flash_attention(q, k, v),
        lambda: [sdpa_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                 for i in range(B)],
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True),
        "F.scaled_dot_product_attention(is_causal)",
        f"B={B} S={S} H={H} Hkv={H} D={D} causal bf16",
        2 * (2 * q.numel() + 2 * k.numel()), 4 * B * H * D * pairs(S, 0),
        bf16_peak, iters=10, plain_iters=2)
    del q, k, v

    # decode at D = 80, rep 4: h2o layer 0's full ring (every slot valid)
    ring = timing.pop("h2o_ring")
    kc, vc = ring["k"], ring["v"]
    B, L, Hk, D = kc.shape
    q = torch.randn((B, 1, Hk * 4, D), generator=gen, device=dev).to(kc.dtype)
    decode_case(q, kc, vc, L, "h2o ring, every slot", errs["decode_attention"],
                ATTN_TOL["bfloat16"])
    row("decode_attention_d80_rep4",
        lambda: da_ops.decode_attention(q, kc, vc, kv_valid=L),
        lambda: da_ref.decode_attention_ref(q, kc, vc, kv_valid=L),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            enable_gqa=True),
        "F.scaled_dot_product_attention(enable_gqa)",
        f"B={B} L={L} valid={L} H={Hk * 4} Hkv={Hk} D={D} bf16",
        2 * 2 * kc.numel() + 2 * 2 * q.numel(), 4 * B * Hk * 4 * D * L,
        bf16_peak)
    del ring, kc, vc, q

    # decode at D = 128, rep 16 on the fp8 cache: llama3-405b's layer
    kc, vc, q = timing.pop("llama_cache")
    B, L, Hk, D = kc.shape
    k16, v16 = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    row("decode_attention_d128_rep16_fp8",
        lambda: da_ops.decode_attention(q, kc, vc, kv_valid=L),
        lambda: da_ref.decode_attention_ref(q, kc, vc, kv_valid=L),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k16.transpose(1, 2), v16.transpose(1, 2),
            enable_gqa=True),
        "F.scaled_dot_product_attention(enable_gqa) on the cache upcast to "
        "bf16 (it takes no fp8)",
        f"B={B} L={L} valid={L} H={q.shape[2]} Hkv={Hk} D={D} fp8 e4m3 "
        "cache, bf16 q",
        2 * kc.numel() + 2 * 2 * q.numel(), 4 * B * q.shape[2] * D * L,
        bf16_peak)
    del k16, v16

    # EA at D = 80 (h2o's ring, the vector path) and at rep 16 (llama3's
    # fp8 cache, the scalar-load path)
    for name, (kk, vv, mu, var) in (
            ("expected_attention_d80", timing.pop("h2o_ea")),
            ("expected_attention_rep16_fp8",
             (kc, vc, *timing.pop("llama_stats")))):
        B, S, Hk, D = kk.shape
        rp = mu.shape[1]
        row(name, lambda: ea_ops.ea_scores(kk, vv, mu, var),
            lambda: ea_ref.ea_scores_ref(kk, vv, mu, var), None,
            "none (no one PyTorch call)",
            f"B={B} S={S} Hkv={Hk} rep={rp} D={D} {kk.dtype}",
            2 * kk.numel() * kk.element_size() + 2 * 4 * mu.numel()
            + 4 * B * S * Hk, B * S * Hk * (4 * rp * D + 2 * D), f32_peak)
    del kc, vc
    return rows


def zoo_path(dev, gen, name_card, errs):
    """The model zoo on the card (phase 6): h2o-danube at full width and
    depth, one full-width layer each of llama3-405b, siglip-text,
    llava-next-34b and deepseek-v2-lite, mamba2-130m whole, every smoke
    config through the kernels against the plain attention, then the new
    shapes' timing rows. Every model is freed before it returns."""
    import torch

    t0 = time.perf_counter()
    timing = {"window": zoo_config("h2o-danube-1.8b").window}
    h2o_path(dev, gen, errs, timing)
    torch.cuda.empty_cache()

    cfg, p, cache, inputs, (d_pre, d_dec), _ = one_layer(
        "llama3-405b", dev, gen, errs, B=LAYER_BATCH, S=LAYER_SEQ,
        T=LAYER_STEPS, label="llama3-405b")
    check(cache["k"].dtype == torch.float8_e4m3fn and cfg.num_heads
          // cfg.num_kv_heads == 16, "llama3-405b: not an fp8 rep-16 cache")
    check(d_pre["flash"] == 1 and d_dec["decode"] == LAYER_STEPS
          and d_pre["plain"] == d_dec["plain"] == 0,
          f"llama3-405b launches {d_pre} {d_dec}")
    attention_layer_checks(cfg, p, cache, inputs, "llama3-405b", errs, dev,
                           fp8=True)
    x, xs = inputs
    L = x.shape[1] + LAYER_STEPS
    kc, vc = cache["k"][:, :L], cache["v"][:, :L]
    mu = torch.randn((cfg.num_kv_heads, 16, cfg.head_dim), generator=gen,
                     device=dev) * 0.2
    var = torch.rand((cfg.num_kv_heads, 16, cfg.head_dim), generator=gen,
                     device=dev) * 0.1
    from repro_torch.kernels.expected_attention import kernel as ea_kernel
    from repro_torch.kernels.expected_attention import ops as ea_ops
    from repro_torch.kernels.expected_attention import ref as ea_ref
    from repro_torch.models.layers import apply_rope, project, rmsnorm
    before = zoo_counts()
    got = ea_ops.ea_scores(kc, vc, mu, var)
    ea_launches = count_delta(before)["ea"]
    want = ea_ref.ea_scores_ref(kc, vc, mu, var)
    rel = float(((got - want).abs() / want.abs()).max())
    check(ea_launches == 1 and not ea_kernel.vector_path(kc, vc)
          and rel <= EA_RTOL,
          f"llama3-405b EA rep 16 on the fp8 cache: relative error {rel}")
    errs["expected_attention"].append(float((got - want).abs().max()))
    print(f"  ea llama3-405b fp8 cache L={L} rep 16 (scalar-load path): ok "
          f"(max rel err {rel:.2e})", flush=True)
    h = rmsnorm(p["ln1"], xs[-1], cfg.rms_eps)
    qd = apply_rope(project(h, p["mixer"]["wq"]),
                    torch.tensor([L - 1], device=dev), cfg.rope_theta)
    timing["llama_cache"] = (kc, vc, qd)
    timing["llama_stats"] = (mu, var)
    llama = {"flash": d_pre["flash"], "decode": d_dec["decode"],
             "ea": ea_launches}
    del p, cache, inputs, x, xs, h
    torch.cuda.empty_cache()

    cfg, p, cache, inputs, (d_pre, d_dec), _ = one_layer(
        "siglip-text-so400m", dev, gen, errs, B=SIGLIP_BATCH, S=LAYER_SEQ,
        T=LAYER_STEPS, label="siglip-text-so400m")
    check(cfg.head_dim == 72 and cfg.num_heads == cfg.num_kv_heads
          and d_pre["flash"] == 1 and d_dec["decode"] == LAYER_STEPS,
          f"siglip-text: D {cfg.head_dim}, launches {d_pre} {d_dec}")
    timing["siglip_qkv"] = attention_layer_checks(
        cfg, p, cache, inputs, "siglip-text-so400m", errs, dev)
    siglip_flash = d_pre["flash"]
    del p, cache, inputs

    cfg, p, cache, inputs, (d_pre, d_dec), _ = one_layer(
        "llava-next-34b", dev, gen, errs, B=LAYER_BATCH, S=LAYER_SEQ,
        T=LAYER_STEPS, label="llava-next-34b")
    check(cache["k"].dtype == torch.float8_e4m3fn
          and cfg.num_heads // cfg.num_kv_heads == 7
          and d_pre["flash"] == 1 and d_dec["decode"] == LAYER_STEPS,
          f"llava-next-34b: launches {d_pre} {d_dec}")
    attention_layer_checks(cfg, p, cache, inputs, "llava-next-34b", errs,
                           dev, fp8=True)
    del p, cache, inputs
    torch.cuda.empty_cache()

    cfg, p, cache, inputs, (d_pre, d_dec), kinds = one_layer(
        "deepseek-v2-lite-16b", dev, gen, errs, B=LAYER_BATCH, S=LAYER_SEQ,
        T=LAYER_STEPS, label="deepseek-v2-lite-16b", layer=1)
    check(kinds == ("mla", "moe") and d_pre["flash"] == d_dec["decode"] == 0
          and d_pre["plain"] == 1 and d_dec["plain"] == LAYER_STEPS,
          f"deepseek-v2-lite: kinds {kinds}, launches {d_pre} {d_dec}")
    print(f"  deepseek-v2-lite plain_attention_calls: prefill "
          f"{d_pre['plain']}, decode {d_dec['plain']} (MLA's route: q/k "
          f"{cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim} vs v "
          f"{cfg.mla.v_head_dim}, absorbed {cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim}"
          f" vs {cfg.mla.kv_lora_rank})", flush=True)
    deepseek_checks(cfg, p, dev, gen)
    del p, cache, inputs
    torch.cuda.empty_cache()

    mamba_path(dev, gen)
    torch.cuda.empty_cache()
    n_smoke = smoke_archs(dev, gen)
    print(f"smoke configs: {n_smoke} archs, float32 and bfloat16, kernels "
          f"vs the plain attention: ok", flush=True)

    h2o = timing["h2o"]
    timing["launches"] = {
        "flash_attention_d80": h2o["flash"],
        "flash_attention_d72": siglip_flash,
        "decode_attention_d80_rep4": h2o["decode"],
        "decode_attention_d128_rep16_fp8": llama["decode"],
        "expected_attention_d80": h2o["ea"],
        "expected_attention_rep16_fp8": llama["ea"]}
    rows = zoo_rows(dev, gen, name_card, timing, errs)
    timing.clear()
    torch.cuda.empty_cache()
    print(f"zoo path: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# ------------------------------------------------------------------ phase 7

# FlashAttention on the card: (label, B, S, Hkv, rep, D, window, dtypes)
TRAIN_FLASH = [
    ("smollm D 64 rep 3", 1, 4096, 5, 3, 64, None, ("bfloat16", "float32")),
    ("h2o D 80 rep 4", 1, 4096, 8, 4, 80, None, ("bfloat16", "float32")),
    ("h2o D 80 window 4096", 1, 8192, 2, 4, 80, 4096, ("bfloat16",
                                                        "float32")),
    ("D 128 rep 2", 1, 4096, 4, 2, 128, None, ("bfloat16", "float32")),
]
TRAIN_SHAPE = (4, 4096, 5, 3, 64)   # smollm's microbatch: B S Hkv rep D
LSE_TOL = 1e-4          # lse in float32 from the same inputs, either dtype
GRAD_REL = 1e-3          # dq, dk, dv against autograd, float32, rel Frobenius
BWD_REL = 5e-2           # the bf16 backward kernel against the plain one:
#                          P and dS are rounded to bf16 for the tensor cores
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 4, 32
LOSS_TOL, PARAM_TOL, UPDATE_FLOOR = 1e-4, 1e-5, 1e-6
ADAM_EPS = 1e-8
TRAIN_ARGS = ["--arch", "smollm-360m", "--no-smoke", "--seq", "4096",
              "--batch", "8", "--microbatches", "2", "--steps", "8",
              "--ckpt-every", "8", "--device", "cuda"]
FAIL_STEP = 3            # the step whose second microbatch raises once
LOSS_DROP = 0.10         # the repeated batch's loss falls by at least this


def flash_train_cases(dev, gen, errs):
    """``FlashAttention`` on the card at the training shapes: the kernel's
    output and lse against the plain chunked forward, and in float32 its
    gradients (the backward kernel on the CUDA cores) against autograd
    through direct attention."""
    import math

    import torch
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models import flash_ref, layers

    for label, B, S, hkv, rep, D, window, dtypes in TRAIN_FLASH:
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                       .to(dt) for h in (hkv * rep, hkv, hkv))
            scale = 1.0 / math.sqrt(D)
            with counts_kept():
                out, lse = kernel.flash_fwd(q, k, v, causal=True,
                                            window=window, scale=scale,
                                            return_lse=True)
            want, want_lse = flash_ref.flash_forward_plain(
                q, k, v, causal=True, window=window, scale=scale)
            close_case(f"{label} {dtype} out vs the plain chunked forward",
                       out, want, ATTN_TOL[dtype], errs["flash_attention"])
            err = float((lse - want_lse).abs().max())
            check(err <= LSE_TOL, f"{label} {dtype}: lse error {err}")
            print(f"  {label} {dtype} lse: ok (max err {err:.2e}, tol "
                  f"{LSE_TOL})", flush=True)
            if dtype != "float32":
                continue
            dout = torch.randn(q.shape, generator=gen, device=dev)
            args = [t.clone().requires_grad_() for t in (q, k, v)]
            with counts_kept():
                got = torch.autograd.grad(flash_ref.flash_attention_ref(
                    *args, causal=True, window=window), args, dout)
            args = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = torch.autograd.grad(layers.sdpa_reference(
                *args, causal=True, window=window), args, dout)
            for name, g, w in zip("qkv", got, ref):
                r = float((g - w).norm() / w.norm())
                check(r <= GRAD_REL, f"{label}: d{name} relative error {r}")
            print(f"  {label} float32 grads vs autograd through direct "
                  f"attention: ok (dq dk dv within {GRAD_REL} relative)",
                  flush=True)
            del dout, args, got, ref
        del q, k, v, out, lse, want, want_lse
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_sdpa():
    """The models' ``sdpa`` routed to ``sdpa_plain`` (plain torch under
    autograd, on the card), for a train step to compare the kernel route
    with."""
    from repro_torch.models import encdec, layers

    saved = layers.sdpa, encdec.sdpa
    layers.sdpa = encdec.sdpa = layers.sdpa_plain
    try:
        yield
    finally:
        layers.sdpa, encdec.sdpa = saved


def attention_calls(cfg) -> int:
    """Multi-token attention calls in one forward of ``cfg``: an LM's
    "attn" layers (MLA takes the plain route), an encoder-decoder's
    encoder layers and its decoder's self- and cross-attention."""
    from repro_torch.models import lm

    if cfg.encdec:
        return (cfg.num_enc_layers or cfg.num_layers) + 2 * cfg.num_layers
    return sum(mixer == "attn" for mixer, _ in lm.stack_kinds(cfg))


@contextlib.contextmanager
def step_gradients(seen):
    """``make_train_step``'s AdamW, made inside this block, appends the
    gradients it is handed to ``seen``."""
    from repro_torch.models import steps

    real = steps.adamw_update

    def record(grads, *a, **kw):
        seen.append(grads)
        return real(grads, *a, **kw)

    steps.adamw_update = record
    try:
        yield
    finally:
        steps.adamw_update = real


def smoke_train_steps(dev, gen):
    """Every assigned smoke config in float32: one 2-microbatch
    ``make_train_step`` through the kernels, then through the plain route
    from the same state. Flash launches: one per attention call, remat's
    second forward included; backward launches: one per attention call.
    The loss within LOSS_TOL, every leaf of the
    gradients the optimizer was handed within GRAD_REL relative
    Frobenius, the parameters within PARAM_TOL where the clipped gradient
    is at least UPDATE_FLOOR, and everywhere within lr |dg| / (min |g| +
    eps) + PARAM_TOL for the two routes' clipped gradients' gap dg (min |g|
    0 where their signs differ): AdamW's first step moves an element by
    lr g / (|g| + eps), which turns float32 summation noise in a gradient
    near 0 into its rate. The share of elements below the floor is
    printed."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ASSIGNED
    from repro_torch.data.pipeline import synth_lm_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import nn, steps
    from repro_torch.optim.adamw import clip_scale

    lr = 0.1
    for arch in ASSIGNED:
        cfg = dataclasses.replace(zoo_config(arch, smoke=True),
                                  param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_lm_batch(
            cfg, ShapeConfig("t", TRAIN_SMOKE_SEQ, TRAIN_SMOKE_BATCH,
                             "train"), 0).items()}
        state = steps.make_train_state(cfg, gen, dev)
        other = nn.tree_map(torch.clone, state)
        seen = []
        with step_gradients(seen):
            step = steps.make_train_step(cfg, num_microbatches=2, peak_lr=lr,
                                         warmup=1)
        c0 = zoo_counts()
        _, m_k = step(state, batch)
        delta = count_delta(c0)
        with plain_sdpa(), counts_kept():
            _, m_p = step(other, batch)
        g_k, g_p = (nn.tree_leaves(g) for g in seen)
        check(cfg.remat == "full" and cfg.remat_group <= 1,
              f"train {arch}: remat {cfg.remat} group {cfg.remat_group}")
        # 2 microbatches, each forward run again by remat in the backward;
        # one backward launch an attention call a microbatch
        want = attention_calls(cfg) * 2 * 2
        check(delta["flash"] == want and delta["flash_bwd"] == want // 2
              and delta["decode"] == 0,
              f"train {arch}: launches {delta}, flash {want} and flash_bwd "
              f"{want // 2} expected")
        loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
        check(np.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_TOL,
              f"train {arch}: loss {loss_k} vs plain {loss_p}")
        worst = max(float((a - b).norm() / max(float(b.norm()), 1e-12))
                    for a, b in zip(g_k, g_p))
        check(worst <= GRAD_REL, f"train {arch}: gradient relative error "
                                 f"{worst}")
        s_k, s_p = clip_scale(g_k, 1.0), clip_scale(g_p, 1.0)
        worst_p, n_low, n = 0.0, 0, 0
        for p, w, a, b in zip(nn.tree_leaves(state["params"]),
                              nn.tree_leaves(other["params"]), g_k, g_p):
            a, b = a * s_k, b * s_p
            low = a.abs() < UPDATE_FLOOR
            g_min = torch.where(a * b > 0, torch.minimum(a.abs(), b.abs()),
                                0.0)
            err = (p - w).abs()
            worst_p = max(worst_p, float(torch.where(low, 0.0, err).max()))
            check(bool((err <= lr * (a - b).abs() / (g_min + ADAM_EPS)
                        + PARAM_TOL).all()),
                  f"train {arch}: a parameter past the gradient gap's bound")
            n_low += int(low.sum())
            n += low.numel()
        check(worst_p <= PARAM_TOL, f"train {arch}: parameters {worst_p} "
                                    "from the plain route's")
        print(f"  train {arch} float32: loss {loss_k:.6f} (plain "
              f"{loss_p:.6f}), gradients within {worst:.2e}, parameters "
              f"within {worst_p:.2e} where the clipped gradient >= "
              f"{UPDATE_FLOOR} ({n_low / n:.2e} of the elements below, held "
              f"to the gradient gap's bound); launches {delta}", flush=True)
        del state, other, seen, g_k, g_p
    return len(ASSIGNED)


def smollm_train(dev, name_card, keep):
    """smollm-360m at full width and depth through ``launch/train.py``'s
    code path (``build`` + ``execute``): 8 steps on one batch of 8 x 4096
    tokens (the data pipeline's step 0, every step, so the loss must
    fall) in 2 microbatches, bf16 params, AdamW in float32,
    remat full. One injected failure (the second microbatch of step
    FAIL_STEP raises once): the runner retries, and the state after that
    step is bitwise the state the step gives without the failure. The
    runner's checkpoint at step 8, restored, is bitwise the final state.
    The replayed step runs under ``analysis.cost.CostMode`` (every
    microbatch counted; the kernels' ctypes launches unseen). ``keep``
    gets what the tooling phase reads later: the config, the checkpoint
    directory (a ``TemporaryDirectory``), the final state on the host, the
    replay's count and the steady step ms. Returns (flash launches over
    the 8 steps, backward launches over them, step ms)."""
    import math
    import tempfile

    import torch
    from repro_torch.analysis.cost import CostMode
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import nn, steps

    mods = kernel_modules()
    keep["ckpt"] = tempfile.TemporaryDirectory()
    ckpt_dir = keep["ckpt"].name
    args = train.parse_args(TRAIN_ARGS + ["--ckpt-dir", ckpt_dir])
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the earlier phases' tensors
    run = train.build(args)
    batches = list(run.data)             # drains the prefetch thread
    run.data = [batches[0]] * len(batches)
    del batches
    cfg, state = run.cfg, run.state
    n_params = sum(t.numel() for t in nn.tree_leaves(state["params"]))
    check(cfg.num_layers == 32 and cfg.d_model == 960
          and cfg.head_dim == 64 and cfg.vocab_size == 49152
          and cfg.tie_embeddings and cfg.remat == "full"
          and state["params"]["embed"].dtype == torch.bfloat16
          and state["opt"]["m"]["embed"].dtype == torch.float32,
          f"smollm-360m: not the full config ({cfg})")
    inner = run.runner.step_fn
    real_loss = steps.loss_fn
    ms, flash, bwd, bwd_wgmma, snaps = [], [], [], [], {}
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected transient failure")
        return real_loss(*a, **kw)

    def step_fn(state, batch):
        k = len(ms)
        if k == FAIL_STEP and "before" not in snaps:
            snaps["before"] = nn.tree_map(torch.clone, state)
            steps.loss_fn = flaky
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        n0 = mods["flash_attention"].launches
        b0 = mods["flash_attention_bwd"].launches
        w0 = mods["flash_attention_bwd"].path_launches["wgmma"]
        a.record()
        try:
            out = inner(state, batch)
        finally:
            steps.loss_fn = real_loss
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        flash.append(mods["flash_attention"].launches - n0)
        bwd.append(mods["flash_attention_bwd"].launches - b0)
        bwd_wgmma.append(mods["flash_attention_bwd"].path_launches["wgmma"]
                         - w0)
        if k == FAIL_STEP:
            snaps["after"] = nn.tree_map(torch.clone, state)
        return out

    run.runner.step_fn = step_fn
    zero_counts()
    result = train.execute(run)
    launches = mods["flash_attention"].launches
    bwd_launches = mods["flash_attention_bwd"].launches
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    losses = result["losses"]
    check(all(math.isfinite(x) for x in losses)
          and losses[-1] <= (1 - LOSS_DROP) * losses[0],
          f"smollm-360m: losses {losses} (must fall {LOSS_DROP:.0%})")
    check(run.runner.retries == 1 and run.runner.restores == 0,
          f"smollm-360m: retries {run.runner.retries}, restores "
          f"{run.runner.restores}")
    # the failed step's retry against the same step with no failure
    replay = snaps.pop("before")
    with CostMode() as mode:
        inner(replay, run.data[FAIL_STEP])
    keep["card_cost"] = mode.cost
    same = all(torch.equal(a, b) for a, b in zip(
        nn.tree_leaves(replay), nn.tree_leaves(snaps.pop("after"))))
    check(same, "smollm-360m: the retried step is not bitwise the step "
                "without the failure")
    del replay
    mgr = CheckpointManager(ckpt_dir)
    check(mgr.latest_step() == 8, f"checkpoints: {mgr.latest_step()}")
    t0 = time.perf_counter()
    back = mgr.restore(8, like=state)
    restore_s = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        nn.tree_leaves(back), nn.tree_leaves(state)))
    check(same, "smollm-360m: the restored checkpoint is not bitwise "
                "the state")
    del back
    keep["cfg"] = cfg
    keep["final"] = [t.to("cpu") for t in nn.tree_leaves(state)]
    tokens = 8 * 4096
    steady = ms[1:]
    step_ms = sum(steady) / len(steady)
    keep["step_ms"] = step_ms
    flops = 6 * n_params * tokens
    bf16_peak = peaks(name_card)[2]
    check(all(f == flash[0] for f in flash)
          and flash[0] == 2 * 2 * cfg.num_layers,
          f"smollm-360m: flash launches a step {flash}")
    # a step's list holds its run that returned; the failed attempt (its
    # first microbatch's backward ran before the second one's loss raised)
    # counts in the run's total only
    check(all(n == 2 * cfg.num_layers for n in bwd)
          and bwd_launches == sum(bwd) + cfg.num_layers,
          f"smollm-360m: backward launches a step {bwd} ({bwd_launches} "
          f"over the run)")
    # bf16 at D 64 on 16-byte rows: every backward takes the wgmma kernels
    check(bwd_wgmma == bwd,
          f"smollm-360m: wgmma-path backward launches a step {bwd_wgmma}, "
          f"all launches {bwd}")
    print(f"smollm-360m train: {cfg.num_layers} layers d={cfg.d_model} "
          f"{n_params / 1e6:.1f} M params, batch 8 x 4096 in 2 microbatches,"
          f" bf16 params, AdamW float32, remat full; {name_card}", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]} (fell "
          f"{1 - losses[-1] / losses[0]:.1%}); step ms {[round(x, 1) for x in ms]}"
          f"; steady {step_ms:.1f} ms a step, {tokens / step_ms * 1e3:.0f} "
          f"tokens/s, 6 N tokens / step time = "
          f"{flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
          f"{flops / (step_ms / 1e3) / bf16_peak:.1%} of "
          f"{bf16_peak / 1e12:.0f} TFLOP/s; peak "
          f"memory {peak:.2f} GiB above the earlier phases'; flash launches {flash[0]} a step (32 "
          f"layers x 2 microbatches x 2: remat runs each forward again), "
          f"{launches} over the run (the injected failure's first "
          f"microbatch included); backward launches {bwd[0]} a step (32 "
          f"layers x 2 microbatches, {bwd_wgmma[0]} on the wgmma path), "
          f"{bwd_launches} over the run; retry "
          f"bitwise the unfailed step; checkpoint restored bitwise in "
          f"{restore_s:.1f} s", flush=True)
    return launches, bwd_launches, step_ms


def train_rows(dev, gen, name_card, launches, bwd_launches, errs):
    """At smollm's training shape: the flash forward with lse timed beside
    its bound, its plain version and SDPA's forward; the backward kernel
    held to the plain flash backward (BWD_REL per gradient) and timed
    beside it, its bound and SDPA's backward. Returns the kernels line's
    two rows."""
    import math

    import torch
    import torch.nn.functional as F
    from repro_torch.analysis import cost
    from repro_torch.kernels.flash_attention import backward, kernel
    from repro_torch.models import flash_ref

    bw, _, bf16_peak = peaks(name_card)
    B, S, hkv, rep, D = TRAIN_SHAPE
    H = hkv * rep
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               .to(torch.bfloat16) for h in (H, hkv, hkv))
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    with counts_kept():
        out, lse = kernel.flash_fwd(q, k, v, causal=True, window=None,
                                    scale=scale, return_lse=True)
        want, _ = flash_ref.flash_forward_plain(q, k, v, causal=True,
                                                window=None, scale=scale)
        close_case("smollm training shape bf16 out", out, want,
                   ATTN_TOL["bfloat16"], errs["flash_attention"])
        fwd = lambda: kernel.flash_fwd(q, k, v, causal=True,  # noqa: E731
                                       window=None, scale=scale,
                                       return_lse=True)
        serve = lambda: kernel.flash_fwd(q, k, v, causal=True,  # noqa: E731
                                         window=None, scale=scale)
        ms = time_ms(fwd, 20)
        alone = kernel_alone_ms(fwd, "flash_attention_lse", ms)
        serve_ms = time_ms(serve, 20)
        ms2 = time_ms(fwd, 20)
        plain_ms = time_ms(lambda: flash_ref.flash_forward_plain(
            q, k, v, causal=True, window=None, scale=scale), 3, 1)
        bwd_ms = time_ms(lambda: flash_ref.flash_backward(
            q, k, v, out, lse, dout, causal=True, window=None, scale=scale),
            3, 1)
        bwd = lambda: backward.flash_bwd(  # noqa: E731
            q, k, v, out, lse, dout, causal=True, window=None, scale=scale)
        got = bwd()
        want = flash_ref.flash_backward(q, k, v, out, lse, dout, causal=True,
                                        window=None, scale=scale)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            r = float((a.float() - b.float()).norm() / b.float().norm())
            check(r <= BWD_REL, f"backward kernel at the training shape: "
                                f"{name} relative error {r}")
            errs["flash_attention_bwd"].append(
                float((a.float() - b.float()).abs().max()))
        again = bwd()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "backward kernel: two calls are not bitwise equal")
        del got, want, again
        check(backward.wgmma_path(q, k, v, out, dout),
              "backward kernel at the training shape: not the wgmma path")
        k_ms = time_ms(bwd, 20)
        per, fell = {}, len(FELL_BACK)
        k_alone, k_count = kernel_alone_ms(bwd, "flash_attention_bwd", k_ms,
                                           count=True, by_name=per)
        k_ms2 = time_ms(bwd, 20)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_ms = time_ms(sdpa, 20)
    o = sdpa()
    g = dout.transpose(1, 2)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g,
                                                     retain_graph=True), 10)
    pairs = S * (S + 1) // 2
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * H * S
    nops = 4 * B * H * D * pairs
    tb, to = nbytes / bw * 1e3, nops / bf16_peak * 1e3
    bms, by = (tb, "bytes") if tb >= to else (to, "operations")
    # the backward: reads q k v out dout lse, writes dq dk dv; recomputes
    # S, then dP, dV, dK, dQ: five products over the visible pairs (the
    # kernel issues seven: its dq pass recomputes S and dP)
    bbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * B * H * S
    bops = 10 * B * H * D * pairs
    issued = cost.attention_bwd_flops(q, v, pairs)
    # each launch's device time; None where the profiler kept no record
    # of it (or no device time at all: k_alone is then the events' time)
    launch_ms = {part: (sum(t for name, t in per.items() if key in name)
                        if len(FELL_BACK) == fell
                        and any(key in name for name in per) else None)
                 for part, key in (("stats", "bwd_delta"),
                                   ("dkdv", "bwd_dkdv"), ("dq", "bwd_dq"))}
    each = ", ".join(f"{label} " + ("not measured" if launch_ms[part] is None
                                    else f"{launch_ms[part]:.4f}")
                     for part, label in (("stats", "stats"),
                                         ("dkdv", "dk/dv"), ("dq", "dq")))
    btb, bto = bbytes / bw * 1e3, bops / bf16_peak * 1e3
    bbms, bby = (btb, "bytes") if btb >= bto else (bto, "operations")
    shape = f"B={B} S={S} H={H} Hkv={hkv} D={D} causal bf16"
    print(f"train shape ({shape}; {name_card}): flash forward with lse "
          f"{ms:.4f} / {ms2:.4f} ms (kernels alone {alone:.4f} ms), without "
          f"lse {serve_ms:.4f} ms, plain chunked forward {plain_ms:.4f} ms, "
          f"SDPA forward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
          f"backward kernel {k_ms:.4f} / {k_ms2:.4f} ms (kernels alone "
          f"{k_alone:.4f} ms over {k_count} launches a call: {each}; "
          f"{issued:.4e} FLOP issued "
          f"(cost.attention_bwd_flops), {issued / k_ms / 1e9:.1f} TFLOP/s, "
          f"{bops / k_ms / 1e9:.1f} counting five products; share of the "
          f"bound {bbms / k_ms:.3f}), plain flash backward {bwd_ms:.4f} ms, "
          f"SDPA backward {lib_bwd_ms:.4f} ms ({k_ms / lib_bwd_ms:.2f}x it), "
          f"bound {bbms:.4f} ms ({bby}); gradients within {BWD_REL} "
          f"relative of the plain backward's, two calls bitwise equal",
          flush=True)
    bwd_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/flash_ref.py:110 flash_bwd (XLA, not "
                    "Pallas: no TPU kernel)",
        # a step: 32 layers x 2 microbatches, as smollm_train checks
        "launches": bwd_launches, "launches_a_step": 2 * 32,
        "max_abs_err": max(errs["flash_attention_bwd"]), "ms": k_ms,
        "kernel_only_ms": k_alone, "launch_ms": launch_ms,
        "plain_ms": bwd_ms,
        "library_ms": lib_bwd_ms,
        "library_call": "torch.autograd.grad through "
                        "F.scaled_dot_product_attention(is_causal, "
                        "enable_gqa)",
        "bound_ms": bbms, "bound_by": bby, "shape": shape}
    return [{"name": "flash_attention_lse", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:74",
            "launches": launches,
            "max_abs_err": max(errs["flash_attention"]), "ms": ms,
            "kernel_only_ms": alone, "serve_ms": serve_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_call": "F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa)",
            "bound_ms": bms, "bound_by": by, "shape": shape}, bwd_row]


def train_path(dev, gen, name_card, errs, keep):
    """The training phase: FlashAttention at the training shapes, every
    smoke config's train step kernels vs plain, smollm-360m trained at
    full width (``keep``: see ``smollm_train``), then the flash-with-lse
    row and the backward's times."""
    import torch

    t0 = time.perf_counter()
    flash_train_cases(dev, gen, errs)
    n = smoke_train_steps(dev, gen)
    print(f"train steps: {n} smoke configs, float32, kernels vs plain: ok",
          flush=True)
    torch.cuda.empty_cache()
    launches, bwd_launches, _ = smollm_train(dev, name_card, keep)
    torch.cuda.empty_cache()
    rows = train_rows(dev, gen, name_card, launches, bwd_launches, errs)
    torch.cuda.empty_cache()
    print(f"train path: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def profiler_after_sharded(dev, gen) -> None:
    """What outlives the sharded and fleet runs: the threads still alive,
    and whether a torch.profiler window still sees device time."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    alive = [t for t in threading.enumerate()
             if t is not threading.main_thread()]
    print(f"threads alive after the sharded phase: {len(alive)} "
          f"{[(t.name, t.daemon) for t in alive]}", flush=True)
    q, k, v = (torch.randn((1, 1024, h, HEAD_DIM), generator=gen,
                           device=dev).to(torch.bfloat16) for h in (8, 2, 2))
    fn = lambda: ops.flash_attention(q, k, v)  # noqa: E731
    events = time_ms(fn, 10)
    fell = len(FELL_BACK)
    alone = kernel_alone_ms(fn, "flash after the sharded phase", events)
    print(f"profiler window after the sharded phase: flash {alone:.4f} ms "
          f"alone, {events:.4f} ms by events; "
          + ("saw no device time" if len(FELL_BACK) > fell
             else "saw device time"), flush=True)


DRYRUN_CELLS = [("smollm-360m", "train_4k", "pod"),
                ("h2o-danube-1.8b", "prefill_32k", "pod"),
                ("llama3-405b", "decode_32k", "multipod")]
ALLREDUCE_TOL = 0.02     # int8 two-stage sum against 8 g, as the reference


def dryrun_cells(name_card) -> None:
    """Three dry-run cells through ``dryrun.run_cell`` on the meta device,
    into a temporary directory, each artifact read back and checked."""
    from repro_torch.launch import dryrun

    with tempfile.TemporaryDirectory() as out:
        for arch, shape, mesh in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, mesh, out_dir=Path(out),
                                  force=True, card=name_card)
            path = Path(out) / f"{arch}__{shape}__{mesh}.json"
            back = json.loads(path.read_text())
            mem, cost, roof = back["memory"], back["cost"], back["roofline"]
            check(back["cell"] == rec["cell"] and back["device"] == "meta"
                  and mem["bytes_per_device"] > 0 and cost["flops_global"] > 0
                  and cost["hbm_bytes_global"] > 0
                  and roof["compute_term"] > 0 and roof["memory_term"] > 0
                  and roof["bottleneck"] in ("compute", "memory")
                  and back["wire_bytes"] is None
                  and back["activation_placements"],
                  f"dry-run {rec['cell']}: artifact {back}")
            print(f"dry-run {back['cell']} (meta device, host {back['wall_s']:.1f} s): "
                  f"{mem['bytes_per_device'] / 1e9:.3f} GB a device "
                  f"(fits {mem['fits']}); counted {cost['flops_global']:.4e} "
                  f"FLOPs, {cost['hbm_bytes_global']:.4e} bytes (global); "
                  f"model {back['model_flops_global']:.4e} FLOPs; per device "
                  f"compute {roof['compute_term']:.4e} s, memory "
                  f"{roof['memory_term']:.4e} s at {roof['card']} peaks; "
                  f"bottleneck {roof['bottleneck']}", flush=True)


def smollm_roofline(name_card, trained) -> None:
    """Phase 7's smollm-360m step (B 8 x S 4096, 2 microbatches, remat
    full, AdamW) counted on the meta device against the measured step,
    and beside the count of one real step on the card."""
    import torch
    from repro_torch.analysis import cost, roofline
    from repro_torch.models import flash_ref, nn, steps

    cfg, step_ms = trained["cfg"], trained["step_ms"]
    state = steps.make_train_state(cfg, abstract=True)
    batch = {k: torch.empty((8, 4096), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    _, c = cost.count(steps.make_train_step(cfg, num_microbatches=2), state,
                      batch)
    count_s = time.perf_counter() - t0
    n = nn.count_params(steps.model_specs(cfg))
    model = 6.0 * n * 8 * 4096
    r = roofline.analyze(c, model_flops=model, card=name_card)
    p = roofline.peaks(name_card)
    step_s = step_ms / 1e3
    flash = c.ops["flash_attention"]["flops"]
    fb = c.ops["flash_attention_bwd"]
    card = trained["card_cost"]
    # the card's count sees neither flash kernel: ctypes launches
    gap = abs(c.flops - flash - fb["flops"] - card.flops) / c.flops
    check(card.flops < c.flops and gap < 0.01
          and fb["count"] == 2 * cfg.num_layers,
          f"smollm step: card count {card.flops:.4e}, meta {c.flops:.4e}, "
          f"meta's flash forward {flash:.4e} and backward {fb['flops']:.4e} "
          f"over {fb['count']} calls (gap {gap:.2%})")
    print(f"smollm-360m step against its roofline ({name_card}): counted on "
          f"the meta device in {count_s:.1f} s: {c.flops:.4e} FLOPs "
          f"({ {k: f'{v:.4e}' for k, v in c.flops_by_dtype.items()} }), "
          f"{c.hbm_bytes:.4e} bytes; compute term {r.compute_term * 1e3:.2f} "
          f"ms, memory term {r.memory_term * 1e3:.2f} ms ({r.bottleneck}); "
          f"measured steady step {step_ms:.2f} ms = "
          f"{step_ms / 1e3 / max(r.compute_term, r.memory_term):.2f}x the "
          f"larger term; model-FLOPs MFU (6 N tokens / step time / "
          f"{p.bf16 / 1e12:.0f} TFLOP/s) {model / step_s / p.bf16:.1%}; "
          f"counted-FLOPs share (compute term / step time) "
          f"{r.compute_term / step_s:.1%}", flush=True)
    # the backward, one fused op a layer a microbatch, beside the plain
    # chunked version at a microbatch's shape counted alone (what the step
    # counted before the kernel)
    B, S, hkv, rep, D = TRAIN_SHAPE
    q = torch.empty((B, S, hkv * rep, D), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((B, S, hkv, D), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((B, hkv * rep, S), device="meta")
    _, plain = cost.count(flash_ref.flash_backward, q, kv, kv, q, lse, q,
                          causal=True, window=None, scale=D ** -0.5)
    calls = fb["count"]
    print(f"  the backward kernel (B {B}, S {S}, {hkv * rep}/{hkv} heads, D "
          f"{D}; one fused op): {fb['bytes'] / calls:.4e} bytes and "
          f"{fb['flops'] / calls:.4e} FLOPs a call, x {calls:.0f} calls = "
          f"{fb['bytes'] / c.hbm_bytes:.1%} of the step's counted bytes "
          f"({fb['bytes'] / p.hbm_bw * 1e3:.2f} ms of the memory term) and "
          f"{fb['flops'] / c.flops:.1%} of its FLOPs; the plain chunked "
          f"backward counted alone: {plain.hbm_bytes:.4e} bytes and "
          f"{plain.flops:.4e} FLOPs a call", flush=True)
    print(f"  one real step on the card under the same mode: "
          f"{card.flops:.4e} FLOPs, {card.hbm_bytes:.4e} bytes; the meta "
          f"count less its flash forward ({flash:.4e} FLOPs) and backward "
          f"({fb['flops']:.4e} FLOPs, the kernels' visible pairs) is "
          f"{c.flops - flash - fb['flops']:.4e}: the difference is the flash "
          f"kernels' work, ctypes launches the dispatch mode cannot see "
          f"(gap {gap:.3%})", flush=True)


def allreduce_check(dev) -> None:
    """``two_stage_allreduce`` on the card over a one-process mesh of 2
    pods x 4 data shards, each holding the same (64, 32) gradient
    (tests/test_multidevice.py's set-up)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.grad_compression import two_stage_allreduce

    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32))
    mesh = Mesh(("pod", "data"), (2, 4))
    local = g.expand(2, 4, 64, 32).contiguous()
    exact = 8.0 * g.to(dev)
    wire = {}
    red = two_stage_allreduce({"w": local.to(dev)}, mesh=mesh, codec="int8",
                              wire=wire)["w"]
    flt = two_stage_allreduce({"w": local.to(dev)}, mesh=mesh,
                              codec="none")["w"]
    rel = float((red[1, 3] - exact).abs().max() / exact.abs().max())
    frel = float(((flt[1, 3] - exact).abs() / exact.abs()).max())
    cpu_red = two_stage_allreduce({"w": local}, mesh=mesh, codec="int8")["w"]
    cpu_flt = two_stage_allreduce({"w": local}, mesh=mesh,
                                  codec="none")["w"]
    same = (torch.equal(red.cpu(), cpu_red)
            and torch.equal(flt.cpu(), cpu_flt)
            and all(torch.equal(red[i, j], red[0, 0])
                    for i in range(2) for j in range(4)))
    check(rel < ALLREDUCE_TOL and frel <= 4 * 2**-24 and same,
          f"two_stage_allreduce: int8 rel err {rel}, float32 {frel}, "
          f"bitwise the CPU's and alike on every shard: {same}")
    print(f"two_stage_allreduce on {dev} (2 pods x 4 data shards, (64, 32) "
          f"float32): int8 rel err {rel:.5f} (< {ALLREDUCE_TOL}), float32 "
          f"rel err {frel:.3g}, bitwise the CPU's; wire bytes a device "
          f"(ring): data {wire['data']:.0f}, pod {wire['pod']:.0f} "
          f"(int32 codes, as the reference sums them, + the scale)",
          flush=True)


def elastic_check(dev, trained) -> None:
    """``plan_mesh`` after losing 12 of 512 chips, then phase 7's step-8
    checkpoint restored by ``elastic_restore`` onto ``make_local_mesh``'s
    placements on the card, bitwise the final state."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import nn, steps
    from repro_torch.runtime.elastic import elastic_restore, plan_mesh

    plan = plan_mesh(500, model_parallel=16)
    check(plan.shape == (31, 16), f"plan_mesh(500): {plan}")
    cfg = trained["cfg"]
    mesh = make_local_mesh(device=dev)
    mgr = CheckpointManager(trained["ckpt"].name)
    check(mgr.latest_step() == 8, f"checkpoints: {mgr.latest_step()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = elastic_restore(mgr, cfg, steps.make_train_state(cfg,
                                                            abstract=True),
                           mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want = nn.tree_leaves(specs.state_shardings(cfg, mesh))
    leaves = nn.tree_leaves(back)
    same = len(leaves) == len(trained["final"]) and all(
        a.device.type == dev.type and a.placement == p and a.dtype == b.dtype
        and torch.equal(a.cpu(), b)
        for a, b, p in zip(leaves, trained["final"], want))
    check(same, "elastic_restore: not bitwise phase 7's final state on the "
                "local mesh's placements")
    print(f"elastic: {plan.reason}; elastic_restore of the step-8 checkpoint "
          f"({len(leaves)} leaves) onto make_local_mesh's placements on "
          f"{dev}: {restore_s:.1f} s, bitwise the final state", flush=True)
    del back, leaves
    trained.pop("final")
    trained.pop("ckpt").cleanup()
    torch.cuda.empty_cache()


def tooling_path(dev, name_card, trained) -> None:
    """The dry-run and roofline tools, the two-stage all-reduce and the
    elastic restore (the phase after the sharded phase)."""
    dryrun_cells(name_card)
    smollm_roofline(name_card, trained)
    allreduce_check(dev)
    elastic_check(dev, trained)


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
    _build.build_all(KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in _build.build_log.items():
        for line in ptxas_summary(log):
            print(f"  {src}: {line}")

    passed = cuda_tests()
    check(passed >= CUDA_TESTS, f"pytest -m cuda: {passed} passed, expected "
                                f"at least {CUDA_TESTS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {name: [] for name in KERNELS + [n for n, _ in NEW_ROWS]}
    t0 = time.perf_counter()
    check_probe(dev, gen, errs)
    check_assign(dev, gen, errs["kmeans_assign"])
    check_attention(dev, gen, errs)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    corpus, estimators, launches, seq_profile = main_path(dev)
    slice_check(dev)
    from repro_torch.core.optimizer import generate_queries

    queries = generate_queries(corpus, n_queries=5, n_filters=3, seed=0)
    t0 = time.perf_counter()
    launches_idx, shapes = index_path(dev, corpus, estimators, queries)
    print(f"index path: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches_mut = mutable_path(dev, estimators["specificity"].hist.embeddings,
                                shapes)
    print(f"mutable path: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_conc = concurrent_path(dev, corpus, estimators, shapes,
                                    seq_profile)
    print(f"concurrent path: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    launches["kmeans_assign_c512"] = (launches_idx["kmeans_assign"]
                                      + launches_mut["kmeans_assign"])
    print(f"assign launches at C={INDEX_CLUSTERS} over the index and mutable "
          f"phases: {launches_idx['kmeans_assign']} + "
          f"{launches_mut['kmeans_assign']}", flush=True)
    rows = measure(dev, gen, card_line, corpus, estimators, launches, errs)
    rows += measure_index(dev, card_line, shapes, {
        name: launches_idx.get(name, 0) + launches_mut.get(name, 0)
        for name, _ in NEW_ROWS}, errs)
    print("phase-5 rows whose kernels-alone time fell back to the CUDA-event "
          f"time: {FELL_BACK or 'none'}", flush=True)
    rows += zoo_path(dev, gen, card_line, errs)
    trained = {}
    rows += train_path(dev, gen, card_line, errs, trained)
    # the sharded phase runs after the kernel timings: run before them, the
    # timings' torch.profiler windows saw no device time
    del shapes["index"]          # the K = 512 index: its rows are timed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_shard = sharded_path(dev, corpus, estimators, shapes,
                                  seq_profile)
    print(f"sharded path: {time.perf_counter() - t0:.1f} s", flush=True)
    profiler_after_sharded(dev, gen)
    t0 = time.perf_counter()
    tooling_path(dev, card_line, trained)
    print(f"tooling path: {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:    # the launches on the concurrent and sharded paths
        if row["name"] == "cosine_topk":
            row["concurrent_launches"] = launches_conc
            row["sharded_launches"] = {
                k: v for k, v in launches_shard.items()
                if k.startswith(("cosine_", "scan_"))}
        elif row["name"] in dict(NEW_ROWS):
            row["concurrent_launches"] = launches_conc.get(row["name"], 0)
            row["sharded_launches"] = launches_shard.get(row["name"], 0)
        elif row["name"] == "kmeans_assign":
            row["sharded_launches"] = launches_shard["kmeans_assign"]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""The plain reference of a plan, and the comparison that decides
``correct``.

For every judged query the reference works out, from the benchmark's own
inputs (the corpus regenerated from the seed, the MLP weights the benchmark
trained, the KV-batch sample the benchmark drew):

  * each filter's text embedding and the specificity MLP's threshold;
  * KV-batch's calibration threshold: the oracle's yes count m on the
    sample, then the midpoint of the m-th and (m+1)-th smallest sample
    distances (paper §3.2);
  * their average (the ensemble, §3.3);
  * the count of rows within a threshold, by a full scan;
  * the plan's order: filters ascending by count, ties kept in query order
    (the program's order is judged against its own planned selectivities,
    which ``sel_gap`` judges against the reference's).

``precision="fp64"`` is the reference: every product in float64.
``precision="tf32"`` is the control put in the program's place: the same
arithmetic with every matrix product's operands rounded to TF32's 10-bit
mantissa and summed in float32, the step below the float32 the
configurations state.

This module imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from semhist_bench.corpus import Tree, oracle_answers, text_embedding

SCAN_ROWS = 1 << 16        # rows of the store a reference block holds
SCAN_PREDS = 2048          # predicates a reference block holds


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp64":
        return a.to(torch.float64) @ b.to(torch.float64)
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    raise ValueError(f"unknown precision {precision!r}")


def mlp_thresholds(params: dict, embs: np.ndarray, precision: str,
                   device) -> np.ndarray:
    """The specificity MLP's thresholds, (F,) float64."""
    n = len(params) // 2
    h = torch.as_tensor(embs, device=device)
    for i in range(n):
        w = torch.as_tensor(params[f"w{i}"], device=device)
        b = torch.as_tensor(params[f"b{i}"], device=device)
        h = matmul(h, w, precision) + b.to(
            torch.float64 if precision == "fp64" else torch.float32)
        if i + 1 < n:
            h = torch.nn.functional.gelu(h, approximate="tanh")
    return (2.0 * torch.sigmoid(h[..., 0])).cpu().numpy().astype(np.float64)


def threshold_from_matches(dists: np.ndarray, m: int) -> float:
    """§3.2: the midpoint of the m-th and (m+1)-th smallest distances; no
    match: just under the smallest; all: just over the largest."""
    order = np.sort(np.asarray(dists, np.float64))
    if m <= 0:
        return float(max(order[0] - 1e-6, 0.0))
    if m >= len(order):
        return float(order[-1] + 1e-6)
    return float(0.5 * (order[m - 1] + order[m]))


@dataclasses.dataclass
class Queries:
    """The judged queries, flattened to one row per filter."""

    nodes: np.ndarray          # (F,) node id of each filter
    seeds: np.ndarray          # (F,) its query's text seed
    start: np.ndarray          # (Q + 1,) filter offsets of each query

    @classmethod
    def of(cls, queries: list[tuple[tuple[int, ...], int]]) -> "Queries":
        nodes = [n for q, _ in queries for n in q]
        seeds = [s for q, s in queries for _ in q]
        start = np.concatenate([[0], np.cumsum([len(q) for q, _ in queries])])
        return cls(np.asarray(nodes, np.int64), np.asarray(seeds, np.int64),
                   start.astype(np.int64))


@dataclasses.dataclass
class Plans:
    """Per filter: the thresholds and count; per query: the filter order
    (as positions into its own filters)."""

    spec: np.ndarray           # (F,) float64
    kvb: np.ndarray            # (F,)
    avg: np.ndarray            # (F,)
    count: np.ndarray          # (F,) int64, rows within ``avg``
    order: list                # per query, a permutation of its filters


def scan_counts(images: torch.Tensor, embs: np.ndarray, thr: np.ndarray,
                precision: str) -> np.ndarray:
    """(F, T) int64 rows of ``images`` whose distance 1 - x.p lies at or
    under each of the filter's T thresholds, by a full scan."""
    dev = images.device
    f, t = thr.shape
    counts = torch.zeros((f, t), dtype=torch.int64, device=dev)
    dt = torch.float64 if precision == "fp64" else torch.float32
    p_all = torch.as_tensor(embs, device=dev)
    thr_all = torch.as_tensor(thr, device=dev).to(dt)
    for i in range(0, images.shape[0], SCAN_ROWS):
        x = images[i:i + SCAN_ROWS]
        for j in range(0, f, SCAN_PREDS):
            d = 1.0 - matmul(x, p_all[j:j + SCAN_PREDS].T, precision)
            within = d[:, :, None] <= thr_all[None, j:j + SCAN_PREDS, :]
            counts[j:j + SCAN_PREDS] += within.sum(dim=0)
    return counts.cpu().numpy()


def solve(tree: Tree, images: torch.Tensor, params: dict,
          sample_ids: np.ndarray, q: Queries, precision: str,
          extra_thr: np.ndarray | None = None
          ) -> tuple[Plans, np.ndarray | None]:
    """The plans of the queries ``q`` at ``precision``; with
    ``extra_thr`` (F,), also the counts at those thresholds (the program's,
    cast to float32 as its probe does), returned second."""
    dev = images.device
    embs = np.stack([text_embedding(tree, int(n), int(s))
                     for n, s in zip(q.nodes, q.seeds)])
    spec = mlp_thresholds(params, embs, precision, dev)
    ids = np.asarray(sample_ids)
    sample = images[torch.as_tensor(ids, device=dev)]
    sd = (1.0 - matmul(sample, torch.as_tensor(embs, device=dev).T,
                       precision)).cpu().numpy().astype(np.float64)
    kvb = np.empty(len(q.nodes), np.float64)
    for f, (n, s) in enumerate(zip(q.nodes, q.seeds)):
        m = int(oracle_answers(tree, int(n), ids, int(s)).sum())
        kvb[f] = threshold_from_matches(sd[:, f], m)
    avg = 0.5 * (spec + kvb)
    cols = [avg]
    if extra_thr is not None:
        cols.append(np.asarray(extra_thr, np.float32).astype(np.float64))
    counts = scan_counts(images, embs, np.stack(cols, axis=1), precision)
    order = [list(np.argsort(counts[a:b, 0], kind="stable"))
             for a, b in zip(q.start[:-1], q.start[1:])]
    plans = Plans(spec=spec, kvb=kvb, avg=avg, count=counts[:, 0],
                  order=order)
    return plans, (counts[:, 1] if extra_thr is not None else None)


def judge(q: Queries, got: Plans, ref: Plans, ref_count_at_got: np.ndarray,
          missing: int, n: int) -> dict[str, float]:
    """The numbers compared, each the worst over the judged filters:

    ``thr_spec_gap`` / ``thr_kvb_gap`` / ``thr_avg_gap``: the largest gap
    between a threshold and the reference's; ``sel_gap``: the largest gap
    between a filter's selectivity and the reference's full scan at the
    same threshold (the store's ``n`` rows turn counts into
    selectivities); ``order_errors``: plans whose filters are not in the
    stable ascending order of their own selectivities; ``missing``: judged
    queries that raised, came back degraded or never returned."""
    def worst(a):
        return float(np.max(a)) if len(a) else 0.0

    errors = 0
    for k, (a, b) in enumerate(zip(q.start[:-1], q.start[1:])):
        want = list(np.argsort(got.count[a:b], kind="stable"))
        errors += [int(i) for i in got.order[k]] != [int(i) for i in want]
    return {
        "thr_spec_gap": worst(np.abs(got.spec - ref.spec)),
        "thr_kvb_gap": worst(np.abs(got.kvb - ref.kvb)),
        "thr_avg_gap": worst(np.abs(got.avg - ref.avg)),
        "sel_gap": worst(np.abs(got.count - ref_count_at_got)) / n,
        "order_errors": float(errors),
        "missing": float(missing),
    }

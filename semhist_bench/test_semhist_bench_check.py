"""The check that decides ``correct`` fails what it has to fail: a run with
the timed path broken underneath (each fault this cell can have), and the
control, the reference in TF32 put in the program's place."""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from semhist_bench.conftest import (  # noqa: E402
    INDEX_CELL,
    TINY,
    TINY_CLUSTERS,
    add_index_cell,
)

BENCH = pathlib.Path(__file__).resolve().parent
SEED = 5_123_456_789
# the committed cell, and one behind the index as a later change adds it
CELLS = ["wildlife-8m.open-mixed", INDEX_CELL]


def _bench_dir(cell, tmp_path):
    if cell == INDEX_CELL:
        return add_index_cell(tmp_path / "checkout")
    return BENCH


def _break_probe(alter):
    """A fault: the histogram's batched probe answers ``alter(counts)``."""
    def fault(stk):
        inner = stk.hist.probe_batch

        def probe_batch(preds, thresholds, **kw):
            counts, topk = inner(preds, thresholds, **kw)
            return alter(counts.clone(), stk.hist.n), topk

        stk.hist.probe_batch = probe_batch
    return fault


def _answer_altered(counts, n):
    counts[0] = (counts[0] + n // 2) % (n + 1)
    return counts


def _half_batch_mean(counts, n):
    b = counts.shape[0]
    if b > 1:
        keep = (b + 1) // 2
        counts[keep:] = counts[:keep].float().mean(dim=0).round().to(
            counts.dtype)
    return counts


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("alter", [_answer_altered, _half_batch_mean],
                         ids=["answer_altered", "half_batch_mean"])
def test_a_broken_probe_is_not_correct(tiny_run, tmp_path, cell, alter):
    result, checks = tiny_run(cell, SEED, fault=_break_probe(alter),
                              bench_dir=_bench_dir(cell, tmp_path))
    assert not result["correct"]
    assert checks["sel_gap"]["value"] > checks["sel_gap"]["limit"]


def test_a_planner_that_misorders_is_not_correct(tiny_run, monkeypatch):
    """A fault where the plan is produced: filters most selective last."""
    from repro_torch.core import optimizer

    class Reversed:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def argsort(a, **kw):
            return np.argsort(a, **kw)[::-1]

    monkeypatch.setattr(optimizer, "np", Reversed())
    result, checks = tiny_run(CELLS[0], SEED + 1)
    assert not result["correct"]
    assert checks["order_errors"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    """The reference in TF32 in the program's place fails at least one of
    the cell's limits."""
    from semhist_bench import control

    bench_dir = _bench_dir(cell, tmp_path)
    bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    c = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = json.loads((bench_dir / "configs" / f"{c['config']}.json")
                     .read_text())
    over = dict(TINY)
    if cfg.get("index_clusters"):
        over["index_clusters"] = TINY_CLUSTERS
    limits = json.loads((bench_dir / "limits" / f"{cell}.json").read_text())
    nums = control.readings(bench_dir, c, SEED + 2, 60, "cpu", over)
    assert any(nums[k] > limits[k] for k in nums), nums
    assert np.isfinite(list(nums.values())).all()

"""Whole runs of the cells on the host at a tiny size: the port's plans
agree with the plain reference, and a cell added as files alone runs."""

import json
import pathlib

import pytest

pytest.importorskip("torch")

from semhist_bench.conftest import INDEX_CELL, add_index_cell  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
SEED = 4_123_456_789


def _bench_dir(cell, tmp_path):
    if cell == INDEX_CELL:
        return add_index_cell(tmp_path / "checkout")
    return BENCH


@pytest.mark.parametrize("cell", ["wildlife-8m.open-mixed", INDEX_CELL])
def test_the_port_agrees_with_the_reference(tiny_run, tmp_path, cell):
    result, checks = tiny_run(cell, SEED,
                              bench_dir=_bench_dir(cell, tmp_path))
    assert result["correct"], checks
    assert result["attempted"] > 10 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert all(c["value"] <= c["limit"] for c in checks.values())


def test_a_traced_run_reports_the_per_layer_metrics(tiny_run):
    result, _ = tiny_run("wildlife-8m.open-mixed", SEED + 1, trace=True)
    assert result["correct"]
    m = result["metrics"]
    assert {"planner_self_ms.latency", "predicates_per_launch.latency",
            "queue_wait_p95_ms.latency"} <= set(m)
    assert "plan_p50_ms" not in m and "setup_s" not in m
    assert m["predicates_per_launch.latency"]["value"] >= 1.0
    assert m["vlm_build_s.setup"]["value"] > 0.0
    assert "breakdown" in result and "window_s" in result["device"]


def _files(root: pathlib.Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_alone_runs(tiny_run, tmp_path):
    """A configuration, a mix, a limits file, an end-to-end metric and a
    per-layer metric's reader added as new files and entries: the new cell
    runs the closed loop through the index and reports its metrics, and
    no file of the benchmark changed."""
    bench_dir = add_index_cell(tmp_path / "checkout")
    (bench_dir / "metrics" / "rows_scanned_share.py").write_text(
        "def read(ctx):\n"
        "    if ctx.index is None or not ctx.index['rows_full_equiv']:\n"
        "        return None\n"
        "    return ctx.index['rows_scanned'] / ctx.index['rows_full_equiv']\n")
    root = bench_dir.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "rows_scanned_share.throughput", "unit": "ratio",
        "better": "lower", "source": "program_counter", "layer": "index",
        "moves": "plans_per_s", "workloads": [INDEX_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, _ = tiny_run(INDEX_CELL, SEED + 2, bench_dir=bench_dir)
    assert result["correct"]
    assert set(result["metrics"]) == {"plans_per_s", "setup_s"}
    traced, _ = tiny_run(INDEX_CELL, SEED + 2, trace=True,
                         bench_dir=bench_dir)
    # the VLM's build is read in every cell: its entry names none
    assert set(traced["metrics"]) == {"rows_scanned_share.throughput",
                                      "vlm_build_s.setup"}
    assert 0.0 < traced["metrics"]["rows_scanned_share.throughput"][
        "value"] <= 1.0
    after = _files(bench_dir)
    assert {p: b for p, b in after.items() if p in _files(BENCH)} == \
        _files(BENCH)

"""The benchmark's CPU tests: one torch thread each (the tier-1 run uses
several test workers at once), ``tiny_run``, a whole run of a cell on the
host at a size a test can hold, and ``add_index_cell``, a checkout with a
cell behind the cluster-pruned index added as files alone."""

import json
import pathlib
import shutil
import time

import pytest

BENCH = pathlib.Path(__file__).resolve().parent

# the cells at test size: rows and the KV-batch VLM cut, the MLP trained
# briefly; every other setting as committed
TINY = {"rows": 4096, "kvbatch": {"smoke": True},
        "specificity": {"steps": 30, "samples": 300}}
TINY_CLUSTERS = 16

# a closed-loop cell behind the cluster-pruned index, as a later change
# would add it: new files and new entries in BENCHMARK.json only
INDEX_CELL = "catalog-4m-k512.closed-specific"


def add_index_cell(root: pathlib.Path) -> pathlib.Path:
    """Copy the benchmark to ``root`` and add ``INDEX_CELL`` to the copy:
    the e-commerce preset behind a K = 512 index, 64 sessions of 2-4 leaf
    filters under 1% selectivity, reporting ``plans_per_s``. Returns the
    copy's benchmark directory."""
    bench_dir = root / BENCH.name
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = json.loads((bench_dir / "configs" / "wildlife-8m.json").read_text())
    cfg.update(name="catalog-4m-k512", preset="ecommerce", rows=1 << 22,
               index_clusters=512)
    (bench_dir / "configs" / "catalog-4m-k512.json").write_text(
        json.dumps(cfg))
    (bench_dir / "traffic" / "closed-specific.json").write_text(json.dumps({
        "loop": "closed", "sessions": 64, "filters": [2, 3, 4],
        "pool": "leaves", "max_selectivity": 0.01, "warmup_queries": 256}))
    limits = json.loads((bench_dir / "limits" /
                         "wildlife-8m.open-mixed.json").read_text())
    limits["sel_gap"] = 1.5e-4
    (bench_dir / "limits" / f"{INDEX_CELL}.json").write_text(
        json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "catalog-4m-k512", "source": "test",
                             "file": f"{BENCH.name}/configs/"
                                     "catalog-4m-k512.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": INDEX_CELL,
                               "config": "catalog-4m-k512",
                               "traffic": "closed-specific", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "plans_per_s", "unit": "plans/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [INDEX_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


@pytest.fixture(autouse=True)
def _one_torch_thread():
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_run():
    from semhist_bench import harness

    def run(cell_name, seed, *, trace=False, fault=None, bench_dir=BENCH,
            seconds=1.0):
        bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
        cell = {w["name"]: w for w in bench["workloads"]}[cell_name]
        cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json")
                         .read_text())
        over = dict(TINY)
        if cfg.get("index_clusters"):
            over["index_clusters"] = TINY_CLUSTERS
        return harness.run_cell(bench_dir, bench, cell, seed=seed,
                                seconds=seconds, trace=trace, device="cpu",
                                t_start=time.perf_counter(), overrides=over,
                                fault=fault)

    return run


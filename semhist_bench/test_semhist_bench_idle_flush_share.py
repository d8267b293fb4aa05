"""The reader of ``idle_flush_share.latency``: the window's launches whose
batch an idle flusher took, over all of its launches; nothing where the
window had no launch or the program keeps no count of idle flushes (as
before the flusher held no window on an idle card), and a traced run on
the host reports it."""

import pytest

pytest.importorskip("torch")

from semhist_bench import harness  # noqa: E402
from semhist_bench.test_semhist_bench_program_metrics import (  # noqa: E402
    BENCH,
    SEED,
    _ctx,
)

NAME = "idle_flush_share.latency"


@pytest.mark.parametrize("idle, fired, share", [
    (0, 6, 0.0), (3, 6, 0.5), (6, 6, 1.0), (17, 25, 0.68)])
def test_reader_values(idle, fired, share):
    read = harness.load_reader(BENCH, NAME)
    assert read(_ctx({"coalescer.idle_flushes": idle,
                      "coalescer.probes_fired": fired,
                      "coalescer.predicates_probed": 4 * fired})) == \
        pytest.approx(share)


@pytest.mark.parametrize("counters", [
    {"coalescer.idle_flushes": 0, "coalescer.probes_fired": 0},
    {"coalescer.probes_fired": 5, "coalescer.predicates_probed": 18},
    {}], ids=["no-launch", "no-count", "nothing"])
def test_reader_reads_nothing_without_launches_or_the_count(counters):
    assert harness.load_reader(BENCH, NAME)(_ctx(counters)) is None


def test_a_traced_run_reports_the_idle_flush_share(tiny_run):
    result, _ = tiny_run("wildlife-8m.open-mixed", SEED + 7, trace=True)
    assert result["correct"]
    assert 0.0 < result["metrics"][NAME]["value"] <= 1.0
    assert result["metrics"][NAME]["unit"] == "idle/launch"

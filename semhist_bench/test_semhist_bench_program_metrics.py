"""The readers of the program's own spans and counters: each a window mean
over ``ctx.counters`` (the registry counters' increase over the window),
nothing where the window had no plan, launch or wake or where the program
keeps no such counter, and all but the card's device time reported by a
traced run on the host."""

import pathlib

import pytest

pytest.importorskip("torch")

from semhist_bench import harness  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
SEED = 3_987_654_321
NAMES = ("planner_mlp_ms.latency", "planner_calibration_ms.latency",
         "planner_vlm_answer_ms.latency", "planner_rest_ms.latency",
         "planner_cpu_share.latency", "probe_device_ms.latency",
         "waiter_wake_ms.latency")

# four plans, six launches (five timed) and twelve wakes (four blocked)
# of a window, in nanoseconds
COUNTERS = {"planner.plans": 4, "planner.wall_ns": 160_000_000,
            "planner.probe_ns": 60_000_000, "planner.embed_ns": 8_000_000,
            "planner.mlp_ns": 12_000_000,
            "planner.calibration_ns": 40_000_000,
            "planner.vlm_answer_ns": 30_000_000,
            "planner.host_cpu_ns": 36_000_000,
            "probe.device_ns": 61_000_000, "probe.device_timed": 5,
            "coalescer.probes_fired": 6, "coalescer.wake_ns": 9_000_000,
            "coalescer.wakes": 12, "coalescer.blocked_wakes": 4}

EXPECTED = {"planner_mlp_ms.latency": 3.0,
            "planner_calibration_ms.latency": 10.0,
            "planner_vlm_answer_ms.latency": 7.5,
            "planner_rest_ms.latency": 12.0,
            "planner_cpu_share.latency": 75.0,
            "probe_device_ms.latency": 12.2,
            "waiter_wake_ms.latency": 2.25}

# what each reader divides by
DIVISOR = {"planner_mlp_ms.latency": "planner.plans",
           "planner_calibration_ms.latency": "planner.plans",
           "planner_vlm_answer_ms.latency": "planner.plans",
           "planner_rest_ms.latency": "planner.plans",
           "planner_cpu_share.latency": "planner.calibration_ns",
           "probe_device_ms.latency": "probe.device_timed",
           "waiter_wake_ms.latency": "coalescer.blocked_wakes"}


def _ctx(counters):
    return harness.Context(requests=[], window_s=2.0, launches=[],
                           counters=counters, hists={}, index=None,
                           rows=1 << 20, dim=1152, trace=None)


@pytest.mark.parametrize("name", NAMES)
def test_reader_values(name):
    read = harness.load_reader(BENCH, name)
    assert read(_ctx(dict(COUNTERS))) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_without_plans_launches_or_wakes(name):
    read = harness.load_reader(BENCH, name)
    empty = dict(COUNTERS, **{DIVISOR[name]: 0})
    if name == "planner_cpu_share.latency":
        empty["planner.embed_ns"] = 0
    assert read(_ctx(empty)) is None
    # a program without the spans (the parent of this change) keeps none
    # of the new counters: nothing to read, and nothing raises
    assert read(_ctx({"coalescer.probes_fired": 5,
                      "coalescer.predicates_probed": 18})) is None
    assert read(_ctx({})) is None


def test_phases_and_rest_add_up_to_the_wall():
    c = dict(COUNTERS)
    parts = sum(harness.load_reader(BENCH, n)(_ctx(c)) for n in (
        "planner_mlp_ms.latency", "planner_calibration_ms.latency",
        "planner_rest_ms.latency"))
    probe = c["planner.probe_ns"] / c["planner.plans"] / 1e6
    assert parts + probe == pytest.approx(
        c["planner.wall_ns"] / c["planner.plans"] / 1e6)


def test_a_traced_run_reports_the_program_metrics(tiny_run):
    result, _ = tiny_run("wildlife-8m.open-mixed", SEED, trace=True)
    m = result["metrics"]
    # the host has no card: the probe's device time alone reads nothing
    assert set(NAMES) - set(m) == {"probe_device_ms.latency"}
    for name in NAMES[:4] + ("waiter_wake_ms.latency",):
        assert m[name]["value"] >= 0.0, name
    assert m["planner_vlm_answer_ms.latency"]["value"] <= \
        m["planner_calibration_ms.latency"]["value"]
    assert 0.0 < m["planner_cpu_share.latency"]["value"] <= 100.0

"""The metrics' arithmetic: a tail over every request of the window from
its due time, a rate over the whole window, and the per-layer readers."""

import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from semhist_bench import harness, peaks  # noqa: E402
from semhist_bench.stack import Request  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent


def _req(due, start, end, error=None, coal=()):
    r = Request(nodes=(1, 2), qseed=7, due=due, start=start, end=end,
                error=error)
    r.coal.extend(coal)
    return r


def test_latency_runs_from_due_time_over_every_request():
    # 19 prompt plans, one that queued 0.5 s behind a stall
    reqs = [_req(i * 0.1, i * 0.1, i * 0.1 + 0.010) for i in range(19)]
    reqs.append(_req(1.9, 2.4, 2.41))
    v = harness.end_to_end(reqs, t_end=2.0, seconds=2.0, setup_s=3.0)
    assert v["plan_p50_ms"] == pytest.approx(10.0)
    lat = [10.0] * 19 + [510.0]
    assert v["plan_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert v["setup_s"] == 3.0


def test_a_failed_request_misses_every_limit():
    reqs = [_req(i * 0.1, i * 0.1, i * 0.1 + 0.010) for i in range(10)]
    reqs[3] = _req(0.3, 0.3, 0.31, error="ShedError: shed")
    reqs.append(_req(1.0, 1.0, 0.0))                  # never returned
    v = harness.end_to_end(reqs, t_end=2.0, seconds=2.0, setup_s=1.0)
    assert v["plan_p95_ms"] > 1e9
    assert v["plans_per_s"] == pytest.approx(9 / 2.0)


def test_rate_counts_plans_completed_in_the_window_over_its_seconds():
    reqs = [_req(0.0, 0.0, t) for t in (0.5, 1.0, 1.99, 2.5, 3.0)]
    v = harness.end_to_end(reqs, t_end=2.0, seconds=2.0, setup_s=1.0)
    assert v["plans_per_s"] == pytest.approx(3 / 2.0)


def _ctx(**kw):
    base = dict(requests=[], window_s=2.0, launches=[],
                counters={}, hists={}, index=None, rows=1 << 20, dim=1152,
                trace=None)
    base.update(kw)
    return harness.Context(**base)


def test_readers():
    read = {n: harness.load_reader(BENCH, n) for n in (
        "planner_self_ms.latency", "predicates_per_launch.latency",
        "probe_roofline.latency", "device_idle.latency",
        "queue_wait_p95_ms.latency", "plan_tail_p95_ms.latency")}
    reqs = [_req(0, 0, 0.030, coal=[(0.010, 0.025)]),
            _req(0, 0, 0.050, coal=[(0.010, 0.020), (0.030, 0.035)])]
    assert read["planner_self_ms.latency"](_ctx(requests=reqs)) == \
        pytest.approx(np.median([15.0, 35.0]))
    assert read["predicates_per_launch.latency"](_ctx(counters={
        "coalescer.probes_fired": 4,
        "coalescer.predicates_probed": 10})) == 2.5
    assert read["predicates_per_launch.latency"](_ctx()) is None
    assert read["queue_wait_p95_ms.latency"](_ctx(hists={
        "serve.queue_wait_ms": np.arange(101.0)})) == pytest.approx(95.0)

    launches = [(0.0, 0.01, 3), (0.02, 0.03, 20)]
    least = sum(peaks.probe_least_s(1 << 20, 1152, b) for _, _, b in launches)
    kernels = {"void probe_kernel<8, true, 0>(ProbeArgs)": (0.002, 1),
               "void probe_wide_kernel<false>(ProbeArgs, CUtensorMap, "
               "CUtensorMap)": (0.003, 1),
               "merge_kernel(int const*, float const*, int*, float*, int, "
               "int, int, int, int)": (0.001, 2),
               "void at::native::elementwise_kernel": (0.5, 40)}
    tr = harness.Trace(window_s=2.0, busy_s=0.5, kernels=kernels, gaps={})
    assert read["probe_roofline.latency"](
        _ctx(launches=launches, trace=tr)) == pytest.approx(
            100 * least / 0.006)
    # a trace that lost a launch's records reads nothing, not a guess
    lost = dict(kernels)
    lost["merge_kernel(int const*, float const*, int*, float*, int, int, "
         "int, int, int)"] = (0.0005, 1)
    assert read["probe_roofline.latency"](
        _ctx(launches=launches, trace=harness.Trace(2.0, 0.5, lost, {}))) \
        is None
    assert read["device_idle.latency"](_ctx(trace=tr)) == pytest.approx(75.0)
    assert read["device_idle.latency"](_ctx()) is None
    tail = [_req(i * 0.1, i * 0.1, i * 0.1 + 0.010) for i in range(19)]
    tail.append(_req(1.9, 2.4, 2.41))
    assert read["plan_tail_p95_ms.latency"](_ctx(requests=tail)) == \
        pytest.approx(np.percentile([10.0] * 19 + [510.0], 95))
    assert read["plan_tail_p95_ms.latency"](_ctx()) is None


def test_the_vlm_build_is_read_from_the_set_up_phases():
    read = harness.load_reader(BENCH, "vlm_build_s.setup")
    assert read(_ctx(setup={"stack": 9.5, "vlm_build": 7.25})) == 7.25
    assert read(_ctx()) is None


def test_device_busy_is_the_union_of_device_intervals():
    iv = np.asarray([[0, 10], [5, 20], [30, 40]], np.float64)
    assert harness._union_s(iv) == pytest.approx(30e-6)

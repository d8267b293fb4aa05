"""The coalescer's device time of a probe on the card: ``probe.device_ns``,
from the CUDA event pair the flusher arms around ``probe_batch`` (recorded
around the kernel's launch), agrees with events taken around the same
``probe_batch`` alone. The planner's specificity MLP on its own stream:
its thresholds are bitwise those of the same module on the default stream,
its stream has the card's greatest priority, and it waits for no work
queued on the default stream, where the flusher scans. Free of JAX."""

import statistics
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_stack import SpecificityModelConfig  # noqa: E402
from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
from repro_torch.core.specificity import (  # noqa: E402
    SpecificityMLP,
    SpecificityModel,
)
from repro_torch.launch.coalescer import (  # noqa: E402
    CoalescerConfig,
    PredicateCoalescer,
)
from repro_torch.obs import ObsHub  # noqa: E402


@pytest.mark.cuda
def test_probe_device_time_matches_events_around_the_probe_alone():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1 << 21, 1152), device="cuda", generator=g)
    x /= x.norm(dim=1, keepdim=True)
    hist = SemanticHistogram(x)
    preds = x[:4].cpu().numpy()
    thrs = np.full(4, 0.8, np.float32)
    for _ in range(3):                          # builds and warms the kernel
        hist.probe_batch(preds, thrs, k=1, use_cache=False)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    alone = []
    for _ in range(5):
        start.record()
        hist.probe_batch(preds, thrs, k=1, use_cache=False)
        end.record()
        end.synchronize()
        alone.append(start.elapsed_time(end))
    hub = ObsHub()
    with PredicateCoalescer(hist, CoalescerConfig(max_batch=4,
                                                  window_ms=10_000),
                            obs=hub) as coal:
        coal.probe_outcomes(preds, thrs)        # four pending: one flush
    c = hub.registry.snapshot()["counters"]
    assert c["coalescer.probes_fired"] == 1
    ms, ref = c["probe.device_ns"] / 1e6, statistics.median(alone)
    assert abs(ms - ref) <= 0.1 * ref, (ms, alone)


def _model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream exists only there")
    cfg = SpecificityModelConfig(embed_dim=1152)
    module = SpecificityMLP(cfg)
    module.reset_parameters_from(torch.Generator().manual_seed(0))
    return SpecificityModel(module.to("cuda"), cfg)


def _embeddings(b, seed):
    x = np.random.default_rng(seed).standard_normal((b, 1152))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 4, 64])
def test_thresholds_are_bitwise_the_default_streams(b):
    model = _model()
    x = _embeddings(b, b)
    with torch.no_grad():
        want = model.module(torch.as_tensor(x, device="cuda")).cpu().numpy()
    got = model.thresholds(x)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    _, greatest = torch.cuda.Stream.priority_range()
    assert model._stream.priority == greatest
    assert model._stream != torch.cuda.default_stream()


class _LongScan:
    """A histogram on the card whose probe queues a long run of full-card
    kernels on the current stream (as a scan would be) before its outputs:
    the coalescer's read-back of a flush has to wait for all of it."""

    device = torch.device("cuda")
    n = 100

    def __init__(self):
        self.a = torch.randn((8192, 8192), device="cuda")
        self.b = torch.randn((8192, 8192), device="cuda")
        # probe once: CUDA loads a kernel at its first launch, and loading
        # one behind the long queue waits for the whole card, holding every
        # other thread's launches (a server warms its kernels up the same)
        self.probe_batch(np.zeros((4, 1), np.float32), None)
        torch.cuda.synchronize()
        self.end = None

    def probe_batch(self, preds, thresholds, **kw):
        for _ in range(20):                 # ~20 ms each in fp32
            c = self.a @ self.b
        self.end = torch.cuda.Event()
        self.end.record()
        counts = torch.zeros((len(preds), 1), dtype=torch.int32,
                             device="cuda") + (c[0, :1] > 1e30).int()
        return counts, torch.zeros((len(preds), 1), device="cuda")


@pytest.mark.cuda
def test_thresholds_wait_for_no_work_on_the_default_stream():
    """A long run of full-card kernels queued on the default stream by a
    flush (as a scan would be), and the flusher waiting to read its result
    back: the thresholds come back before the queued work ends."""
    model = _model()
    x = _embeddings(4, 0)
    want = model.thresholds(x)          # the stream, its memory and cuBLAS
    hist = _LongScan()
    torch.cuda.synchronize()
    with PredicateCoalescer(hist, CoalescerConfig(max_batch=4)) as coal:
        start = time.perf_counter()
        flush = threading.Thread(target=lambda: coal.probe_outcomes(
            x, np.full(4, 0.8, np.float32)))
        flush.start()
        while hist.end is None:
            time.sleep(0.001)
        time.sleep(0.05)                # the flusher is inside its read-back
        got = model.thresholds(x)
        took = time.perf_counter() - start
        queued_ran = hist.end.query()
        hist.end.synchronize()
        flush.join(timeout=30)
        whole = time.perf_counter() - start
    assert not queued_ran, "the thresholds waited for the default stream"
    assert took < 0.5 * whole, (took, whole)
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_thresholds_wait_for_no_work_queued_from_their_own_thread():
    """The same long run of full-card kernels queued on the default stream,
    from the thread that then asks for thresholds, with no flusher: the
    thresholds should come back before the queued work ends."""
    model = _model()
    x = _embeddings(4, 0)
    want = model.thresholds(x)
    hist = _LongScan()
    torch.cuda.synchronize()
    start = time.perf_counter()
    hist.probe_batch(x, np.full(4, 0.8, np.float32))
    got = model.thresholds(x)
    took = time.perf_counter() - start
    queued_ran = hist.end.query()
    hist.end.synchronize()
    whole = time.perf_counter() - start
    assert not queued_ran, "the thresholds waited for the default stream"
    assert took < 0.5 * whole, (took, whole)
    assert np.array_equal(got, want)

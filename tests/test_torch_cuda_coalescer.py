"""The coalescer's device time of a probe on the card: ``probe.device_ns``,
from the CUDA event pair the flusher arms around ``probe_batch`` (recorded
around the kernel's launch), agrees with events taken around the same
``probe_batch`` alone. Free of JAX."""

import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.histogram import SemanticHistogram  # noqa: E402
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

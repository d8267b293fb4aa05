"""The full-scan probe against its roofline, in percent: the least time
of the window's probe launches (each the larger of its bytes over the
card's bandwidth and its float32 operations over the card's peak, counted
from the store's shape and the launch's B, ``peaks.probe_least_s``) over
the device time of the probe's kernels (its scans and merges) in the
trace. Nothing to read without an index-free store, or where the trace
kept fewer merge records than the window had launches: the time would
then leave out part of the work."""

from semhist_bench.harness import PROBE_KERNELS
from semhist_bench.peaks import probe_least_s


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.index is not None or not ctx.launches:
        return None
    device_s, merges = 0.0, 0
    for name, (secs, records) in tr.kernels.items():
        m = PROBE_KERNELS.search(name)
        if m:
            device_s += secs
            merges += records if m.group(1) == "merge_kernel" else 0
    if merges < len(ctx.launches) or device_s <= 0:
        return None
    least = sum(probe_least_s(ctx.rows, ctx.dim, b)
                for _, _, b in ctx.launches)
    return 100.0 * least / device_s

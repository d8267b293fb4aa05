"""The plans' tail: the 95th percentile, over every plan due in the
window, of due time to ``plan_query``'s return (a failed plan counts as
missing every limit). Host-clock tails of this GIL-bound process spread
by more from run to run than an end-to-end bound may allow, so the tail
stands here beside the median."""

from semhist_bench.harness import end_to_end


def read(ctx):
    if not ctx.requests:
        return None
    t0 = min(r.due for r in ctx.requests)
    return end_to_end(ctx.requests, t0 + ctx.window_s, ctx.window_s,
                      0.0)["plan_p95_ms"]

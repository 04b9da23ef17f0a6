"""End-to-end metric `op_ms_p90`, host clock: the 90th percentile of the
latencies of all units in the window, ms (`statistics.quantiles`,
inclusive)."""

import statistics


def read(ctx):
    return 1e3 * statistics.quantiles([u.latency_s for u in ctx.units], n=10, method="inclusive")[8]

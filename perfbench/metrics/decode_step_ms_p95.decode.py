"""The 95th percentile of the host's ms a decode step (decode, sample and
a synchronize) over the traced run's unprofiled steps."""

import statistics

from perfbench.metrics_common import unprofiled


def read(ctx):
    times = [b - a for a, b in unprofiled(ctx, ctx.get("steps") or [])]
    if len(times) < 200:
        return None
    return 1e3 * statistics.quantiles(times, n=20)[-1]

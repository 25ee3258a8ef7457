"""A decode step at its roofline (the larger of its FLOPs over the bf16
peak and its bytes over HBM bandwidth: ``perfbench.counts.decode_flops``,
``decode_bytes``) as a share of the mean step time, over the traced run's
unprofiled steps."""

from perfbench import counts
from perfbench.metrics_common import unprofiled


def read(ctx):
    steps = unprofiled(ctx, ctx.get("steps") or [])
    if not steps:
        return None
    bound = max(ctx["flops"] / counts.PEAK_BF16_FLOPS, ctx["bytes"] / counts.PEAK_HBM_BYTES)
    return 100.0 * bound / (sum(b - a for a, b in steps) / len(steps))

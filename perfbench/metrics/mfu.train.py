"""Model FLOPs of a step (``perfbench.counts.train_flops``) over the mean
step time times the bf16 peak, over the traced run's unprofiled steps."""

from perfbench import counts
from perfbench.metrics_common import unprofiled


def read(ctx):
    steps = unprofiled(ctx, ctx.get("steps") or [])
    if not steps:
        return None
    mean = sum(b - a for a, b in steps) / len(steps)
    return 100.0 * ctx["model_flops"] / (mean * counts.PEAK_BF16_FLOPS)

"""The MoE layers of a decode step at their roofline (the larger of the
routed pairs' FLOPs over the bf16 peak and the bf16 expert weights read
once plus the tokens over HBM bandwidth: ``perfbench.counts.jamba.
moe_step``) as a share of the device time of the ops launched inside
``models.moe`` spans, over the profiled steps."""

from perfbench.metrics_layers import layer_ops


def read(ctx):
    ops = layer_ops(ctx, "models.moe", "serve.sample")
    if ops is None:
        return None
    busy = ctx["trace"].busy_s(ops)
    if busy <= 0:
        return 0.0
    return 100.0 * ctx["moe_roofline_s"] * ctx["traced_steps"] / busy

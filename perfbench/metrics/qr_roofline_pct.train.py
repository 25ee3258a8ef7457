"""The step's QR work at its roofline (the larger of its FLOPs over the
fp32 peak and its bytes over HBM bandwidth, from the parameter shapes:
``perfbench.counts.qr_step``) as a share of the device time of the ops
launched inside ``optim.batched_ortho`` (the union of their intervals),
over the profiled steps."""

from perfbench.metrics_common import ortho_ops


def read(ctx):
    ops = ortho_ops(ctx)
    if not ops:
        return None
    busy = ctx["trace"].busy_s(ops)
    if busy <= 0:
        return None
    return 100.0 * ctx["qr"]["roofline_s"] * ctx["traced_steps"] / busy

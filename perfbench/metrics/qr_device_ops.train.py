"""Device operations a step launched inside the program's
``optim.batched_ortho`` span, by the host time of each launch, over the
profiled steps; kernel names do not enter."""

from perfbench.metrics_common import ortho_ops


def read(ctx):
    ops = ortho_ops(ctx)
    if not ops or not ctx.get("traced_steps"):
        return None
    return len(ops) / ctx["traced_steps"]

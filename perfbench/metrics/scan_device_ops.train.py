"""Device operations a step launched inside the program's
``models.scan_chunk`` spans (forward and backward recompute), by the
host time of each launch, over the profiled steps."""

from perfbench.metrics_spans import ops_per_step


def read(ctx):
    return ops_per_step(ctx, "models.scan_chunk", "train.data")

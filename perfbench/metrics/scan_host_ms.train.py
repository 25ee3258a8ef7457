"""Host ms a step inside the program's ``models.scan_chunk`` spans (each
recurrent chunk in forward and its recompute in backward; no
synchronize), over the traced run's unprofiled steps."""

from perfbench.metrics_spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "models.scan_chunk", "train.data")

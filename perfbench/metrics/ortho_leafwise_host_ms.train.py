"""Host ms a step inside the program's ``optim.ortho_class.leafwise``
spans (QR-Muon's classes solved member by member; no synchronize), over
the traced run's unprofiled steps."""

from perfbench.metrics_spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "optim.ortho_class.leafwise", "train.data")

"""Host ms a step inside the program's ``optim.ortho_class.batched``
spans (QR-Muon's shape classes solved as one stack: the stack's build,
the dispatch, the slicing back; no synchronize), over the traced run's
unprofiled steps."""

from perfbench.metrics_spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "optim.ortho_class.batched", "train.data")

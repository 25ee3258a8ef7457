"""Mean ms a step of the program's ``train.optimizer`` span (clipping and
the QR-Muon update, ending in a synchronize) over the traced run's
window, after its profiled steps."""

from perfbench.metrics_common import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "train.optimizer")

"""Host ms a step inside the program's ``serve.decode`` span (the
host's launch of a decode step; no synchronize), over the traced run's
unprofiled steps."""

from perfbench.metrics_spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "serve.decode", "serve.sample")

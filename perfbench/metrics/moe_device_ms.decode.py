"""Device ms a decode step of the ops launched inside the program's
``models.moe`` spans (router, dispatch, the experts' products and the
weights' casts), the union of their intervals, over the profiled steps."""

from perfbench.metrics_layers import layer_device_ms


def read(ctx):
    return layer_device_ms(ctx, "models.moe", "serve.sample")

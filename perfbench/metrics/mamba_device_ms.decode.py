"""Device ms a decode step of the ops launched inside the program's
``models.mamba`` spans (the Mamba mixers' projections, conv and state
update), the union of their intervals, over the profiled steps."""

from perfbench.metrics_layers import layer_device_ms


def read(ctx):
    return layer_device_ms(ctx, "models.mamba", "serve.sample")

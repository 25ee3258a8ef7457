"""What the readers of a model layer's device time share: the profiled
device ops whose launch lies inside the program's spans of one name
(``models.moe``, ``models.mamba``), and their device time a step.

As in :mod:`perfbench.metrics_spans`, a reader names a marker, a span
that a program which records the layer's spans opens every step
(``serve.sample`` a decode step): without a trace, profiled steps or the
marker (a program older than these spans) it reads None; with the marker
but none of the layer's spans, 0.0."""

from perfbench.metrics_spans import _spans, _union


def layer_ops(ctx, name, marker):
    """The profiled ops launched inside ``name`` spans, the spans placed
    on the trace's clock as ``perfbench.trace.Trace`` places them; None
    where there is nothing to read."""
    tr, spans = ctx.get("trace"), _spans(ctx, marker)
    if tr is None or not tr.ops or spans is None or not ctx.get("traced_steps"):
        return None
    inside = _union([(int(a * 1e9) + tr.offset, int(b * 1e9) + tr.offset)
                     for n, a, b in spans if n == name])
    return [op for op in tr.ops if op[3] is not None and inside(op[3])]


def layer_device_ms(ctx, name, marker):
    """Device ms a profiled step of the ops launched inside ``name``
    spans (the union of their intervals)."""
    ops = layer_ops(ctx, name, marker)
    if ops is None:
        return None
    return 1e3 * ctx["trace"].busy_s(ops) / ctx["traced_steps"]

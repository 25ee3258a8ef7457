"""What several per-layer readers share: the traced run's steps after
the profiled ones (the profiler slows the steps it records), and the
device ops of the optimizer's orthogonalization."""


def unprofiled(ctx, items, start=lambda x: x[0]):
    """``items`` (each starting at ``start(item)``, perf_counter seconds)
    outside the profiled steps (``ctx["profiled"]``, (start, end) a step);
    all of them when nothing else is left."""
    prof = ctx.get("profiled") or []
    out = [x for x in items if not any(a <= start(x) < b for a, b in prof)]
    return out or list(items)


def span_mean_ms(ctx, name):
    d = [b - a for n, a, b in unprofiled(ctx, ctx.get("spans", []), lambda s: s[1])
         if n == name]
    return 1e3 * sum(d) / len(d) if d else None


def ortho_ops(ctx):
    """The profiled device ops launched inside the program's
    ``optim.batched_ortho`` span, by the host time of each launch; None
    without a trace or such a span."""
    tr = ctx.get("trace")
    spans = [(a, b) for name, a, b in ctx.get("spans", []) if name == "optim.batched_ortho"]
    if tr is None or not spans:
        return None
    return tr.launched_within(spans)

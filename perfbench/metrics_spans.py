"""What the readers of the program's own spans share: the host ms a step
spent inside spans of one name, over the traced run's unprofiled steps,
and the device ops launched inside them over the profiled steps.

Each reader names its span and a marker: a span that a program which
records the reader's span opens every step (``train.data`` a training
step, ``serve.sample`` a decode step).  A reader returns None where there
is nothing to read (no steps, no trace, or no marker: a program older
than these spans), and 0.0 where the marker is there but its own span is
not, so a route that a change empties reads 0 and does not fall silent.
Intervals are merged, sorted and bisected: a profiled xlstm training
step holds hundreds of thousands of device ops."""

import bisect

from perfbench.metrics_common import unprofiled


def _union(intervals):
    """``t -> bool``: whether ``t`` lies in the union of ``intervals``
    ((start, end), ends included)."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]

    return inside


def _spans(ctx, marker):
    """The run's spans ((name, start, end), ``time.perf_counter()``
    seconds), or None without the marker."""
    spans = ctx.get("spans") or []
    return spans if any(n == marker for n, _, _ in spans) else None


def host_ms_per_step(ctx, name, marker):
    """Mean host ms a step inside ``name`` spans, those starting in an
    unprofiled step."""
    spans = _spans(ctx, marker)
    steps = unprofiled(ctx, ctx.get("steps") or [])
    if spans is None or not steps:
        return None
    in_steps = _union(steps)
    total = sum(b - a for n, a, b in spans if n == name and in_steps(a))
    return 1e3 * total / len(steps)


def ops_per_step(ctx, name, marker):
    """Device ops a profiled step whose launch lies inside a ``name``
    span, the spans placed on the trace's clock as
    ``perfbench.trace.Trace`` places them."""
    tr, spans = ctx.get("trace"), _spans(ctx, marker)
    if tr is None or not tr.ops or spans is None or not ctx.get("traced_steps"):
        return None
    ivs = [(int(a * 1e9) + tr.offset, int(b * 1e9) + tr.offset)
           for n, a, b in spans if n == name]
    inside = _union(ivs)
    return sum(op[3] is not None and inside(op[3]) for op in tr.ops) / ctx["traced_steps"]

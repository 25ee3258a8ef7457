"""Runtime observability: metrics, span tracing, profiler annotation.

Counterpart of the reference's ``repro.observability``.  Off by default
and free when off:

    from repro_torch import observability as obs

    obs.enable()                          # or REPRO_OBSERVABILITY=1
    with obs.span("my.workload") as sp:
        q, r = solver.solve(a)
        sp.sync((q, r))
    obs.export_chrome_trace("trace.json")
    print(obs.metrics.to_prometheus())

Render a capture:  ``python -m repro_torch.observability.report --help``
"""

from . import instrument, metrics, profiler, trace
from .instrument import (annotations_enabled, disable, enable, enabled_scope,
                         tracing_enabled)
from .metrics import REGISTRY, counter, gauge, histogram, snapshot
from .profiler import annotate, capture, kernel_label, megakernel_label
from .trace import (chrome_trace, export_chrome_trace, span, spans, traced,
                    tree)

__all__ = [
    "REGISTRY",
    "annotate",
    "annotations_enabled",
    "capture",
    "chrome_trace",
    "counter",
    "disable",
    "enable",
    "enabled_scope",
    "export_chrome_trace",
    "gauge",
    "histogram",
    "instrument",
    "kernel_label",
    "megakernel_label",
    "metrics",
    "profiler",
    "snapshot",
    "span",
    "spans",
    "trace",
    "traced",
    "tracing_enabled",
    "tree",
]

"""Span tracer: nested timed regions exportable as Chrome trace JSON.

Counterpart of the reference's ``repro.observability.trace``.

    from repro_torch.observability import trace

    with trace.span("serving.flush", bucket="64x64") as sp:
        out = solve(batch)
        sp.sync(out)            # waits for the card ONLY while tracing

    trace.export_chrome_trace("trace.json")   # load in chrome://tracing

Design points:

  * **Disabled = no-op.**  When tracing is off, :func:`span` returns a
    shared ``_NullSpan`` singleton — no clock reads, no allocation, no
    device synchronize.  The disabled path is one flag test, which the
    overhead-budget test in tests/test_torch_observability.py holds to
    < 1% of a tiled 256² solve.
  * **Device-aware sync.**  ``sp.sync(x)`` waits for every CUDA device
    that holds a tensor of ``x`` (tensors, or tuples / lists / dicts of
    them), so the span measures device work, not the enqueue.  CPU
    tensors are ready when they exist.
  * **No synchronize on the measured paths.**  On the trainer, the
    optimizer, the QR engine and ``ServeEngine``, a span never calls
    ``sync``, except the two step spans ``train.fwd_bwd`` and
    ``train.optimizer``: so a traced step launches and waits as an
    untraced one does, and an inner span times the host's work (its
    enqueue), not the device's.  The model layers' spans are such inner
    spans: ``models.scan_chunk`` (a recurrent scan's chunk),
    ``models.mamba`` (a Mamba mixer call) and ``models.moe`` (a MoE
    layer call, labelled with its route).
  * **One clock.**  ``t_start`` / ``t_end`` are ``time.perf_counter()``
    seconds; ``time.time_ns() - time.perf_counter_ns()`` maps them onto
    a ``torch.profiler`` trace's clock.
  * **Correct nesting.**  A thread-local stack gives every span a
    parent; depths and parent ids survive into the export, and
    :func:`tree` renders the hierarchy as text.
  * **Profiler ranges.**  While annotations are on, a span is also a
    ``torch.profiler.record_function`` range, so a ``torch.profiler``
    capture (:func:`repro_torch.observability.profiler.capture`) shows
    the serving and engine spans around the kernels they launch.

Export is the Chrome trace-event format: ``{"traceEvents": [...]}``
with ``ph: "X"`` complete events, microsecond ``ts``/``dur``, ``pid`` /
``tid``, and span labels in ``args``.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from . import instrument

__all__ = [
    "Span",
    "chrome_trace",
    "clear",
    "export_chrome_trace",
    "span",
    "spans",
    "traced",
    "tree",
]

_EVENTS: List["Span"] = []
_EVENTS_LOCK = threading.Lock()
_TLS = threading.local()
_IDS = iter(range(1, 1 << 62))


def _stack() -> List["Span"]:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def _cuda_devices(value: Any, out: set) -> set:
    """The CUDA devices holding a tensor of ``value`` (nested tuples,
    lists and dict values are walked)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


class Span:
    """One timed region.  Create via :func:`span`, not directly."""

    __slots__ = ("name", "labels", "sid", "parent_sid", "depth", "tid",
                 "t_start", "t_end", "_range")

    def __init__(self, name: str, labels: Dict[str, Any]) -> None:
        self.name = name
        self.labels = labels
        self.sid = next(_IDS)
        self.parent_sid: Optional[int] = None
        self.depth = 0
        self.tid = threading.get_ident()
        self.t_start = 0.0
        self.t_end = 0.0
        self._range = None

    @property
    def duration_us(self) -> float:
        return (self.t_end - self.t_start) * 1e6

    def set(self, **labels: Any) -> "Span":
        self.labels.update(labels)
        return self

    def sync(self, value: Any) -> Any:
        """Wait until the CUDA work producing ``value``'s tensors is done
        (a synchronize of each device holding one), so the span covers
        device execution.  Returns value."""
        for dev in _cuda_devices(value, set()):
            torch.cuda.synchronize(dev)
        return value

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            parent = stack[-1]
            self.parent_sid = parent.sid
            self.depth = parent.depth + 1
        stack.append(self)
        if instrument.annotations_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t_end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        with _EVENTS_LOCK:
            _EVENTS.append(self)


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def set(self, **labels: Any) -> "_NullSpan":
        return self

    def sync(self, value: Any) -> Any:
        return value


_NULL_SPAN = _NullSpan()


def span(name: str, **labels: Any):
    """Context manager timing a region.  No-op singleton when disabled."""
    if not instrument.tracing_enabled():
        return _NULL_SPAN
    return Span(name, labels)


def traced(name: Optional[str] = None, **labels: Any):
    """Decorator form: ``@traced()`` or ``@traced("custom.name")``."""

    def deco(fn):
        span_name = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not instrument.tracing_enabled():
                return fn(*args, **kwargs)
            with Span(span_name, dict(labels)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def spans() -> List[Span]:
    """Completed spans, in completion order."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


def clear() -> None:
    with _EVENTS_LOCK:
        _EVENTS.clear()


def chrome_trace() -> Dict[str, Any]:
    """Chrome trace-event JSON object for all completed spans."""
    pid = os.getpid()
    events = []
    for sp in spans():
        events.append({
            "name": sp.name,
            "ph": "X",
            "ts": sp.t_start * 1e6,
            "dur": sp.duration_us,
            "pid": pid,
            "tid": sp.tid,
            "args": {str(k): _jsonable(v) for k, v in sp.labels.items()},
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str) -> str:
    """Write :func:`chrome_trace` JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f, indent=1)
    return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def tree(max_spans: int = 200) -> str:
    """Text rendering of the span hierarchy (start-time ordered)."""
    all_spans = sorted(spans(), key=lambda s: s.t_start)[:max_spans]
    if not all_spans:
        return "(no spans recorded — is observability enabled?)"
    lines = []
    for sp in all_spans:
        label = " ".join(f"{k}={v}" for k, v in sp.labels.items())
        lines.append(f"{'  ' * sp.depth}{sp.name:<40s} "
                     f"{sp.duration_us:12.1f} us"
                     + (f"  [{label}]" if label else ""))
    return "\n".join(lines)

"""Profiler hooks: named ranges around kernel launches, trace capture.

Counterpart of the reference's ``repro.observability.profiler``.  Two
planes:

  * :func:`annotate` — a ``torch.profiler.record_function`` range (plus
    an NVTX range when a card is present) that the engine opens around
    each wavefront batch and each megakernel launch, so the launches show
    up by name (``geqrt@L3``, ``megakernel[16x16]``) in a
    ``torch.profiler`` trace and in NVTX timelines.  When annotations are
    disabled (the default) it returns a shared ``nullcontext``: a launch
    pays one flag test.
  * :func:`capture` — wraps ``torch.profiler.profile`` (CPU activity,
    and CUDA activity when a card is present) around a block and writes
    its Chrome trace to ``<logdir>/profile.json``.  A profiler that fails
    to start or export adds to a ``profiler.capture_errors`` counter
    instead of failing the workload.

Label conventions (shared with the engine):

  * ``kernel_label("GEQRT", 3)``  -> ``"geqrt@L3"``
  * ``megakernel_label(16, 16)``  -> ``"megakernel[16x16]"``
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

from . import instrument, metrics

__all__ = [
    "annotate",
    "capture",
    "kernel_label",
    "megakernel_label",
]

_NULL = contextlib.nullcontext()

#: File name :func:`capture` writes its trace to, inside its logdir.
PROFILE_FILE = "profile.json"


@contextlib.contextmanager
def _ranges(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def annotate(name: str):
    """A profiler range named ``name`` when annotations are on, else a
    no-op."""
    if not instrument.annotations_enabled():
        return _NULL
    return _ranges(name)


def kernel_label(kind: str, level: Optional[int] = None) -> str:
    """Profiler name for a macro-op dispatch: ``geqrt@L3``."""
    base = kind.lower()
    return f"{base}@L{level}" if level is not None else base


def megakernel_label(p: int, q: int, batch: Optional[int] = None) -> str:
    """Profiler name for a persistent megakernel: ``megakernel[16x16]``."""
    if batch is not None and batch > 1:
        return f"megakernel[{batch}x{p}x{q}]"
    return f"megakernel[{p}x{q}]"


@contextlib.contextmanager
def capture(logdir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block into
    ``<logdir>/profile.json`` (Chrome trace format).

    Enables tracing and annotations for the duration, so spans and kernel
    launches carry their names into the trace.  A profiler that does not
    start or does not export counts ``profiler.capture_errors`` and the
    block still runs."""
    os.makedirs(logdir, exist_ok=True)
    prev = (instrument.tracing_enabled(), instrument.annotations_enabled())
    instrument.enable(tracing=True, annotations=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception:  # noqa: BLE001 — must not fail the workload
            prof = None
            metrics.counter("profiler.capture_errors", stage="start").inc()
        yield
    finally:
        try:
            if prof is not None:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(logdir, PROFILE_FILE))
        except Exception:  # noqa: BLE001
            metrics.counter("profiler.capture_errors", stage="stop").inc()
        instrument.enable(tracing=prev[0], annotations=prev[1])

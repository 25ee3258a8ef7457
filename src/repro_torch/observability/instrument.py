"""Observability master switches — one place every instrumented call
site checks before doing any work.

Counterpart of the reference's ``repro.observability.instrument``.  The
layer is **off by default**: with tracing disabled, span context managers
are shared no-op singletons (no timestamps, no allocation, no device
synchronize), and profiler annotations are ``contextlib.nullcontext``, so
a kernel launch carries no profiler range.  Metrics counters are always
live: they are plain dict increments, cheap enough to be the substrate
``QRService.stats()`` sits on, and the serving tests rely on them
unconditionally.

Switch surface (re-exported from :mod:`repro_torch.observability`):

  * :func:`enable` / :func:`disable` — flip tracing (+ profiler
    annotations) on or off; ``enable(annotations=False)`` records host
    spans without profiler ranges around the launches.
  * :func:`tracing_enabled` / :func:`annotations_enabled` — the fast
    flags call sites read (one attribute load + bool test).
  * :func:`enabled_scope` — context manager for tests and short
    captures; restores the prior state on exit.
  * ``REPRO_OBSERVABILITY=1`` in the environment enables tracing at
    import time (the CI capture hook).

Annotations are read at every launch (the port runs no traced program):
turning them on takes effect from the next kernel launch.
"""

from __future__ import annotations

import contextlib
import os
import threading

__all__ = [
    "annotations_enabled",
    "disable",
    "enable",
    "enabled_scope",
    "tracing_enabled",
]


class _State:
    """Mutable flag holder; attribute reads are the disabled fast path."""

    __slots__ = ("tracing", "annotations")

    def __init__(self) -> None:
        self.tracing = False
        self.annotations = False


_STATE = _State()
_LOCK = threading.Lock()


def tracing_enabled() -> bool:
    """Are host-side spans (and their device synchronizes) recording?"""
    return _STATE.tracing


def annotations_enabled() -> bool:
    """Should kernel launches carry profiler ranges (``record_function``,
    NVTX on a card)?"""
    return _STATE.annotations


def enable(*, tracing: bool = True, annotations: bool = True) -> None:
    """Turn the observability layer on (both planes by default)."""
    with _LOCK:
        _STATE.tracing = bool(tracing)
        _STATE.annotations = bool(annotations)


def disable() -> None:
    """Back to the zero-overhead default: no spans, no annotations."""
    with _LOCK:
        _STATE.tracing = False
        _STATE.annotations = False


@contextlib.contextmanager
def enabled_scope(*, tracing: bool = True, annotations: bool = True):
    """Enable within a ``with`` block, restoring the prior state after
    (test- and capture-friendly; nests correctly)."""
    prev = (_STATE.tracing, _STATE.annotations)
    enable(tracing=tracing, annotations=annotations)
    try:
        yield
    finally:
        with _LOCK:
            _STATE.tracing, _STATE.annotations = prev


if os.environ.get("REPRO_OBSERVABILITY", "").strip() in ("1", "true", "on"):
    enable()

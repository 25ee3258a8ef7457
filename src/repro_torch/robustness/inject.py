"""Deterministic fault injection — the chaos harness behind the
robustness layer's tests and ``chip_smoke.py``'s fault phase.

Counterpart of the reference's ``repro.robustness.inject``.  Every
degradation path the stack claims to have (admission quarantine,
health-check escalation, plan-build failure retry, shared-memory budget
rejection, circuit breaker) must be *provably reachable*; this module
plants deterministic faults at the seams so the tests can fire each one
on demand and watch the recovery:

    from repro_torch.robustness import inject

    with inject.active(inject.Fault(site="compile", match="32x32")):
        svc.submit_many(wave)       # the 32x32 bucket's plan build raises
                                    # InjectedFault -> the service
                                    # escalates down the ladder

Sites (each corresponds to one hook placed in production code):

  * ``"input"``   — seeded NaN/Inf corruption of a submitted matrix
                    (``QRService.submit``, pre-admission — exercises the
                    guard, not the math).
  * ``"output"``  — corrupt one chosen batch slice of a dispatch result
                    (``QRService.flush`` / ``checked_solve`` — exercises
                    the post-dispatch health check).
  * ``"compile"`` — raise from a bucket plan's build
                    (``QRService._build_plan``).
  * ``"dispatch"``— raise from a rung execution in the escalation
                    ladder (:mod:`repro_torch.robustness.escalate`) or a
                    bucket dispatch.
  * ``"vmem"``    — forced on-chip budget rejection: the engine's
                    ``_check_dispatch`` raises exactly where a real
                    over-budget workspace would (the site keeps the
                    reference's name; on the card the budget is shared
                    memory).
  * ``"latency"`` — ``time.sleep`` before a bucket dispatch (per-bucket
                    artificial latency; straggler/percentile tests).

Faults are matched by ``site`` plus a substring test of ``match``
against the call-site tag (bucket label like ``"64x64"``, rung name,
...; empty string matches everything) and disarm after ``times``
firings (``None`` = unlimited).  Corruption is **seeded** — the same
``Fault(seed=...)`` poisons the same elements every run, and the same
elements as the reference's.

The hooks are free when nothing is armed: every one starts with the
module-level ``enabled()`` flag test (one global read).  This module
imports nothing from the planner/engine/serving layers — it sits below
all of them so any layer can hook it without cycles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.observability import metrics as _metrics

__all__ = [
    "Fault",
    "InjectedFault",
    "active",
    "check",
    "corrupt_input",
    "corrupt_output",
    "enabled",
    "poison",
    "reset",
    "sleep",
]


class InjectedFault(RuntimeError):
    """Raised by an armed ``compile``/``dispatch``/``vmem`` fault."""

    def __init__(self, site: str, tag: str):
        self.site = site
        self.tag = tag
        super().__init__(f"injected {site} fault (tag={tag!r})")


@dataclasses.dataclass
class Fault:
    """One armed fault.  ``fired`` mutates as the fault triggers.

    site:   hook family — "input" | "output" | "compile" | "dispatch" |
            "vmem" | "latency"
    match:  substring of the call-site tag ("" matches every tag)
    times:  firings before the fault disarms (None = unlimited)
    kind:   corruption payload for input/output sites — "nan" | "inf"
    slice_index: which batch slice an "output" fault corrupts
    frac:   fraction of elements an "input" fault corrupts (>= 1 elem)
    seed:   RNG seed for corruption positions (determinism contract)
    delay_s: sleep duration for "latency" faults
    """

    site: str
    match: str = ""
    times: Optional[int] = 1
    kind: str = "nan"
    slice_index: int = 0
    frac: float = 0.05
    seed: int = 0
    delay_s: float = 0.0
    fired: int = 0

    def matches(self, site: str, tag: str) -> bool:
        if self.site != site or (self.match and self.match not in tag):
            return False
        return self.times is None or self.fired < self.times

    def fire(self, tag: str) -> None:
        self.fired += 1
        _metrics.counter("robustness.faults_injected", site=self.site).inc()


_FAULTS: List[Fault] = []
_LOCK = threading.Lock()


def enabled() -> bool:
    """Fast hook guard: is ANY fault armed?  (One list-truthiness read —
    the only cost production code pays when chaos is off.)"""
    return bool(_FAULTS)


def reset() -> None:
    """Disarm everything (test teardown)."""
    with _LOCK:
        _FAULTS.clear()


@contextlib.contextmanager
def active(*faults: Fault):
    """Arm ``faults`` for the scope; disarms (and only these) on exit."""
    with _LOCK:
        _FAULTS.extend(faults)
    try:
        yield faults
    finally:
        with _LOCK:
            for f in faults:
                if f in _FAULTS:
                    _FAULTS.remove(f)


def _match(site: str, tag: str) -> Optional[Fault]:
    with _LOCK:
        for f in _FAULTS:
            if f.matches(site, tag):
                f.fire(tag)
                return f
    return None


def check(site: str, tag: str) -> None:
    """Raise :class:`InjectedFault` if a matching fault is armed — the
    hook for the ``compile`` / ``dispatch`` / ``vmem`` sites."""
    if not _FAULTS:
        return
    if _match(site, tag) is not None:
        raise InjectedFault(site, tag)


def sleep(tag: str) -> None:
    """Artificial per-bucket latency (``latency`` site)."""
    if not _FAULTS:
        return
    f = _match("latency", tag)
    if f is not None and f.delay_s > 0:
        time.sleep(f.delay_s)


def _payload(kind: str) -> float:
    return float("inf") if kind == "inf" else float("nan")


def poison(a, *, kind: str = "nan", frac: float = 0.05, seed: int = 0):
    """Seeded copy of ``a`` (an array, or a tensor on any device) with
    ``max(1, frac * size)`` elements set to NaN/Inf — the pure helper
    chaos tests use to build poisoned requests (same seed => same
    poisoned positions, the reference's positions, in row-major order)."""
    if isinstance(a, torch.Tensor):
        out = a.detach().clone(memory_format=torch.contiguous_format)
        flat = out.view(-1)
        idx = torch.as_tensor(_poison_index(flat.numel(), frac, seed),
                              device=out.device)
    else:
        out = np.array(a, copy=True)
        flat = out.reshape(-1)
        idx = _poison_index(flat.size, frac, seed)
    flat[idx] = _payload(kind)
    return out


def _poison_index(size: int, frac: float, seed: int) -> np.ndarray:
    n = max(1, int(frac * size))
    return np.random.default_rng(seed).choice(size, size=n, replace=False)


def corrupt_input(a, tag: str):
    """``input`` site hook: poison a submitted matrix (an array or a
    tensor) pre-admission."""
    if not _FAULTS:
        return a
    f = _match("input", tag)
    if f is None:
        return a
    return poison(a, kind=f.kind, frac=f.frac, seed=f.seed)


def corrupt_output(out, tag: str):
    """``output`` site hook: corrupt one batch slice of a dispatch
    result.  ``out`` is a tensor or a tuple/list of tensors (on any
    device) with a leading batch axis; the fault's ``slice_index`` slice
    of EVERY factor goes to NaN/Inf (a health check must flag that slice
    and only that slice).  Single matrices (ndim == 2) corrupt whole.
    The inputs are not written: corrupted factors are copies."""
    if not _FAULTS:
        return out
    f = _match("output", tag)
    if f is None:
        return out
    val = _payload(f.kind)

    def bad(x: Optional[torch.Tensor]):
        if x is None:
            return x
        if x.ndim >= 3:
            y = x.clone()
            y[min(f.slice_index, x.shape[0] - 1)] = val
            return y
        return torch.full_like(x, val)

    if isinstance(out, (tuple, list)):
        return type(out)(bad(x) for x in out)
    return bad(out)

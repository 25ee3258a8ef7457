"""Step watchdog: straggler detection from wall-clock step times.

Counterpart of the reference's ``repro.distributed.fault_tolerance``
(``StepWatchdog`` and ``_median``).  ``StepWatchdog`` tracks a robust
step-time median; a step slower than ``threshold x median`` fires the
straggler callback and the ``fault.straggler_steps`` counter.  The
elastic re-mesh (``plan_elastic_mesh``) waits for ROADMAP A21.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from repro_torch.observability import metrics as _metrics

__all__ = ["StepWatchdog"]


def _median(xs: Sequence[float]) -> float:
    """True median: even-length windows average the two middle samples
    (the upper-middle pick alone biases the baseline high on bimodal
    step-time histories, under-firing the straggler rule)."""
    s = sorted(xs)
    h = len(s) // 2
    return s[h] if len(s) % 2 else 0.5 * (s[h - 1] + s[h])


class StepWatchdog:
    """Detects straggler steps from wall-clock timings."""

    def __init__(self, *, threshold: float = 2.5, window: int = 32,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self.straggler_steps: List[int] = []

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.monotonic() - self._t0
        self._t0 = None
        if len(self._times) >= 5:
            med = _median(self._times)
            if dt > self.threshold * med:
                self.straggler_steps.append(step)
                _metrics.counter("fault.straggler_steps").inc()
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def median(self) -> float:
        if not self._times:
            return 0.0
        return _median(self._times)

"""Fault tolerance: the step watchdog and the elastic re-mesh.

Counterpart of the reference's ``repro.distributed.fault_tolerance``.

  * ``StepWatchdog`` tracks a robust step-time median; a step slower than
    ``threshold x median`` fires the straggler callback and the
    ``fault.straggler_steps`` counter;
  * ``plan_elastic_mesh`` rebuilds the largest power-of-two (data, model)
    mesh from the surviving ranks.  The reference's takes JAX devices and
    builds the mesh; the port's takes rank ids and returns the rank grid,
    from which :meth:`ElasticPlan.device_mesh` builds the ``DeviceMesh``
    in the restarted process group.  Restore then reshards the checkpoint
    onto it (:class:`repro_torch.checkpoint.CheckpointManager` stores
    whole tensors).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import largest_pow2
from repro_torch.observability import metrics as _metrics

__all__ = ["StepWatchdog", "ElasticPlan", "plan_elastic_mesh"]


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


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A (data, model) mesh over surviving ranks: ``ranks`` is the grid
    of rank ids, row-major (data major), as the reference lays its
    devices; ``dropped_devices`` counts the ranks given that it leaves
    out (failed or past the power of two)."""

    ranks: Tuple[Tuple[int, ...], ...]
    data_size: int
    model_size: int
    dropped_devices: int

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of the plan, axes ``("data", "model")``, in
        the current process group (whose ranks the grid names)."""
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(device_type, torch.tensor(self.ranks),
                          mesh_dim_names=("data", "model"))


def plan_elastic_mesh(ranks: Sequence[int], *, failed: Sequence[int] = (),
                      prefer_model: int = 16) -> ElasticPlan:
    """The largest power-of-two (data, model) mesh over ``ranks`` without
    ``failed``: the model axis kept at ``prefer_model`` when enough ranks
    survive (the TP degree is fixed by the model's memory footprint), the
    data axis shrinking — the standard elastic-DP policy."""
    gone = set(failed)
    alive = [r for r in ranks if r not in gone]
    if not alive:
        raise RuntimeError("no devices left")
    usable = largest_pow2(len(alive))
    model = min(prefer_model, usable)
    data = usable // model
    grid = tuple(tuple(alive[i * model:(i + 1) * model]) for i in range(data))
    return ElasticPlan(ranks=grid, data_size=data, model_size=model,
                       dropped_devices=len(ranks) - usable)

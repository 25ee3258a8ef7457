"""Input admission: reject a bad request BEFORE it contaminates a bucket.

Counterpart of the reference's ``repro.robustness.guards``: it works on
host (numpy) payloads and on tensors, on the tensor's own device (a
request already on the card is scanned there, not copied to the host).

The serving layer stacks heterogeneous requests into one padded batch
and factors the stack in one dispatch — which means a single NaN
payload poisons every request sharing its bucket (the megakernel's
macro-ops propagate non-finite values across the whole workspace, and
a batched slice is bitwise the single run, so it reproduces the garbage).
Admission moves the failure to the cheapest possible point: an O(mn)
scan at ``QRService.submit``, quarantining the offender with
a named reason while its bucket-mates proceed untouched.

    from repro_torch.robustness import guards

    guards.admit(a)                      # raises AdmissionError or returns
    guards.admit(a, policy=guards.AdmissionPolicy(max_cond=1e8))

Named rejection reasons (``AdmissionError.reason`` — stable slugs the
service surfaces per request and counts under
``robustness.quarantined{reason=...}``):

  * ``nonfinite_input``  — NaN/Inf anywhere in the payload
  * ``bad_ndim``         — not a 2-D matrix
  * ``non_float_dtype``  — integer/complex/bool payload (the engine's
                           macro-ops are real-float realizations)
  * ``ill_conditioned``  — exact 2-norm condition number above
                           ``policy.max_cond`` (OPT-IN: costs an SVD,
                           O(mn^2) — same order as the factorization
                           itself, so it is a debugging/acceptance
                           guard, not a steady-state one; ``max_cond``
                           defaults to None = skip)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

__all__ = ["AdmissionError", "AdmissionPolicy", "admit",
           "estimate_condition"]


class AdmissionError(ValueError):
    """A request failed admission; ``reason`` is the stable slug."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        super().__init__(f"{reason}: {detail}")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """What :func:`admit` enforces.  The default is the cheap, always-on
    contract (finite 2-D float); ``max_cond`` opts into the expensive
    conditioning guard."""

    require_finite: bool = True
    require_float: bool = True
    max_cond: Optional[float] = None


DEFAULT_ADMISSION = AdmissionPolicy()


def estimate_condition(a: np.ndarray) -> float:
    """2-norm condition number sigma_max / sigma_min via SVD (exact, and
    priced accordingly — O(mn^2), the cost of the factorization it
    guards).  Rank-deficient input returns inf."""
    s = np.linalg.svd(np.asarray(a, dtype=np.float64), compute_uv=False)
    if s.size == 0 or s[-1] == 0.0:
        return float("inf")
    return float(s[0] / s[-1])


def admit(a, *, policy: Optional[AdmissionPolicy] = None) -> None:
    """Admission check of an array or a tensor; raises
    :class:`AdmissionError` with a named reason, returns None on
    acceptance.  Order: cheap structural checks first, the O(mn) finite
    scan next (on a tensor's own device), the opt-in SVD guard last (on
    the host)."""
    policy = DEFAULT_ADMISSION if policy is None else policy
    tensor = isinstance(a, torch.Tensor)
    arr = a.detach() if tensor else np.asarray(a)
    shape = tuple(arr.shape)
    if arr.ndim != 2:
        raise AdmissionError("bad_ndim",
                             f"expected a matrix, got shape {shape}")
    if policy.require_float and not (
            arr.is_floating_point() if tensor else arr.dtype.kind == "f"):
        raise AdmissionError(
            "non_float_dtype",
            f"expected a real floating dtype, got {arr.dtype}")
    if policy.require_finite and math.prod(shape):
        finite = torch.isfinite(arr) if tensor else np.isfinite(arr)
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise AdmissionError(
                "nonfinite_input",
                f"{bad} non-finite element(s) in a {shape} payload")
    if policy.max_cond is not None and min(shape) > 0:
        cond = estimate_condition(arr.cpu().numpy() if tensor else arr)
        if cond > policy.max_cond:
            raise AdmissionError(
                "ill_conditioned",
                f"cond_2(a) ~ {cond:.3e} > max_cond={policy.max_cond:.3e}")

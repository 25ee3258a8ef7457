"""Post-dispatch health checks: is the factorization a factorization?

Counterpart of the reference's ``repro.robustness.verify``.  Householder
QR has cheap, well-conditioned post-conditions — for an accepted (Q, R)
of an m x n input A,

    relative residual   ||A - Q R||_F / ||A||_F        <= tol
    orthogonality       ||Q^T Q - I||_F                <= tol

both hold to O(eps * max(m, n)) for HT and MHT orderings (paper §IV)
and for the tiled flat-tree DAG, so an O(mn k) check certifies an
O(mn^2) factorization.  The tolerance is **the conformance rule**
(tests/test_conformance.py pins every registered method to
``100 * eps * max(m, n)``): a dispatch whose output a conformance test
would fail is exactly a dispatch the escalation ladder should retry.

For R-only results (serving mode="r") there is no Q to test; the Gram
identity ``A^T A = R^T R`` stands in — its backward error carries the
same eps * max(m, n) scaling relative to ||A||_F^2.

Batched dispatches are checked **per slice** by one batched pass over the
stack on its own device (:func:`check_batch` / :func:`check_ortho_batch`),
then one copy of the (batch, 2) statistics to the host, so a single bad
slice is identified and re-solved alone.

The statistics are computed in float64.  A float32 residual taken with
TF32-grade products (a caller's ``torch.backends.cuda.matmul.allow_tf32``)
would be about 1e-3 at 128², against a tolerance of 1.5e-3: healthy
slices would escalate.  In float64 the verdict does not depend on the
caller's matmul precision.

The knob: ``QRConfig.verify`` (tri-state) with the ``REPRO_VERIFY``
environment default, read at call time (:func:`verify_enabled`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "HealthReport",
    "VERIFY_TOL_FACTOR",
    "check_batch",
    "check_ortho",
    "check_ortho_batch",
    "check_qr",
    "check_r",
    "tolerance",
    "verify_enabled",
]

# The conformance suite's single tolerance rule (tests/test_conformance.py
# ``_tol``): every registered method is held to 100 * eps * max(m, n).
# Health checks reuse it verbatim so "fails verification" and "would
# fail conformance" are the same predicate.
VERIFY_TOL_FACTOR = 100.0


def _eps(dtype) -> float:
    if isinstance(dtype, torch.dtype):
        return float(torch.finfo(dtype).eps)
    return float(np.finfo(np.dtype(dtype)).eps)


def tolerance(dtype, m: int, n: int) -> float:
    """The conformance rule: ``100 * eps(dtype) * max(m, n)``; ``dtype``
    a torch dtype, numpy dtype or dtype name."""
    return VERIFY_TOL_FACTOR * _eps(dtype) * max(m, n, 1)


def verify_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve the tri-state verify knob: an explicit True/False wins;
    None falls back to the ``REPRO_VERIFY`` environment default (read
    at call time, so tests and deployments can flip it live)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_VERIFY", "").strip().lower() in (
        "1", "true", "on", "yes")


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One slice's verdict.  ``reason`` is None when healthy, else a
    stable slug ("nonfinite_output" | "residual_exceeds_tol" |
    "ortho_defect_exceeds_tol" | "gram_residual_exceeds_tol")."""

    ok: bool
    residual: float
    ortho_defect: float
    tol: float
    reason: Optional[str] = None


def _report(residual: float, defect: float, tol: float,
            gram: bool = False) -> HealthReport:
    residual, defect = float(residual), float(defect)
    if not (np.isfinite(residual) and np.isfinite(defect)):
        reason = "nonfinite_output"
    elif residual > tol:
        reason = "gram_residual_exceeds_tol" if gram \
            else "residual_exceeds_tol"
    elif defect > tol:
        reason = "ortho_defect_exceeds_tol"
    else:
        reason = None
    return HealthReport(ok=reason is None, residual=residual,
                        ortho_defect=defect, tol=tol, reason=reason)


def _f64(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array) as float64 on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def _device(*xs) -> torch.device:
    """The device of the first tensor among ``xs``; arrays live on the
    host."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _fro(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.flatten(1), dim=-1)


def _rel(resid: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, resid / scale.clamp_min(1e-300), resid)


def _ortho_stats(q: torch.Tensor) -> torch.Tensor:
    k = q.shape[-1]
    gram = q.mT @ q - torch.eye(k, dtype=q.dtype, device=q.device)
    return _fro(gram)


def _qr_stats(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor
              ) -> torch.Tensor:
    """Per-slice (relative residual, orthogonality defect) over a leading
    batch axis, as a (batch, 2) float64 tensor on the inputs' device.
    Empty (all-zero) padding slices report 0/0."""
    rel = _rel(_fro(a - q @ r), _fro(a))
    return torch.stack([rel, _ortho_stats(q)], dim=-1)


def _r_stats(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-slice Gram residual ||A^T A - R^T R||_F / ||A||_F^2 plus an
    upper-triangularity defect (relative mass below the diagonal)."""
    rel = _rel(_fro(a.mT @ a - r.mT @ r), _fro(a) ** 2)
    tri = _fro(r - torch.triu(r)) / _fro(r).clamp_min(1e-300)
    return torch.stack([rel, tri], dim=-1)


def _stats_batch(a_stack, q_stack, r_stack) -> np.ndarray:
    """(batch, 2) host array of :func:`_qr_stats` (or :func:`_r_stats`
    when ``q_stack`` is None), computed in float64 on the stack's
    device."""
    dev = _device(a_stack, q_stack, r_stack)
    a, r = _f64(a_stack, dev), _f64(r_stack, dev)
    if q_stack is None:
        out = _r_stats(a, r)
    else:
        out = _qr_stats(a, _f64(q_stack, dev), r)
    return out.cpu().numpy()


def _dtype_shape(x):
    return x.dtype, int(x.shape[-2]), int(x.shape[-1])


# ------------------------------------------------------- public checks

def check_qr(a, q, r, *, tol: Optional[float] = None) -> HealthReport:
    """Health of one (Q, R) against its input."""
    dtype, m, n = _dtype_shape(a)
    tol = tolerance(dtype, m, n) if tol is None else tol
    rel, defect = _stats_batch(_lift(a), _lift(q), _lift(r))[0]
    return _report(rel, defect, tol)


def check_r(a, r, *, tol: Optional[float] = None) -> HealthReport:
    """Health of an R-only result via the Gram identity."""
    dtype, m, n = _dtype_shape(a)
    tol = tolerance(dtype, m, n) if tol is None else tol
    rel, tri = _stats_batch(_lift(a), None, _lift(r))[0]
    return _report(rel, tri, tol, gram=True)


def check_ortho(q, *, tol: Optional[float] = None) -> HealthReport:
    """Orthogonality-only health (the optimizer path holds Q, not R)."""
    return check_ortho_batch(_lift(q), tol=tol)[0]


def check_batch(a_stack, q_stack, r_stack, *,
                tol: Optional[float] = None) -> List[HealthReport]:
    """Per-slice health of one batched (Q, R) dispatch — ONE batched
    float64 pass over the stack, then host-side verdicts, so a single bad
    slice is identified without re-running the good ones.  Pass
    ``q_stack=None`` for R-only buckets (Gram-identity check)."""
    dtype, m, n = _dtype_shape(a_stack)
    tol = tolerance(dtype, m, n) if tol is None else tol
    stats = _stats_batch(a_stack, q_stack, r_stack)
    gram = q_stack is None
    return [_report(rel, defect, tol, gram=gram) for rel, defect in stats]


def check_ortho_batch(q_stack, *, tol: Optional[float] = None
                      ) -> List[HealthReport]:
    """Per-slice orthogonality defects of a batched thin-Q stack."""
    dtype, m, n = _dtype_shape(q_stack)
    tol = tolerance(dtype, m, n) if tol is None else tol
    dev = _device(q_stack)
    defect = _ortho_stats(_f64(q_stack, dev)).cpu().numpy()
    return [_report(0.0, d, tol) for d in defect]


def _lift(x):
    """One matrix as a stack of one."""
    return None if x is None else x[None]

"""Public QR API — thin wrappers over the :mod:`repro_torch.core.plan` planner.

    qr(a, config=QRConfig(...))  -> (Q, R) or R
    orthogonalize(m)             -> sign-fixed thin Q (optimizer primitive)
    lstsq(a, b)                  -> QR-based least-squares solve
    qr_algorithm_eig(a, iters)   -> eigenvalues via the QR algorithm (§1 App. 2)

Counterpart of the reference's ``repro.core.api``.  Every entry point
runs on ``"cuda"`` unless the caller passes ``device="cpu"``; without a
card and without ``device="cpu"`` it raises.  Inputs may be tensors or
arrays; they are moved to the device.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.plan import QRConfig, plan, resolve_device

__all__ = ["qr", "orthogonalize", "lstsq", "qr_algorithm_eig", "QRConfig",
           "plan"]

_DEFAULT = QRConfig()


def _on(a, device) -> Tuple[torch.Tensor, str]:
    dev = resolve_device(device)
    return torch.as_tensor(a, device=dev), dev.type


def qr(a, *, config: Optional[QRConfig] = None, device=None
       ) -> Union[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """QR factorization with a registry-selected realization.

    ``config.mode``: "reduced" -> (Q thin m x k, R k x n); "r" -> R only;
    "full" -> (Q m x m, R m x n).  ``config=None`` plans with
    ``QRConfig()`` (method "auto").

    With ``config.verify`` True (or None and ``REPRO_VERIFY`` set) the
    result is health-checked against the conformance tolerance, slice by
    slice for a stack, and a failed check walks the degradation ladder
    (:func:`repro_torch.robustness.escalate.checked_solve`) on the same
    device."""
    a, backend = _on(a, device)
    if a.ndim < 2:
        raise ValueError(f"qr expects a matrix, got shape {tuple(a.shape)}")
    cfg = _DEFAULT if config is None else config
    solver = plan(a.shape, a.dtype, cfg, backend=backend)
    if cfg.verify is not False:
        from repro_torch.robustness.verify import verify_enabled

        if verify_enabled(cfg.verify):
            from repro_torch.robustness.escalate import checked_solve

            return checked_solve(solver, a)
    return solver.solve(a)


def orthogonalize(m_in, *, config: Optional[QRConfig] = None,
                  device=None) -> torch.Tensor:
    """Q * diag(sign(diag(R))) of the input's column space (wide matrices
    are handled by factorizing the transpose)."""
    m_in, backend = _on(m_in, device)
    if m_in.ndim < 2:
        raise ValueError(f"orthogonalize expects a matrix, got shape "
                         f"{tuple(m_in.shape)}")
    cfg = (_DEFAULT if config is None else config).replace(
        mode="reduced", sign_fix=True)
    transpose = m_in.shape[-2] < m_in.shape[-1]
    a = m_in.transpose(-1, -2) if transpose else m_in
    q = plan(a.shape, a.dtype, cfg, backend=backend).orthogonalize(a)
    return q.transpose(-1, -2) if transpose else q


def lstsq(a, b, *, config: Optional[QRConfig] = None,
          device=None) -> torch.Tensor:
    """Least-squares solve ``min ||a x - b||`` via QR (m >= n):
    x = R^{-1} Q^T b."""
    a, backend = _on(a, device)
    b, _ = _on(b, device)
    cfg = (_DEFAULT if config is None else config).replace(
        mode="reduced", sign_fix=False)
    return plan(a.shape, a.dtype, cfg, backend=backend).lstsq(a, b)


def qr_algorithm_eig(a, *, iters: int = 200,
                     config: Optional[QRConfig] = None,
                     device=None) -> torch.Tensor:
    """Eigenvalues of symmetric ``a``, descending, via the (unshifted) QR
    algorithm — paper §1 Application 2, Algorithm 1: A_{k+1} = R_k Q_k,
    a plain loop of planned solves and products on the device."""
    a, backend = _on(a, device)
    cfg = (_DEFAULT if config is None else config).replace(
        mode="reduced", sign_fix=False)
    solver = plan(a.shape, a.dtype, cfg, backend=backend)
    ak = a
    for _ in range(iters):
        q, r = solver.solve(ak)
        ak = r @ q
    return torch.sort(torch.diagonal(ak, dim1=-2, dim2=-1), dim=-1,
                      descending=True).values

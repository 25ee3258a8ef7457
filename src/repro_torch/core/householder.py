"""Classical Householder QR (``DGEQR2``, paper §2.2 / Algorithm 2) and the
packed-form helpers every factorization of the port shares.

Counterpart of the reference's ``repro.core.householder``, on tensors
with any number of leading batch dimensions (each matrix independent).
LAPACK conventions throughout:

    H_j = I - tau_j v_j v_j^T,   v_j[j] = 1,   A = Q R,
    Q = H_0 H_1 ... H_{k-1},     k = min(m, n),

packed with R on and above the diagonal and the reflectors (without their
implicit leading 1) below it, element for element the reference's layout.
The column loops are Python loops; a loop updates its working copy of the
matrix in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "house_vector",
    "geqr2",
    "geqr2_explicit_p",
    "form_q",
    "apply_q",
    "unpack_r",
    "unpack_v",
]

Tensor = torch.Tensor


def _safe_sign(x: Tensor) -> Tensor:
    """sign(x) with sign(0) := 1 (the LAPACK ``dlarfg`` convention)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def house_vector(x: Tensor, offset: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The reflector that annihilates ``x[..., offset+1:]`` (rows above
    ``offset`` are ignored), LAPACK ``dlarfg`` with the scaled norm:

        beta = -sign(x0) ||x[offset:]||,  tau = (beta - x0) / beta,
        v[offset] = 1,  v[offset+1:] = x[offset+1:] / (x0 - beta),

    over the last dimension of ``x``.  An exactly zero tail gives
    ``tau = 0`` and ``beta = x0`` (H = I).  Returns ``(v, tau, beta)``."""
    m = x.shape[-1]
    idx = torch.arange(m, device=x.device)
    below = idx > offset
    at = idx == offset
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    x0 = torch.where(at, x, zero).sum(-1)
    tail = torch.where(below, x, zero)
    # Scale for overflow safety: ||tail||^2 on normalized data.
    scale = torch.maximum(tail.abs().amax(-1), x0.abs())
    scale = torch.where(scale == 0.0, 1.0, scale)
    t = tail / scale[..., None]
    x0s = x0 / scale
    tail_norm2 = (t * t).sum(-1)
    norm = scale * torch.sqrt(x0s * x0s + tail_norm2)

    beta = -_safe_sign(x0) * norm
    degenerate = tail_norm2 == 0.0
    denom = torch.where(degenerate, 1.0, x0 - beta)
    v = torch.where(below, x / denom[..., None], zero) + at.to(x.dtype)
    tau = torch.where(degenerate, zero,
                      (beta - x0) / torch.where(beta == 0.0, 1.0, beta))
    beta = torch.where(degenerate, x0, beta)
    return v, tau, beta


def _two_pass_update_(a: Tensor, v: Tensor, tau: Tensor, col: int) -> None:
    """Classical trailing update in place (paper Algorithm 2, fig 6):
    pass 1 (DGEMV) ``w = tau v^T A``, pass 2 (DGER) ``A -= v w``, on the
    columns after ``col``."""
    trail = a[..., :, col + 1:]
    w = tau[..., None] * (v[..., None, :] @ trail)[..., 0, :]
    trail -= v[..., :, None] * w[..., None, :]


def _write_packed_column(a: Tensor, v: Tensor, beta: Tensor, col: int,
                         pivot_row: Optional[int] = None) -> Tensor:
    """Store ``beta`` at the pivot row and ``v`` below it into column
    ``col`` of ``a``, in place; rows above the pivot keep their values.
    ``pivot_row`` defaults to ``col``; panel factorizations pass
    ``row0 + local_col``.  Returns ``a``."""
    pivot = col if pivot_row is None else pivot_row
    a[..., pivot + 1:, col] = v[..., pivot + 1:]
    if pivot < a.shape[-2]:
        a[..., pivot, col] = beta
    return a


def geqr2(a: Tensor, *, num_cols: Optional[int] = None
          ) -> Tuple[Tensor, Tensor]:
    """Classical HT QR (LAPACK ``DGEQR2``): two-pass trailing updates.
    Returns ``(packed, taus)`` with ``taus`` of length ``min(m, n)`` (or
    ``num_cols``)."""
    m, n = a.shape[-2:]
    k = min(m, n) if num_cols is None else num_cols
    a = a.clone()
    taus = a.new_zeros(a.shape[:-2] + (k,))
    for j in range(k):
        v, tau, beta = house_vector(a[..., :, j], j)
        _two_pass_update_(a, v, tau, j)
        _write_packed_column(a, v, beta, j)
        taus[..., j] = tau
    return a, taus


def geqr2_explicit_p(a: Tensor) -> Tuple[Tensor, Tensor]:
    """Textbook classical HT: materialize ``P = I - tau v v^T`` and apply
    it with a matrix product — the paper's fig-6 DAG made literal,
    O(m^2 n) per column."""
    m, n = a.shape[-2:]
    k = min(m, n)
    a = a.clone()
    taus = a.new_zeros(a.shape[:-2] + (k,))
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    for j in range(k):
        v, tau, beta = house_vector(a[..., :, j], j)
        p = eye - tau[..., None, None] * (v[..., :, None] * v[..., None, :])
        a[..., :, j + 1:] = p @ a[..., :, j + 1:]
        _write_packed_column(a, v, beta, j)
        taus[..., j] = tau
    return a, taus


def unpack_r(packed: Tensor, n: Optional[int] = None) -> Tensor:
    """R (upper triangular, k x n) of the packed factorization."""
    m, ncols = packed.shape[-2:]
    n = ncols if n is None else n
    k = min(m, ncols)
    return torch.triu(packed)[..., :k, :n]


def unpack_v(packed: Tensor) -> Tensor:
    """V (m x k, unit lower trapezoidal) of the packed factorization."""
    m, n = packed.shape[-2:]
    k = min(m, n)
    v = torch.tril(packed[..., :, :k], -1)
    return v + torch.eye(m, k, dtype=packed.dtype, device=packed.device)


def apply_q(packed: Tensor, taus: Tensor, c: Tensor, *,
            transpose: bool = False) -> Tensor:
    """Apply Q (or Q^T) of the packed factorization to ``c`` (m x p), one
    reflector at a time:

        Q   = H_0 H_1 ... H_{k-1}   (applied back to front)
        Q^T = H_{k-1} ... H_1 H_0   (applied front to back)
    """
    k = taus.shape[-1]
    v_all = unpack_v(packed)
    c = c.clone()
    for j in (range(k) if transpose else reversed(range(k))):
        v = v_all[..., :, j]
        w = taus[..., j, None] * (v[..., None, :] @ c)[..., 0, :]
        c -= v[..., :, None] * w[..., None, :]
    return c


def form_q(packed: Tensor, taus: Tensor, *, full: bool = False) -> Tensor:
    """Materialize Q — thin (m x k) by default, or full (m x m) — one
    reflector at a time (:func:`apply_q`)."""
    m = packed.shape[-2]
    cols = m if full else taus.shape[-1]
    eye = torch.eye(m, cols, dtype=packed.dtype, device=packed.device)
    return apply_q(packed, taus, eye.expand(packed.shape[:-2] + (m, cols)))


# -- registry -----------------------------------------------------------------
from repro_torch.core.plan import MethodSpec, register_method  # noqa: E402

register_method(MethodSpec(
    name="geqr2",
    factor=lambda a, cfg: geqr2(a),
    description="classical HT, two-pass updates (LAPACK DGEQR2)",
))

"""TSQR pieces ported so far: ``Q = A R^{-1}`` for ``q_method="solve"``,
and the ``tsqr`` capability card with its ``nblocks`` resolve hook.

Counterpart of parts of the reference's ``repro.core.tsqr``; the tree
factorization itself is ROADMAP A8.
"""

from __future__ import annotations

import torch

from repro_torch.core.plan import MethodSpec, QRConfig, RouteDecision, register_method

__all__ = ["triangular_inverse_apply", "default_nblocks"]


def triangular_inverse_apply(a: torch.Tensor, r: torch.Tensor, *,
                             rcond: float = 1e-7) -> torch.Tensor:
    """``a @ r^{-1}`` by triangular solve, with a sign-preserving diagonal
    clamp for near-singular R; leading batch dimensions are independent."""
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    dmax = torch.clamp(d.abs().amax(-1, keepdim=True), min=1e-30)
    floor = rcond * dmax
    clamp = torch.where(d.abs() < floor, torch.where(d >= 0, floor, -floor), d)
    r_safe = r + torch.diag_embed(clamp - d)
    # a r^{-1}  <=>  solve r^T x^T = a^T with lower-triangular r^T
    return torch.linalg.solve_triangular(r_safe.mT, a.mT, upper=False).mT


def default_nblocks(m: int, n: int) -> int:
    """Largest divisor of m in [2, 8] scaled by aspect."""
    nb = max(2, min(8, m // max(n, 1)))
    while m % nb != 0:
        nb -= 1
    return max(nb, 1)


def _resolve_tsqr(m: int, n: int, cfg: QRConfig, *, dtype=None,
                  explain=None) -> QRConfig:
    nb = cfg.nblocks if cfg.nblocks is not None else default_nblocks(m, n)
    if m % nb != 0:
        raise ValueError(f"m={m} not divisible by nblocks={nb}")
    if explain is not None and cfg.nblocks is None:
        explain.append(RouteDecision(
            "tsqr_nblocks", "resolved",
            f"nblocks={nb} (largest divisor of m={m} in [2, 8] scaled "
            f"by aspect) — merge tree depth {(nb - 1).bit_length()}"))
    return cfg.replace(nblocks=nb)


def _solve_tsqr(a, cfg):
    raise NotImplementedError(
        "method 'tsqr' is not ported to repro_torch yet (ROADMAP A8)")


register_method(MethodSpec(
    name="tsqr",
    solve=_solve_tsqr,
    resolve=_resolve_tsqr,
    supports_full_q=False,
    min_aspect=4.0,
    kernel_backed=True,
    description="tall-skinny tree QR (single device; sharded via shard_map)",
))

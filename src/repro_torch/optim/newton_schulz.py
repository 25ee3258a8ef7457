"""Newton-Schulz orthogonalization — the Muon-default baseline the QR path
is ablated against (the ``muon-ns`` optimizer).

Counterpart of the reference's ``repro.optim.newton_schulz``.  Quintic NS
iteration (Keller Jordan's Muon coefficients): approximates UV^T of the
input's SVD, on the normalized matrix, 5 iterations in fp32 (the
optimizer state is fp32).  Leading dims are independent matrices.
"""

from __future__ import annotations

import torch

__all__ = ["newton_schulz_orthogonalize"]

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz_orthogonalize(g: torch.Tensor, *, steps: int = 5,
                                eps: float = 1e-7) -> torch.Tensor:
    """Approximate orthogonal factor (UV^T) of each trailing 2-D matrix."""
    if g.ndim < 2:
        raise ValueError(f"expected >= 2-D, got {tuple(g.shape)}")
    a, b, c = _NS_COEFFS
    transpose = g.shape[-2] > g.shape[-1]
    x = g.mT if transpose else g                      # rows <= cols
    x = x / (torch.linalg.matrix_norm(x)[..., None, None] + eps)
    for _ in range(steps):
        xxt = x @ x.mT
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.mT if transpose else x

"""Compact-WY helpers of blocked Householder QR (``DLARFT`` and the V
unpacking of a packed panel), on tensors with a leading batch dimension.

Counterpart of the reference's ``repro.core.blocked`` (``larft`` and
``unpack_v_panel``); the blocked factorizations themselves are not part
of this package yet.
"""

from __future__ import annotations

import torch

__all__ = ["larft", "unpack_v_panel"]


def larft(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Upper-triangular block reflectors T (``DLARFT``, forward,
    columnwise) of a batch: ``v`` is ``(B, m, b)`` unit-lower-trapezoidal,
    ``taus`` is ``(B, b)``, and ``H_0 .. H_{b-1} = I - V T V^T``."""
    b = v.shape[-1]
    gram = v.transpose(-1, -2) @ v  # only the strictly-lower part is read
    t = torch.zeros(v.shape[:-2] + (b, b), dtype=v.dtype, device=v.device)
    for i in range(b):
        tau = taus[..., i]
        if i:
            w = gram[..., :i, i]
            t[..., :i, i] = -tau[..., None] * (t[..., :i, :i] @ w[..., None])[..., 0]
        t[..., i, i] = tau
    return t


def unpack_v_panel(panel: torch.Tensor, row0: int) -> torch.Tensor:
    """Unit-lower-trapezoidal V of a packed ``(..., m, b)`` panel whose
    column ``j`` pivots at row ``row0 + j``."""
    m, b = panel.shape[-2:]
    rows = torch.arange(m, device=panel.device)[:, None]
    pivs = row0 + torch.arange(b, device=panel.device)[None, :]
    v = torch.where(rows > pivs, panel, torch.zeros((), dtype=panel.dtype,
                                                    device=panel.device))
    return v + (rows == pivs).to(panel.dtype)

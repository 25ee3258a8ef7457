"""Plain oracles of the panel, trailing and single-tile kernels.

Counterpart of the reference's ``repro.kernels.ref``, realized
independently of the kernels' own plain versions (through
:func:`repro_torch.core.blocked.panel_factor` and plain products), and
like the reference computed in float32 whatever the input type: an fp64
result is held against ``panel_factor`` / ``geqr2_ht``, not against
these.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["mht_panel_ref", "wy_trailing_ref", "tsqrt_ref", "ssrfb_ref",
           "ht_update_two_pass_ref"]

Tensor = torch.Tensor
_F32 = torch.float32


def mht_panel_ref(panel: Tensor, row0: int = 0) -> Tuple[Tensor, Tensor]:
    """Oracle of ``ops.mht_panel``: the ``(m, b)`` panel whose column
    ``lj`` pivots at row ``row0 + lj``, factored with the fused MHT
    update in float32."""
    from repro_torch.core.blocked import panel_factor

    packed, taus = panel_factor(panel.to(_F32), row0, method="mht")
    return packed.to(panel.dtype), taus.to(panel.dtype)


def wy_trailing_ref(v: Tensor, t: Tensor, c: Tensor) -> Tensor:
    """Oracle of ``ops.wy_trailing``: ``C - V (T^T (V^T C))`` in float32."""
    v32, c32 = v.to(_F32), c.to(_F32)
    w = t.to(_F32).mT @ (v32.mT @ c32)
    return (c32 - v32 @ w).to(c.dtype)


def tsqrt_ref(r: Tensor, a: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Oracle of ``tile_ops.tsqrt``: the dense MHT panel factorization of
    ``[R; A]`` (R upper triangular), returning ``(R new, V2, taus)``."""
    from repro_torch.core.blocked import panel_factor

    nb = r.shape[-1]
    packed, taus = panel_factor(torch.cat([r, a], dim=-2).to(_F32), 0,
                                method="mht")
    return (packed[..., :nb, :].to(r.dtype), packed[..., nb:, :].to(r.dtype),
            taus.to(r.dtype))


def ssrfb_ref(v2: Tensor, t: Tensor, ck: Tensor, ci: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """Oracle of ``tile_ops.ssrfb``: ``W = T^T (C_k + V2^T C_i)``,
    ``C_k - W``, ``C_i - V2 W`` in float32."""
    v32, ck32, ci32 = v2.to(_F32), ck.to(_F32), ci.to(_F32)
    w = t.to(_F32).mT @ (ck32 + v32.mT @ ci32)
    return (ck32 - w).to(ck.dtype), (ci32 - v32 @ w).to(ci.dtype)


def ht_update_two_pass_ref(a: Tensor, v: Tensor, tau: Tensor) -> Tensor:
    """The classical two-pass trailing update ``w = tau v^T A``, then
    ``A - v w``, in float32."""
    a32, v32 = a.to(_F32), v.to(_F32)
    w = tau.to(_F32)[..., None] * (v32[..., None, :] @ a32)[..., 0, :]
    return (a32 - v32[..., :, None] * w[..., None, :]).to(a.dtype)

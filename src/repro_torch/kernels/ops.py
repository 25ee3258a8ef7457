"""Public wrappers of the panel and trailing kernels: ``mht_panel`` and
``wy_trailing``, each with its shared-memory estimator.

Counterpart of the reference's ``repro.kernels.ops``.  On a CPU tensor a
wrapper runs its kernel's plain version
(:func:`repro_torch.kernels.macro_ops.panel_body` /
:func:`~repro_torch.kernels.macro_ops.wy_body`); on a CUDA tensor it
launches the hand-written kernel (:mod:`.mht_panel`, :mod:`.wy_trailing`)
or raises.  Each takes one matrix or a ``(B, ...)`` stack, which is one
launch.  The ``*_`` forms work in place on views (unit column stride),
so the blocked factorization updates its matrix without copies.

This backend registers the ``"mht_panel"`` :class:`KernelPolicy` that the
planner's ``use_kernel=None`` rule holds the estimators against.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from repro_torch.core.plan import (DEFAULT_SMEM_BUDGET, KernelPolicy,
                                   register_kernel_policy)
from repro_torch.kernels import macro_ops
from repro_torch.kernels import mht_panel as _panel
from repro_torch.kernels import wy_trailing as _trailing

__all__ = ["mht_panel", "mht_panel_", "wy_trailing", "wy_trailing_",
           "mht_panel_smem_bytes", "wy_trailing_smem_bytes",
           "panel_path_smem_bytes"]

Tensor = torch.Tensor

_POLICY = register_kernel_policy(KernelPolicy("mht_panel", DEFAULT_SMEM_BUDGET))


def mht_panel_smem_bytes(m: int, b: int, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the panel kernel on an ``(m, b)`` panel
    whose first pivot is row 0 (raises past the kernel's row cap)."""
    return _panel.smem_bytes(m, b, itemsize)


def wy_trailing_smem_bytes(k: int, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the trailing kernel for ``k`` reflectors."""
    return _trailing.smem_bytes(k, itemsize)


def panel_path_smem_bytes(m: int, b: int, ks: Iterable[int],
                          itemsize: int = 4) -> int:
    """The largest per-CTA shared memory of a path that runs the panel
    kernel on ``(m, b)`` panels and the trailing kernel with each ``k`` in
    ``ks``: what the planner holds against the budget."""
    return max([mht_panel_smem_bytes(m, b, itemsize)]
               + [wy_trailing_smem_bytes(k, itemsize) for k in ks])


def _stack(x: Tensor, name: str, ndim: int = 3) -> Tensor:
    if x.ndim == ndim - 1:
        return x[None]
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected a matrix or a stack of them, "
                         f"got shape {tuple(x.shape)}")
    return x


def _check_kernel(name: str, *xs: Tensor) -> None:
    dev, dtype = xs[0].device, xs[0].dtype
    for x in xs:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: operands must share one device and "
                             f"dtype")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    if dev.type == "cuda":
        if dtype not in macro_ops.KERNEL_DTYPES:
            raise TypeError(f"{name} kernel takes float32 or float64, got "
                            f"{dtype}")
        for x in xs:
            if x.stride(-1) != 1:
                raise ValueError(f"{name} kernel needs unit column stride")


def mht_panel_(panel: Tensor) -> Tensor:
    """Factor ``(..., m, b)`` panels in place, column ``j`` pivoting at row
    ``j``: ``min(m, b)`` reflectors, every column updated; returns the
    ``(..., min(m, b))`` taus.  The kernel on a CUDA tensor (one launch for
    a stack), :func:`macro_ops.panel_body` on a CPU tensor."""
    p3 = _stack(panel, "mht_panel")
    _check_kernel("mht_panel", p3)
    bsz, m, b = p3.shape
    kf = min(m, b)
    if p3.device.type == "cpu":
        packed, taus = macro_ops.panel_body(p3, 0)
        p3.copy_(packed)
        taus = taus[:, :kf]
    else:
        taus = p3.new_zeros(bsz, b)
        if bsz and kf:
            _panel.launch(p3, taus)
        taus = taus[:, :kf]
    return taus if panel.ndim == 3 else taus[0]


def mht_panel(panel: Tensor, *, row0: int = 0) -> Tuple[Tensor, Tensor]:
    """Fused MHT factorization of ``(..., m, b)`` panels whose column ``j``
    pivots at row ``row0 + j``; rows above ``row0`` are kept.  Returns
    ``(packed, taus)`` with ``min(b, m - row0)`` taus: a wide panel has no
    pivots past its last row (the reference's kernel path returns b taus
    there).  Oracle: :func:`repro_torch.kernels.ref.mht_panel_ref`."""
    out = panel.clone(memory_format=torch.contiguous_format)
    m, b = out.shape[-2:]
    if row0 >= m:
        return out, out.new_zeros(out.shape[:-2] + (0,))
    return out, mht_panel_(out[..., row0:, :])


def wy_trailing_(v: Tensor, t: Tensor, c: Tensor, *,
                 tally: str = "WY_TRAILING") -> Tensor:
    """``C <- C - V (T^T (V^T C))`` in place on ``(..., m, n)`` C, with V
    ``(..., m, k)`` and T ``(..., k, k)``; returns ``c``.  The kernel on
    CUDA tensors (one launch for a stack, counted in
    ``macro_ops.LAUNCHES[tally]``), :func:`macro_ops.wy_body` on CPU
    tensors."""
    c3, v3 = _stack(c, "wy_trailing"), _stack(v, "wy_trailing")
    t3 = _stack(t, "wy_trailing").contiguous()
    _check_kernel("wy_trailing", v3, t3, c3)
    if v3.shape[:2] != c3.shape[:2] or t3.shape != v3.shape[:1] + 2 * v3.shape[2:]:
        raise ValueError(f"wy_trailing: V {tuple(v.shape)}, T {tuple(t.shape)} "
                         f"and C {tuple(c.shape)} do not match")
    if c3.device.type == "cpu":
        c3.copy_(macro_ops.wy_body(v3, t3, c3))
    elif c3.numel() and v3.shape[-1]:
        _trailing.launch(v3, t3, c3, tally)
    return c


def wy_trailing(v: Tensor, t: Tensor, c: Tensor) -> Tensor:
    """Fused WY trailing update ``C - V (T^T (V^T C))`` of ``(..., m, n)``
    C.  Oracle: :func:`repro_torch.kernels.ref.wy_trailing_ref`."""
    return wy_trailing_(v, t, c.clone(memory_format=torch.contiguous_format))

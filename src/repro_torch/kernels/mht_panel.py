"""The paper's fused MHT panel factorization (``DGEQR2HT``) on the card:
the launcher of ``csrc/mht_panel.cu`` and its shared-memory layout.

Counterpart of the reference's ``repro.kernels.mht_panel``.  The TPU
kernel holds the whole ``(m, b)`` panel in VMEM; an H100 CTA has 227 KB
of shared memory, so here the panel's rows are split over a group of
``groups`` CTAs of ``rows`` rows each, which hold their row blocks for
the whole column loop and meet at a group barrier twice per column
(:func:`layout`).  The plain version is
:func:`repro_torch.kernels.macro_ops.panel_body`; the wrappers that pick
between the two are in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.core.engine import DEFAULT_SMEM_BUDGET
from repro_torch.kernels import macro_ops

__all__ = ["layout", "smem_bytes", "launch", "ROWS_TARGET", "MAX_GROUP",
           "LAST_GRID"]

#: Rows a CTA takes when the panel needs no fewer: beyond about this many,
#: a CTA's share of a column's two reductions outlasts a group barrier.
ROWS_TARGET = 1024
#: Most CTAs in one panel's group: the H100 SXM's 132 SMs, one CTA each at
#: the largest row blocks, all of which a cooperative launch needs
#: resident at once.
MAX_GROUP = 132
#: Warps per CTA (``kThreads / 32`` in ``csrc/macro_ops.cuh``).
_WARPS = 8
#: The last launch's grid, for ``chip_smoke.py``: {"groups", "grid"}.
LAST_GRID = {"groups": 0, "grid": 0}


def _pitch(b: int) -> int:
    """Row pitch in shared memory: odd, so a column's elements fall in
    distinct banks."""
    return b | 1


def layout(m: int, b: int, itemsize: int = 4,
           budget: int = DEFAULT_SMEM_BUDGET) -> Tuple[int, int, int]:
    """``(groups, rows, smem_bytes)`` of an ``(m, b)`` panel: the CTAs its
    rows are split over, the rows each holds, and the dynamic shared
    memory per CTA (the size the launch passes), carved up as in
    ``csrc/mht_panel.cu``: ``rows`` panel rows at the padded pitch, the
    ``rows`` entries of v, the ``8 x b`` warp partials, w (b) and the
    reflector coefficients (8).  Raises ``ValueError`` naming the cap when
    the panel needs more than :data:`MAX_GROUP` CTAs or one row does not
    fit."""
    fixed = (_WARPS * b + b + 8) * itemsize
    per_row = (_pitch(b) + 1) * itemsize
    rmax = (budget - fixed) // per_row
    if rmax < 1:
        raise ValueError(
            f"mht_panel: a {b}-column panel row does not fit one CTA's "
            f"{budget} B of shared memory at {itemsize} B per element")
    groups = max(math.ceil(m / rmax), min(math.ceil(m / ROWS_TARGET), MAX_GROUP), 1)
    if groups > MAX_GROUP:
        raise ValueError(
            f"mht_panel: a ({m}, {b}) panel at {itemsize} B per element needs "
            f"{groups} CTAs of at most {rmax} rows, more than the "
            f"{MAX_GROUP} a cooperative launch can hold resident (cap: "
            f"{MAX_GROUP * rmax} rows at this width); factor it as TSQR "
            f"leaves, or pass use_kernel=False for the plain lowering")
    rows = math.ceil(m / groups)
    return groups, rows, rows * per_row + fixed


def smem_bytes(m: int, b: int, itemsize: int = 4) -> int:
    """Dynamic shared memory per CTA of the panel kernel on ``(m, b)``."""
    return layout(m, b, itemsize)[2]


def launch(panel: torch.Tensor, taus: torch.Tensor) -> None:
    """Factor a ``(B, m, b)`` CUDA view in place, column ``j`` pivoting at
    row ``j`` (unit column stride; any row and batch strides), writing
    ``min(m, b)`` taus into ``taus`` ``(B, b)`` (contiguous, zeroed).  One
    cooperative launch for the stack; raises on a launch error."""
    bsz, m, b = panel.shape
    kf = min(m, b)
    groups, rows, nbytes = layout(m, b, panel.element_size())
    from repro_torch.kernels import _build

    lib = _build.library()
    dev = panel.device
    part = torch.empty(bsz * groups * (b + 2) if groups > 1 else 1,
                       dtype=panel.dtype, device=dev)
    barriers = torch.zeros(bsz if groups > 1 else 1, dtype=torch.int32,
                           device=dev)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_mht_panel(
            panel.data_ptr(), panel.stride(0), panel.stride(1), m, b, kf,
            taus.data_ptr(), bsz, groups, rows, part.data_ptr(),
            barriers.data_ptr(), int(panel.dtype == torch.float64), nbytes,
            stream, ctypes.byref(grid))
    LAST_GRID.update(groups=groups, grid=grid.value)
    if rc != 0:
        raise RuntimeError(
            f"mht_panel launch failed ({grid.value} CTAs in groups of "
            f"{groups}): CUDA error {rc} ({_build.error_string(rc)})")
    macro_ops.LAUNCHES["MHT_PANEL"] += 1

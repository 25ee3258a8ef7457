"""The blocked QR trailing update ``C <- C - V (T^T (V^T C))`` on the card:
the launcher of ``csrc/wy_trailing.cu`` and its shared-memory size.

Counterpart of the reference's ``repro.kernels.wy_trailing``.  The TPU
kernel broadcasts all of V ``(m, k)`` to every column-tile program; here
a CTA per (matrix, 32-column tile of C) streams V's and C's rows twice —
``W = V^T C``, then ``X = T^T W``, then ``C -= V X`` — each warp its own
rows, so only the ``k x 32`` intermediates stay resident.  Where the
stack's column tiles are fewer than the CTAs the card holds at once, a
tile's rows are split over a group of CTAs that add their parts of W at a
group barrier (the split is chosen on the card, from the kernel's
occupancy).  The plain version is
:func:`repro_torch.kernels.macro_ops.wy_body`; the wrappers that pick
between the two are in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.engine import DEFAULT_SMEM_BUDGET
from repro_torch.kernels import macro_ops

__all__ = ["smem_bytes", "launch", "BN", "KB", "WARPS", "MAX_RESIDENT",
           "LAST_GRID"]

#: Columns of C per work item (``kBn`` in ``csrc/wy_trailing.cu``).
BN = 32
#: Reflectors per register block (``kKb``).
KB = 32
#: Warps per CTA (``kTrailWarps``).
WARPS = 8
#: Most CTAs an H100 holds at once at 256 threads each (8 per SM on its
#: 132 SMs): bounds the row split's scratch.
MAX_RESIDENT = 8 * 132
#: The last launch's grid, for ``chip_smoke.py``: {"splits", "grid"}.
LAST_GRID = {"splits": 0, "grid": 0}


def smem_bytes(k: int, itemsize: int = 4) -> int:
    """Dynamic shared memory per CTA for ``k`` reflectors (the size the
    launch passes): the warps' staging and partial sums (``WARPS x KB x
    BN``), W and X (``k x BN`` each) and T (``k x k``)."""
    return (WARPS * KB * BN + 2 * k * BN + k * k) * itemsize


def launch(v: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
           tally: str = "WY_TRAILING") -> None:
    """``c -= v (t^T (v^T c))`` in place on ``(B, m, n)`` CUDA views, with
    ``v`` ``(B, m, k)`` (both with unit column stride, any row and batch
    strides) and ``t`` ``(B, k, k)`` contiguous.  One launch for the
    stack; adds one to ``macro_ops.LAUNCHES[tally]``; raises on a launch
    error."""
    bsz, m, n = c.shape
    k = v.shape[-1]
    nbytes = smem_bytes(k, c.element_size())
    if nbytes > DEFAULT_SMEM_BUDGET:
        raise ValueError(f"wy_trailing: {k} reflectors need {nbytes} B of "
                         f"shared memory per CTA > {DEFAULT_SMEM_BUDGET} B; "
                         f"use a smaller block")
    from repro_torch.kernels import _build

    lib = _build.library()
    dev = c.device
    tiles = bsz * math.ceil(n / BN)
    # The split is chosen on the card; its scratch is sized for the most.
    part = torch.empty(2 * MAX_RESIDENT * k * BN if tiles < MAX_RESIDENT
                       else 1, dtype=c.dtype, device=dev)
    barriers = torch.zeros(min(tiles, MAX_RESIDENT), dtype=torch.int32,
                           device=dev)
    grid, splits = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_wy_trailing(
            v.data_ptr(), v.stride(0), v.stride(1), t.data_ptr(),
            c.data_ptr(), c.stride(0), c.stride(1), m, n, k, bsz,
            part.data_ptr(), barriers.data_ptr(),
            int(c.dtype == torch.float64), nbytes, stream, ctypes.byref(grid),
            ctypes.byref(splits))
    LAST_GRID.update(splits=splits.value, grid=grid.value)
    if rc != 0:
        raise RuntimeError(
            f"wy_trailing launch failed ({grid.value} CTAs, {splits.value} "
            f"per column tile): CUDA error {rc} ({_build.error_string(rc)})")
    macro_ops.LAUNCHES[tally] += 1

"""The blocked QR trailing update ``C <- C - V (T^T (V^T C))`` on the card:
the launcher of ``csrc/wy_trailing.cu`` and its shared-memory layouts.

Counterpart of the reference's ``repro.kernels.wy_trailing``.  The TPU
kernel broadcasts all of V ``(m, k)`` to every column-tile program; an
H100 CTA has 227 KB of shared memory, so here a 32-column tile's rows are
split over several CTAs.  :func:`layout` picks one of two layouts from
the shape:

  * **cluster**, wherever a thread block cluster of at most
    :data:`MAX_CLUSTER` CTAs holds a tile's rows: each CTA keeps its rows
    of V in shared memory and brings each tile's C slab in once (pass 2
    reads it again from L2), the CTAs push their parts of ``W = V^T C``
    through distributed shared memory to each column's owner, which sums
    them in rank order and pushes ``X = T^T W`` back to every CTA; a
    cluster walks a contiguous run of column tiles, the next tile's C
    streaming in during the sums and pass 2, sized for two CTAs an SM
    where it can.  No device scratch;
  * **streaming**, taller C: each warp streams its rows twice through a
    double-buffered ``cp.async`` ring, a tile's rows split over a group of
    CTAs of a cooperative launch where the tiles are fewer than the
    resident CTAs (the split is chosen on the card, from the kernel's
    occupancy); only this layout allocates its group scratch.

The plain version is :func:`repro_torch.kernels.macro_ops.wy_body`; the
wrappers that pick between the two are in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.engine import DEFAULT_SMEM_BUDGET
from repro_torch.kernels import macro_ops

__all__ = ["Layout", "layout", "smem_bytes", "launch", "BN", "KB", "WARPS", "PAD", "SM_SMEM", "CTA_RESERVE",
           "CLUSTER_ROWS", "MAX_CLUSTER", "MAX_RESIDENT", "LAST_GRID"]

#: Columns of C per work item (``kBn`` in ``csrc/wy_trailing.cu``).
BN = 32
#: Reflectors per register block of the streaming layout (``kKb``).
KB = 32
#: Warps per CTA (``kTrailWarps``).
WARPS = 8
#: Row pitch padding of the cluster layout's slabs (``kPad``).
PAD = 4
#: Shared memory of one H100 SM (228 KB) and what each resident CTA
#: costs besides its own (1 KB): two CTAs an SM each take at most
#: ``SM_SMEM // 2 - CTA_RESERVE``.
SM_SMEM = 233_472
CTA_RESERVE = 1024
#: Rows a cluster CTA takes when the tile needs no fewer (as
#: ``mht_panel.CLUSTER_ROWS``): a warp's share of pass 1 is then 64 rows.
CLUSTER_ROWS = 256
#: Most CTAs in one cluster: Hopper's non-portable cluster size.
MAX_CLUSTER = 16
#: Most CTAs an H100 holds at once at 256 threads each (8 per SM on its
#: 132 SMs): bounds the streaming layout's row-split scratch.
MAX_RESIDENT = 8 * 132
#: The last launch, for ``chip_smoke.py``: {"layout", "cluster",
#: "per_sm", "splits", "grid"}.
LAST_GRID = {"layout": "", "cluster": 0, "per_sm": 0, "splits": 0, "grid": 0}


class Layout(NamedTuple):
    """How the trailing kernel splits a ``(B, m, n)`` update with ``k``
    reflectors: ``path`` ``"cluster"`` or ``"streaming"``; for the
    cluster path the CTAs per cluster, the ``rows`` each holds (a
    multiple of 8) and the CTAs an SM holds at that size (``per_sm``, 2
    or 1); the dynamic shared memory per CTA (the size the launch
    passes)."""

    path: str
    cluster: int
    rows: int
    per_sm: int
    smem_bytes: int


def smem_bytes(k: int, itemsize: int = 4) -> int:
    """Dynamic shared memory per CTA of the streaming layout: the warps'
    rings and partial sums (``WARPS x KB x BN``), W and X (``k x BN``
    each) and T (``k x k``).  A cluster layout is sized to fit the budget,
    so this is the most any update with ``k`` reflectors takes: what the
    planner holds against the budget."""
    return (WARPS * KB * BN + 2 * k * BN + k * k) * itemsize


def _cluster_smem(rows: int, k: int, ctas: int, itemsize: int) -> int:
    """The cluster layout's carve-up (``csrc/wy_trailing.cu``): four
    mbarriers, V and the C slab at padded pitches, every CTA's part of W
    on this CTA's columns and X (each twice, by item parity), their sum,
    and T."""
    kp = -(-k // 4) * 4
    ncm = 4 * -(-(BN // 4) // ctas)
    tk = -(-(k * k) // 4) * 4
    return 32 + (rows * (kp + PAD) + rows * (BN + PAD) + 2 * ctas * kp * ncm
                 + kp * ncm + 2 * kp * BN + tk) * itemsize


def layout(m: int, n: int, k: int, batch: int = 1, itemsize: int = 4,
           budget: int = DEFAULT_SMEM_BUDGET) -> Layout:
    """The :class:`Layout` of an update of ``(batch, m, n)`` C by ``k``
    reflectors, from the shape alone.

    Cluster path when :data:`MAX_CLUSTER` CTAs hold the rows: about
    :data:`CLUSTER_ROWS` rows a CTA (more where the rows need it, a
    multiple of 8), sized for two CTAs an SM where that fits and one
    otherwise (the whole ``budget``): a cluster's items run one after
    another, each a chain of passes and barriers that the other CTA's work
    fills.  Streaming path beyond (``cluster`` 0: the row split is chosen
    on the card).  ``n`` and ``batch`` set the work items only; they do
    not change the layout."""
    del n, batch
    for per_sm in (2, 1):
        cap = min(budget, SM_SMEM // 2 - CTA_RESERVE) if per_sm == 2 else budget
        for ctas in range(min(MAX_CLUSTER, max(1, math.ceil(m / CLUSTER_ROWS))),
                          MAX_CLUSTER + 1):
            rows = -(-math.ceil(m / ctas) // 8) * 8
            need = _cluster_smem(rows, k, ctas, itemsize)
            if need <= cap:
                return Layout("cluster", ctas, rows, per_sm, need)
    return Layout("streaming", 0, 0, 0, smem_bytes(k, itemsize))


def launch(v: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
           tally: str = "WY_TRAILING") -> None:
    """``c -= v (t^T (v^T c))`` in place on ``(B, m, n)`` CUDA views, with
    ``v`` ``(B, m, k)`` (both with unit column stride, any row and batch
    strides) and ``t`` ``(B, k, k)`` contiguous.  One launch for the
    stack, on the layout :func:`layout` picks; adds one to
    ``macro_ops.LAUNCHES[tally]``; raises on a launch error, a refused
    cluster launch included."""
    bsz, m, n = c.shape
    k = v.shape[-1]
    lay = layout(m, n, k, bsz, c.element_size())
    if lay.smem_bytes > DEFAULT_SMEM_BUDGET:
        raise ValueError(f"wy_trailing: {k} reflectors need "
                         f"{lay.smem_bytes} B of shared memory per CTA > "
                         f"{DEFAULT_SMEM_BUDGET} B; use a smaller block")
    from repro_torch.kernels import _build

    lib = _build.library()
    dev = c.device
    is_double = int(c.dtype == torch.float64)
    grid, splits = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lay.path == "cluster":
            rc = lib.repro_wy_trailing_cluster(
                v.data_ptr(), v.stride(0), v.stride(1), t.data_ptr(),
                c.data_ptr(), c.stride(0), c.stride(1), m, n, k, bsz,
                lay.cluster, lay.rows, is_double, lay.smem_bytes, stream,
                ctypes.byref(grid))
            splits.value = lay.cluster
        else:
            tiles = bsz * math.ceil(n / BN)
            # The split is chosen on the card; its scratch is sized for
            # the most.
            part = torch.empty(2 * MAX_RESIDENT * k * BN
                               if tiles < MAX_RESIDENT else 1,
                               dtype=c.dtype, device=dev)
            barriers = torch.zeros(min(tiles, MAX_RESIDENT),
                                   dtype=torch.int32, device=dev)
            rc = lib.repro_wy_trailing(
                v.data_ptr(), v.stride(0), v.stride(1), t.data_ptr(),
                c.data_ptr(), c.stride(0), c.stride(1), m, n, k, bsz,
                part.data_ptr(), barriers.data_ptr(), is_double,
                lay.smem_bytes, stream, ctypes.byref(grid),
                ctypes.byref(splits))
    LAST_GRID.update(layout=lay.path, cluster=lay.cluster, per_sm=lay.per_sm,
                     splits=splits.value, grid=grid.value)
    if rc != 0:
        raise RuntimeError(
            f"wy_trailing launch failed ({grid.value} CTAs, {lay.path} "
            f"layout, {splits.value} per column tile): CUDA error {rc} "
            f"({_build.error_string(rc)})")
    macro_ops.LAUNCHES[tally] += 1

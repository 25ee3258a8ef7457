"""The paper's fused MHT panel factorization (``DGEQR2HT``) on the card:
the launcher of ``csrc/mht_panel.cu`` and its shared-memory layout.

Counterpart of the reference's ``repro.kernels.mht_panel``.  The TPU
kernel holds the whole ``(m, b)`` panel in VMEM; an H100 CTA has 227 KB
of shared memory, so here a panel's rows are split over several CTAs
that hold their row blocks for the whole column loop.  :func:`layout`
picks the path from the shape: a panel that one thread block cluster can
hold (up to :data:`MAX_CLUSTER` CTAs) is one cluster whose CTAs exchange
their partials through distributed shared memory once per column; a
taller one keeps a group of CTAs of a cooperative launch that meet at two
global group barriers per column.  The plain version is
:func:`repro_torch.kernels.macro_ops.panel_body`; the wrappers that pick
between the two are in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.engine import DEFAULT_SMEM_BUDGET
from repro_torch.kernels import macro_ops

__all__ = ["Layout", "layout", "smem_bytes", "launch", "CLUSTER_ROWS",
           "MAX_CLUSTER", "ROWS_TARGET", "MAX_GROUP", "LAST_GRID"]

#: Rows a cluster CTA takes when the panel needs no fewer: a warp then
#: walks 32 rows per column, about as long as the cluster's exchange.
CLUSTER_ROWS = 256
#: Most CTAs in one cluster: Hopper's non-portable cluster size.
MAX_CLUSTER = 16
#: Rows a group CTA takes when the panel needs no fewer: beyond about this
#: many, a CTA's share of a column's two reductions outlasts a group barrier.
ROWS_TARGET = 1024
#: Most CTAs in one panel's group: the H100 SXM's 132 SMs, one CTA each at
#: the largest row blocks, all of which a cooperative launch needs
#: resident at once.
MAX_GROUP = 132
#: Warps per CTA (``kThreads / 32`` in ``csrc/macro_ops.cuh``).
_WARPS = 8
#: The last launch's grid, for ``chip_smoke.py``: {"path", "ctas", "grid"}.
LAST_GRID = {"path": "", "ctas": 0, "grid": 0}


class Layout(NamedTuple):
    """How the panel kernel splits an ``(m, b)`` panel: ``path``
    ``"cluster"`` or ``"group"``, the ``ctas`` per panel (the cluster
    size or the group), the ``rows`` each holds, and the dynamic shared
    memory per CTA (the size the launch passes)."""

    path: str
    ctas: int
    rows: int
    smem_bytes: int


def _pitch(b: int) -> int:
    """Row pitch in shared memory: odd, so a column's elements fall in
    distinct banks."""
    return b | 1


def layout(m: int, b: int, itemsize: int = 4,
           budget: int = DEFAULT_SMEM_BUDGET) -> Layout:
    """The :class:`Layout` of an ``(m, b)`` panel, from the shape alone.

    Cluster path, when ``MAX_CLUSTER`` CTAs can hold the rows: about
    :data:`CLUSTER_ROWS` rows a CTA, carved up as in
    ``csrc/mht_panel.cu``'s cluster kernel (the rows at the padded pitch,
    ``8 x b`` warp partials, 8 norm partials, two ``2b`` partial slots,
    and the sums, the pivot row and w, ``b`` each).  Group path beyond:
    row blocks of at most :data:`ROWS_TARGET` rows (the rows at the padded
    pitch plus their v, the ``8 x b`` warp partials, w and 8
    coefficients).  Raises ``ValueError`` naming the cap when the panel
    needs more than :data:`MAX_GROUP` CTAs or one row does not fit."""
    rmax = (budget - (15 * b + _WARPS) * itemsize) // (_pitch(b) * itemsize)
    if rmax >= 1 and math.ceil(m / rmax) <= MAX_CLUSTER:
        ctas = min(MAX_CLUSTER, max(math.ceil(m / CLUSTER_ROWS),
                                    math.ceil(m / rmax), 1))
        rows = math.ceil(m / ctas)
        return Layout("cluster", ctas, rows,
                      (rows * _pitch(b) + 15 * b + _WARPS) * itemsize)
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
    return Layout("group", groups, rows, rows * per_row + fixed)


def smem_bytes(m: int, b: int, itemsize: int = 4) -> int:
    """Dynamic shared memory per CTA of the panel kernel on ``(m, b)``."""
    return layout(m, b, itemsize).smem_bytes


def launch(panel: torch.Tensor, taus: torch.Tensor) -> None:
    """Factor a ``(B, m, b)`` CUDA view in place, column ``j`` pivoting at
    row ``j`` (unit column stride; any row and batch strides), writing
    ``min(m, b)`` taus into ``taus`` ``(B, b)`` (contiguous, zeroed).  One
    launch for the stack, on the path :func:`layout` picks; raises on a
    launch error, a refused cluster launch included."""
    bsz, m, b = panel.shape
    kf = min(m, b)
    lay = layout(m, b, panel.element_size())
    from repro_torch.kernels import _build

    lib = _build.library()
    dev = panel.device
    is_double = int(panel.dtype == torch.float64)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lay.path == "cluster":
            rc = lib.repro_mht_panel_cluster(
                panel.data_ptr(), panel.stride(0), panel.stride(1), m, b, kf,
                taus.data_ptr(), bsz, lay.ctas, lay.rows, is_double,
                lay.smem_bytes, stream, ctypes.byref(grid))
        else:
            groups = lay.ctas
            part = torch.empty(bsz * groups * (b + 2) if groups > 1 else 1,
                               dtype=panel.dtype, device=dev)
            barriers = torch.zeros(bsz if groups > 1 else 1,
                                   dtype=torch.int32, device=dev)
            rc = lib.repro_mht_panel(
                panel.data_ptr(), panel.stride(0), panel.stride(1), m, b, kf,
                taus.data_ptr(), bsz, groups, lay.rows, part.data_ptr(),
                barriers.data_ptr(), is_double, lay.smem_bytes, stream,
                ctypes.byref(grid))
    LAST_GRID.update(path=lay.path, ctas=lay.ctas, grid=grid.value)
    if rc != 0:
        raise RuntimeError(
            f"mht_panel launch failed ({grid.value} CTAs, {lay.path} path, "
            f"{lay.ctas} per panel): CUDA error {rc} "
            f"({_build.error_string(rc)})")
    macro_ops.LAUNCHES["MHT_PANEL"] += 1

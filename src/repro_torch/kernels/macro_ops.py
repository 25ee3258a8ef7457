"""The four tile-DAG macro ops of tiled QR, the two updates that form Q
from the factored tiles, and the megakernel that runs a whole schedule of
them: plain bodies and Hopper kernels.

Counterpart of the reference's ``repro.kernels.macro_ops`` and of the
megakernels of its ``repro.core.engine``.  Three layers:

  * **value-level bodies** — :func:`reflector_coeffs`, :func:`panel_body`,
    :func:`wy_body`, :func:`stacked_larft`, :func:`tsqrt_factor` and the
    four macro ops :func:`geqrt_body` / :func:`larfb_body` /
    :func:`tsqrt_body` / :func:`ssrfb_body`, and Q formation's
    :func:`qlarfb_body` / :func:`qssrfb_body` (LARFB's and SSRFB's
    updates with T for T^T, the steps of ``tilegraph._form_q_tiled``).
    Each takes tiles with a leading task-batch dimension ``(B, nb, nb)``
    and is the plain PyTorch version of one kernel.  They keep the reference's LAPACK reflector
    convention exactly (``tau = 0`` and ``beta = x0`` when the tail is
    exactly zero), so packed tiles, T factors and taus compare element by
    element with the JAX package.
  * **workspace wrappers** — :func:`geqrt`, :func:`larfb`, :func:`tsqrt`,
    :func:`ssrfb`, and :func:`qlarfb`, :func:`qssrfb` on a Q workspace E:
    one launch runs a batch of same-kind tasks against the
    ``(p, q, nb, nb)`` tile workspace **in place**, reading each task's
    ``(k, i, j)`` from an ``(n, 3)`` int32 index tensor on the workspace's
    device — or against every slice of a ``(B, p, q, nb, nb)`` stack (with
    ``(B, ...)`` state fields and E), each slice running the same tasks.
    On a CUDA tensor a wrapper launches its hand-written kernel
    (``csrc/macro_ops.cu``, built on first use by :mod:`._build`) and adds
    one to :data:`LAUNCHES`; on a CPU tensor it runs the ``*_plain``
    gather -> body -> scatter version instead.  There is no fallback from
    a CUDA tensor: a failed build or launch raises;
  * **megakernel wrappers** — :func:`megakernel` and
    :func:`megakernel_batched`: one cooperative launch walks the engine's
    whole task table (``engine.megakernel_task_table``) over a factor
    state, or over a stacked ``(B, ...)`` state, in place; :func:`megakernel_q`
    and :func:`megakernel_q_batched` walk the Q table
    (``engine.q_megakernel_task_table``) over E the same way; each CTA takes
    the contiguous runs ``engine.megakernel_runs`` gives it, sized here
    from the occupancy query (:func:`megakernel_resident`).  Their plain
    versions :func:`megakernel_plain` / :func:`megakernel_batched_plain`
    walk the table row by row, one task at a time, the reference's
    sequential semantics.

All bodies accumulate in ``promote_types(dtype, float32)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Tuple

import torch

# ``core.blocked`` (larft, unpack_v_panel) is imported where it is used:
# it registers methods with the planner, whose import reaches this module.

__all__ = [
    "MacroOp",
    "MACRO_OPS",
    "LAUNCHES",
    "KERNEL_DTYPES",
    "acc_dtype",
    "reflector_coeffs",
    "panel_body",
    "wy_body",
    "stacked_larft",
    "geqrt_body",
    "larfb_body",
    "tsqrt_factor",
    "tsqrt_body",
    "ssrfb_body",
    "qlarfb_body",
    "qssrfb_body",
    "geqrt",
    "larfb",
    "tsqrt",
    "ssrfb",
    "geqrt_plain",
    "larfb_plain",
    "tsqrt_plain",
    "ssrfb_plain",
    "qlarfb",
    "qssrfb",
    "qlarfb_plain",
    "qssrfb_plain",
    "Q_OPS",
    "run_q_batch",
    "megakernel",
    "megakernel_batched",
    "megakernel_plain",
    "megakernel_batched_plain",
    "megakernel_q",
    "megakernel_q_batched",
    "megakernel_q_plain",
    "megakernel_q_batched_plain",
    "operand_pitch",
    "walk_stages",
    "reset_launch_counts",
    "run_batch",
    "smem_bytes",
    "engine_smem_bytes",
    "engine_vmem_bytes",
    "megakernel_smem_bytes",
    "megakernel_launch_smem_bytes",
    "megakernel_scratch_elems",
    "megakernel_stages",
    "megakernel_grid",
    "megakernel_resident",
    "MEGAKERNEL_OCCUPANCY",
    "MEGAKERNEL_SMEM_TILES",
]

Tensor = torch.Tensor

#: Element types the kernels are built for (accumulation = the type itself).
KERNEL_DTYPES = (torch.float32, torch.float64)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: never below fp32, fp64 when the I/O is fp64."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# the shared Householder reflector core
# ---------------------------------------------------------------------------

def reflector_coeffs(x0: Tensor, tail2: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """LAPACK-convention reflector coefficients from the pivot value and
    the squared tail norm: ``(beta, tau, denom)`` with ``v = x / denom``
    below the pivot, and ``tau = 0``, ``beta = x0`` when the tail is
    exactly zero (the test is exact: zero padding depends on it)."""
    one = torch.ones_like(x0)
    norm = torch.sqrt(x0 * x0 + tail2)
    beta = torch.where(x0 >= 0.0, -norm, norm)
    degen = tail2 == 0.0
    denom = torch.where(degen, one, x0 - beta)
    tau = torch.where(degen, torch.zeros_like(x0),
                      (beta - x0) / torch.where(beta == 0.0, one, beta))
    beta_val = torch.where(degen, x0, beta)
    return beta_val, tau, denom


def panel_body(panel: Tensor, row0: int) -> Tuple[Tensor, Tensor]:
    """MHT factorization of a batch of ``(m, b)`` panels whose pivot rows
    start at ``row0``: one dot-reduce and one rank-1 update per column.
    Returns ``(packed, taus)`` in the LAPACK packed layout."""
    m, b = panel.shape[-2:]
    acc = acc_dtype(panel.dtype)
    a = panel.to(acc).clone()
    taus = torch.zeros(panel.shape[:-2] + (b,), dtype=acc, device=panel.device)
    for lj in range(b):
        piv = row0 + lj
        if piv >= m:  # no pivot row: tau = 0, column untouched
            continue
        x = a[..., :, lj]
        tail = x[..., piv + 1:]
        beta, tau, denom = reflector_coeffs(x[..., piv],
                                            (tail * tail).sum(-1))
        v = torch.zeros_like(x)
        v[..., piv] = 1.0
        v[..., piv + 1:] = tail / denom[..., None]
        if lj + 1 < b:
            w = tau[..., None] * (v[..., None, :] @ a[..., :, lj + 1:])[..., 0, :]
            a[..., :, lj + 1:] -= v[..., :, None] * w[..., None, :]
        a[..., piv, lj] = beta
        a[..., piv + 1:, lj] = v[..., piv + 1:]
        taus[..., lj] = tau
    return a.to(panel.dtype), taus.to(panel.dtype)


def wy_body(v: Tensor, t: Tensor, c: Tensor) -> Tensor:
    """WY update ``C - V (T^T (V^T C))``, batched."""
    acc = acc_dtype(c.dtype)
    v_a, c_a = v.to(acc), c.to(acc)
    w = v_a.transpose(-1, -2) @ c_a
    w = t.to(acc).transpose(-1, -2) @ w
    return (c_a - v_a @ w).to(c.dtype)


def stacked_larft(v2: Tensor, taus: Tensor) -> Tensor:
    """Block reflectors T of the stacked TSQRT reflectors ``V = [I; V2]``."""
    from repro_torch.core.blocked import larft

    nb = v2.shape[-1]
    eye = torch.eye(nb, dtype=v2.dtype, device=v2.device).expand(v2.shape)
    return larft(torch.cat([eye, v2], dim=-2), taus)


# ---------------------------------------------------------------------------
# the four tile-DAG macro ops (value level: the kernels' plain versions)
# ---------------------------------------------------------------------------

def geqrt_body(tile: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """GEQRT: QR of diagonal tiles -> ``(packed, T, taus)``, with V1
    strictly below and R on and above the diagonal."""
    from repro_torch.core.blocked import larft, unpack_v_panel

    packed, taus = panel_body(tile, 0)
    return packed, larft(unpack_v_panel(packed, 0), taus), taus


def larfb_body(diag_packed: Tensor, t: Tensor, c: Tensor) -> Tensor:
    """LARFB: apply Q_k^T to trailing tiles, V1 unpacked from the packed
    diagonal tiles."""
    from repro_torch.core.blocked import unpack_v_panel

    return wy_body(unpack_v_panel(diag_packed, 0), t, c)


def tsqrt_factor(diag: Tensor, sub: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """QR of the stacked pairs ``[triu(diag); sub]`` with ``[e_j; v2_j]``
    reflectors.  Only the upper triangle of ``diag`` is factored; what
    lies strictly below it (the GEQRT V1) passes through unchanged into
    the merged tile.  Returns ``(merged, V2, taus)``."""
    nb = diag.shape[-1]
    acc = acc_dtype(diag.dtype)
    upper = torch.ones(nb, nb, dtype=torch.bool, device=diag.device).triu()
    zero = torch.zeros((), dtype=acc, device=diag.device)
    r = torch.where(upper, diag.to(acc), zero)
    a = sub.to(acc).clone()
    vacc = torch.zeros_like(a)
    taus = torch.zeros(diag.shape[:-1], dtype=acc, device=diag.device)
    for j in range(nb):
        x2 = a[..., :, j]
        beta, tau, denom = reflector_coeffs(r[..., j, j], (x2 * x2).sum(-1))
        v2 = x2 / denom[..., None]
        if j + 1 < nb:
            w = tau[..., None] * (
                r[..., j, j + 1:]
                + (v2[..., None, :] @ a[..., :, j + 1:])[..., 0, :])
            r[..., j, j + 1:] -= w
            a[..., :, j + 1:] -= v2[..., :, None] * w[..., None, :]
        r[..., j, j] = beta
        vacc[..., :, j] = v2
        taus[..., j] = tau
    merged = torch.where(upper, r, diag.to(acc))
    return merged.to(diag.dtype), vacc.to(diag.dtype), taus.to(diag.dtype)


def tsqrt_body(diag: Tensor, sub: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """TSQRT: factor + stacked T -> ``(merged, V2, T, taus)``."""
    merged, v2, taus = tsqrt_factor(diag, sub)
    return merged, v2, stacked_larft(v2, taus), taus


def ssrfb_body(v2: Tensor, t: Tensor, ck: Tensor, ci: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """SSRFB: with ``V = [I; V2]``, ``W = T^T (C_k + V2^T C_i)``,
    ``C_k -= W``, ``C_i -= V2 W``."""
    acc = acc_dtype(ck.dtype)
    v_a, ck_a, ci_a = v2.to(acc), ck.to(acc), ci.to(acc)
    w = ck_a + v_a.transpose(-1, -2) @ ci_a
    w = t.to(acc).transpose(-1, -2) @ w
    return (ck_a - w).to(ck.dtype), (ci_a - v_a @ w).to(ci.dtype)


def qlarfb_body(diag_packed: Tensor, t: Tensor, c: Tensor) -> Tensor:
    """QLARFB, the diagonal step of forming Q: ``C - V1 (T (V1^T C))``,
    LARFB's update with T for T^T."""
    return larfb_body(diag_packed, t.mT, c)


def qssrfb_body(v2: Tensor, t: Tensor, ek: Tensor, ei: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """QSSRFB, a TSQRT-pair step of forming Q: ``W = T (E_k + V2^T E_i)``,
    ``E_k -= W``, ``E_i -= V2 W`` — SSRFB's update with T for T^T."""
    return ssrfb_body(v2, t.mT, ek, ei)


# ---------------------------------------------------------------------------
# workspace-level plain versions (gather -> body -> scatter)
# ---------------------------------------------------------------------------
#
# A batch's gathers all read the tiles as they were before the batch, and
# its scatters are disjoint (asserted when the engine builds its index
# arrays), which is what the kernels' parallel CTAs see too.  Leading
# dimensions of the workspace (a stack of factorizations) batch through.

def geqrt_plain(tiles: Tensor, d_t: Tensor, d_taus: Tensor, idx: Tensor
                ) -> None:
    kk = idx[:, 0].long()
    packed, t, taus = geqrt_body(tiles[..., kk, kk, :, :])
    tiles[..., kk, kk, :, :] = packed
    d_t[..., kk, :, :] = t
    d_taus[..., kk, :] = taus


def larfb_plain(tiles: Tensor, d_t: Tensor, idx: Tensor) -> None:
    kk, jj = idx[:, 0].long(), idx[:, 2].long()
    tiles[..., kk, jj, :, :] = larfb_body(
        tiles[..., kk, kk, :, :], d_t[..., kk, :, :], tiles[..., kk, jj, :, :])


def tsqrt_plain(tiles: Tensor, t_t: Tensor, t_taus: Tensor, idx: Tensor
                ) -> None:
    kk, ii = idx[:, 0].long(), idx[:, 1].long()
    merged, v2, t, taus = tsqrt_body(tiles[..., kk, kk, :, :],
                                     tiles[..., ii, kk, :, :])
    tiles[..., kk, kk, :, :] = merged
    tiles[..., ii, kk, :, :] = v2
    t_t[..., ii, kk, :, :] = t
    t_taus[..., ii, kk, :] = taus


def ssrfb_plain(tiles: Tensor, t_t: Tensor, idx: Tensor) -> None:
    kk, ii, jj = idx[:, 0].long(), idx[:, 1].long(), idx[:, 2].long()
    ck, ci = ssrfb_body(tiles[..., ii, kk, :, :], t_t[..., ii, kk, :, :],
                        tiles[..., kk, jj, :, :], tiles[..., ii, jj, :, :])
    tiles[..., kk, jj, :, :] = ck
    tiles[..., ii, jj, :, :] = ci


def qlarfb_plain(tiles: Tensor, d_t: Tensor, e: Tensor, idx: Tensor) -> None:
    kk, jj = idx[:, 0].long(), idx[:, 2].long()
    e[..., kk, jj, :, :] = qlarfb_body(
        tiles[..., kk, kk, :, :], d_t[..., kk, :, :], e[..., kk, jj, :, :])


def qssrfb_plain(tiles: Tensor, t_t: Tensor, e: Tensor, idx: Tensor) -> None:
    kk, ii, jj = idx[:, 0].long(), idx[:, 1].long(), idx[:, 2].long()
    ek, ei = qssrfb_body(tiles[..., ii, kk, :, :], t_t[..., ii, kk, :, :],
                         e[..., kk, jj, :, :], e[..., ii, jj, :, :])
    e[..., kk, jj, :, :] = ek
    e[..., ii, jj, :, :] = ei


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

#: Kernel launches per kernel since the last :func:`reset_launch_counts`,
#: for every kernel of the port: the macro ops, the Q updates and the
#: megakernels here (``MEGAKERNEL_Q`` / ``MEGAKERNEL_Q_BATCHED``: the
#: megakernels' launches over a Q table), the panel and trailing kernels of
#: :mod:`.ops` (``WY_TRAILING_Q`` counts the trailing kernel's launches
#: that form Q apart from the factorization's) and the single-tile entry
#: points of :mod:`.tile_ops`.
LAUNCHES: Dict[str, int] = {"GEQRT": 0, "LARFB": 0, "TSQRT": 0, "SSRFB": 0,
                            "QLARFB": 0, "QSSRFB": 0,
                            "MEGAKERNEL": 0, "MEGAKERNEL_BATCHED": 0,
                            "MEGAKERNEL_Q": 0, "MEGAKERNEL_Q_BATCHED": 0,
                            "MHT_PANEL": 0, "WY_TRAILING": 0,
                            "WY_TRAILING_Q": 0, "TSQRT_TILE": 0,
                            "SSRFB_TILE": 0}
#: CTAs of the last launch of each megakernel (the resident grid).
MEGAKERNEL_GRID: Dict[str, int] = {"MEGAKERNEL": 0, "MEGAKERNEL_BATCHED": 0,
                                   "MEGAKERNEL_Q": 0,
                                   "MEGAKERNEL_Q_BATCHED": 0}
#: CTAs of the last launch of the update walk for each kind (the resident
#: grid, at most one CTA per (slice, task)).
WALK_GRID: Dict[str, int] = {"LARFB": 0, "SSRFB": 0, "QLARFB": 0,
                             "QSSRFB": 0}


def reset_launch_counts() -> None:
    for kind in LAUNCHES:
        LAUNCHES[kind] = 0


def _check(kind: str, tiles: Tensor, aux: Tuple[Tensor, ...], idx: Tensor,
           e: Tensor = None) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers:
    a ``(p, q, nb, nb)`` workspace, or a ``(B, p, q, nb, nb)`` stack whose
    state fields and E lead with the same B."""
    if tiles.ndim not in (4, 5) or tiles.shape[-1] != tiles.shape[-2]:
        raise ValueError(f"{kind}: expected a (p, q, nb, nb) workspace or a "
                         f"(B, p, q, nb, nb) stack, got {tuple(tiles.shape)}")
    *lead, p, q, nb, _ = tiles.shape
    lead = tuple(lead)
    r = min(p, q)
    want = {"d_t": lead + (r, nb, nb), "d_taus": lead + (r, nb),
            "t_t": lead + (p, r, nb, nb), "t_taus": lead + (p, r, nb)}
    state = (Q_OPS[kind][2],) if kind in Q_OPS else MACRO_OPS[kind].state
    for name, x in zip(state, aux):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{kind}: {name} must be {want[name]}, "
                             f"got {tuple(x.shape)}")
    if e is not None and (e.ndim != tiles.ndim
                          or tuple(e.shape[:-3]) != lead + (p,)
                          or tuple(e.shape[-2:]) != (nb, nb)):
        raise ValueError(f"{kind}: E must be a {lead + (p,)} + (qe, {nb}, "
                         f"{nb}) Q workspace, got {tuple(e.shape)}")
    for x in (tiles,) + aux + (() if e is None else (e,)):
        if x.device != tiles.device or x.dtype != tiles.dtype:
            raise ValueError(f"{kind}: state tensors must share the "
                             f"workspace's device and dtype")
    if idx.ndim != 2 or idx.shape[1] != 3 or idx.dtype != torch.int32 \
            or idx.device != tiles.device:
        raise ValueError(f"{kind}: idx must be an (n, 3) int32 tensor on "
                         f"{tiles.device}, got {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device}")


def _launch(kind: str, tiles: Tensor, aux: Tuple[Tensor, ...],
            idx: Tensor, tally: str = None, e: Tensor = None) -> None:
    """Launch ``kind``'s kernel on a batch of tasks — on every slice of a
    ``(B, p, q, nb, nb)`` stack at once — and add one to
    ``LAUNCHES[tally]`` (default: the kind's own count).  GEQRT and TSQRT
    launch a CTA per (slice, task); the updates launch the walk kernel's
    persistent grid over the slices' tasks."""
    if tiles.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{kind} kernel takes float32 or float64, "
                        f"got {tiles.dtype}")
    for x in (tiles, idx) + aux + (() if e is None else (e,)):
        if not x.is_contiguous():
            raise ValueError(f"{kind} kernel needs contiguous tensors")
    batch = tiles.shape[0] if tiles.ndim == 5 else 1
    if idx.shape[0] == 0 or batch == 0:
        return
    from repro_torch.kernels import _build

    lib = _build.library()
    p, q, nb = tiles.shape[-4], tiles.shape[-3], tiles.shape[-1]
    itemsize = tiles.element_size()
    is_double = int(tiles.dtype == torch.float64)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        if kind in WALK_KINDS:
            grid = ctypes.c_int(0)
            rc = lib.repro_walk(
                WALK_KINDS[kind], tiles.data_ptr(), aux[0].data_ptr(),
                None if e is None else e.data_ptr(), idx.data_ptr(),
                int(idx.shape[0]), batch, p, q,
                0 if e is None else e.shape[-3], nb,
                walk_stages(nb, itemsize), is_double,
                walk_smem_bytes(nb, itemsize), stream, ctypes.byref(grid))
            WALK_GRID[kind] = grid.value
        else:
            ptrs = [x.data_ptr() for x in aux]
            rc = getattr(lib, f"repro_{kind.lower()}")(
                tiles.data_ptr(), ptrs[0], ptrs[1], idx.data_ptr(),
                int(idx.shape[0]), batch, p, q, nb, is_double,
                smem_bytes(kind, nb, itemsize), stream)
    if rc != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES[tally or kind] += 1


def _run(kind: str, plain: Callable, tiles: Tensor, aux: Tuple[Tensor, ...],
         idx: Tensor, e: Tensor = None) -> None:
    _check(kind, tiles, aux, idx, e)
    extra = () if e is None else (e,)
    if tiles.device.type == "cpu":
        plain(tiles, *aux, *extra, idx)
    elif tiles.device.type == "cuda":
        _launch(kind, tiles, aux, idx, e=e)
    else:
        raise ValueError(f"{kind}: no kernel for device {tiles.device}")


def geqrt(tiles: Tensor, d_t: Tensor, d_taus: Tensor, idx: Tensor) -> None:
    """GEQRT of tiles ``(k, k)`` in place; T -> ``d_t[k]``, taus -> ``d_taus[k]``."""
    _run("GEQRT", geqrt_plain, tiles, (d_t, d_taus), idx)


def larfb(tiles: Tensor, d_t: Tensor, idx: Tensor) -> None:
    """LARFB of tiles ``(k, j)`` in place, V1 from ``(k, k)``, T from ``d_t[k]``."""
    _run("LARFB", larfb_plain, tiles, (d_t,), idx)


def tsqrt(tiles: Tensor, t_t: Tensor, t_taus: Tensor, idx: Tensor) -> None:
    """TSQRT of pairs ``(k, k)`` / ``(i, k)`` in place; T -> ``t_t[i, k]``."""
    _run("TSQRT", tsqrt_plain, tiles, (t_t, t_taus), idx)


def ssrfb(tiles: Tensor, t_t: Tensor, idx: Tensor) -> None:
    """SSRFB of pairs ``(k, j)`` / ``(i, j)`` in place, V2 from ``(i, k)``."""
    _run("SSRFB", ssrfb_plain, tiles, (t_t,), idx)


def qlarfb(tiles: Tensor, d_t: Tensor, e: Tensor, idx: Tensor) -> None:
    """QLARFB of E tiles ``(k, j)`` in place, V1 from the factored tile
    ``(k, k)``, T from ``d_t[k]``; the factored state is read only."""
    _run("QLARFB", qlarfb_plain, tiles, (d_t,), idx, e)


def qssrfb(tiles: Tensor, t_t: Tensor, e: Tensor, idx: Tensor) -> None:
    """QSSRFB of E tile pairs ``(k, j)`` / ``(i, j)`` in place, V2 from the
    factored tile ``(i, k)``, T from ``t_t[i, k]``."""
    _run("QSSRFB", qssrfb_plain, tiles, (t_t,), idx, e)


# ---------------------------------------------------------------------------
# the megakernel: one launch walks the whole task table
# ---------------------------------------------------------------------------
#
# The table is the engine's ``megakernel_task_table`` (or
# ``q_megakernel_task_table``): int32 rows of TABLE_COLS columns,
# ``nslots`` rows per level, (kind, k, i, j) first, kind an index into
# MACRO_OPS's order, NOOP past it, and Q formation's kinds Q_KIND_ID.

TABLE_COLS = 16
#: The table id of an empty slot: past the four macro ops' ids (0..3, in
#: MACRO_OPS's order, the reference's).
NOOP = 4
#: Table ids of Q formation's kinds, past NOOP.
Q_KIND_ID = {"QLARFB": 5, "QSSRFB": 6}
#: The update kinds the walk kernel (``repro_walk``) runs, by their table
#: ids (LARFB and SSRFB at their MACRO_OPS positions).
WALK_KINDS = {"LARFB": 1, "SSRFB": 3, **Q_KIND_ID}


def _task_plain(st, kind: str, k: int, i: int, j: int, e: Tensor = None
                ) -> None:
    """One task on every slice of a stacked state (fields with a leading
    slice dimension) and Q workspace ``e``, in place, through the
    value-level bodies."""
    tl = st.tiles
    if kind == "QLARFB":
        e[:, k, j] = qlarfb_body(tl[:, k, k], st.d_t[:, k], e[:, k, j])
    elif kind == "QSSRFB":
        e[:, k, j], e[:, i, j] = qssrfb_body(tl[:, i, k], st.t_t[:, i, k],
                                             e[:, k, j], e[:, i, j])
    elif kind == "GEQRT":
        tl[:, k, k], st.d_t[:, k], st.d_taus[:, k] = geqrt_body(tl[:, k, k])
    elif kind == "LARFB":
        tl[:, k, j] = larfb_body(tl[:, k, k], st.d_t[:, k], tl[:, k, j])
    elif kind == "TSQRT":
        (tl[:, k, k], tl[:, i, k], st.t_t[:, i, k],
         st.t_taus[:, i, k]) = tsqrt_body(tl[:, k, k], tl[:, i, k])
    else:
        tl[:, k, j], tl[:, i, j] = ssrfb_body(tl[:, i, k], st.t_t[:, i, k],
                                              tl[:, k, j], tl[:, i, j])


def megakernel_batched_plain(state, table: Tensor, nlevels: int,
                             nslots: int) -> None:
    """Plain version of :func:`megakernel_batched`: the table's rows in
    order, one task at a time, each applied to every slice of the stacked
    state (every slice replays the same table)."""
    del nlevels, nslots  # the rows carry the whole schedule
    kinds = tuple(MACRO_OPS)
    for kind, k, i, j in table[:, :4].tolist():
        if kind < len(kinds):
            _task_plain(state, kinds[kind], k, i, j)


_Q_KINDS = {v: k for k, v in Q_KIND_ID.items()}


def megakernel_q_batched_plain(state, e: Tensor, table: Tensor, nlevels: int,
                               nslots: int) -> None:
    """Plain version of :func:`megakernel_q_batched`: the Q table's rows in
    order, one task at a time, each on every slice of the stacked state
    and Q workspace."""
    del nlevels, nslots
    for kind, k, i, j in table[:, :4].tolist():
        if kind in _Q_KINDS:
            _task_plain(state, _Q_KINDS[kind], k, i, j, e)


def megakernel_q_plain(state, e: Tensor, table: Tensor, nlevels: int,
                       nslots: int) -> None:
    """Plain version of :func:`megakernel_q`: the Q table's rows in order,
    one task at a time."""
    megakernel_q_batched_plain(type(state)(*(x[None] for x in state)),
                               e[None], table, nlevels, nslots)


def megakernel_plain(state, table: Tensor, nlevels: int, nslots: int
                     ) -> None:
    """Plain version of :func:`megakernel`: the table's rows in order, one
    task at a time — the reference's sequential walk."""
    megakernel_batched_plain(type(state)(*(x[None] for x in state)), table,
                             nlevels, nslots)


def _check_megakernel(name: str, state, table: Tensor, nlevels: int,
                      nslots: int, batched: bool, e: Tensor = None) -> None:
    tiles = state.tiles
    lead = 1 if batched else 0
    if tiles.ndim != 4 + lead or tiles.shape[-1] != tiles.shape[-2]:
        raise ValueError(f"{name}: expected a {'(B, ' if batched else '('}"
                         f"p, q, nb, nb) workspace, got {tuple(tiles.shape)}")
    p, q, nb = tiles.shape[lead], tiles.shape[lead + 1], tiles.shape[-1]
    r = min(p, q)
    b = tuple(tiles.shape[:lead])
    want = (b + (r, nb, nb), b + (r, nb), b + (p, r, nb, nb), b + (p, r, nb))
    for name_, x, shape in zip(state._fields[1:], state[1:], want):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {name_} must be {shape}, "
                             f"got {tuple(x.shape)}")
    if e is not None and (e.ndim != 4 + lead or e.shape[:lead + 1] != b + (p,)
                          or tuple(e.shape[-2:]) != (nb, nb)):
        raise ValueError(f"{name}: E must be a {b + (p,)} + (qe, {nb}, "
                         f"{nb}) Q workspace, got {tuple(e.shape)}")
    for x in tuple(state) + (() if e is None else (e,)):
        if x.device != tiles.device or x.dtype != tiles.dtype:
            raise ValueError(f"{name}: state tensors must share the "
                             f"workspace's device and dtype")
    if tuple(table.shape) != (nlevels * nslots, TABLE_COLS) \
            or table.dtype != torch.int32 or table.device != tiles.device:
        raise ValueError(f"{name}: table must be an ({nlevels * nslots}, "
                         f"{TABLE_COLS}) int32 tensor on {tiles.device}, got "
                         f"{tuple(table.shape)} {table.dtype} on {table.device}")


#: Resident CTAs per SM and in all of each megakernel's last launch.
MEGAKERNEL_OCCUPANCY: Dict[str, Dict[str, int]] = {
    name: {"per_sm": 0, "resident": 0} for name in MEGAKERNEL_GRID}
_RESIDENT: Dict[Tuple, Tuple[int, int]] = {}


def megakernel_resident(name: str, nb: int, dtype: torch.dtype,
                        device: torch.device) -> Tuple[int, int]:
    """``(CTAs per SM, resident CTAs)`` of the ``name`` megakernel at its
    launch's shared memory for tile ``nb`` on ``device``: the occupancy
    query, once per key.  The grid of a launch is at most the resident
    count (a cooperative launch needs every CTA resident).  The Q names
    launch the megakernels' instantiations for a Q table."""
    itemsize = torch.finfo(dtype).bits // 8
    smem = megakernel_launch_smem_bytes(nb, itemsize)
    key = (name, smem, itemsize, str(device))
    if key not in _RESIDENT:
        from repro_torch.kernels import _build

        lib = _build.library()
        per_sm, resident = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.repro_megakernel_resident(
                int(name.endswith("BATCHED")), int("_Q" in name),
                int(itemsize == 8), smem, ctypes.byref(per_sm),
                ctypes.byref(resident))
        if rc != 0:
            raise RuntimeError(f"{name} occupancy query failed: CUDA error "
                               f"{rc} ({_build.error_string(rc)})")
        _RESIDENT[key] = (per_sm.value, resident.value)
    return _RESIDENT[key]


def megakernel_grid(name: str, nb: int, dtype: torch.dtype,
                    device: torch.device, batch: int, nslots: int) -> int:
    """CTAs of a ``name`` megakernel launch over ``batch`` slices of a
    table of ``nslots`` slots: every slot's task a CTA, capped at the
    resident count (:func:`megakernel_resident`, recorded in
    :data:`MEGAKERNEL_OCCUPANCY`).  Raises when not one CTA fits."""
    per_sm, resident = megakernel_resident(name, nb, dtype, device)
    MEGAKERNEL_OCCUPANCY[name] = {"per_sm": per_sm, "resident": resident}
    grid_ctas = min(batch * nslots, resident)
    if grid_ctas < 1:
        itemsize = torch.finfo(dtype).bits // 8
        raise RuntimeError(f"{name}: not one CTA of "
                           f"{megakernel_launch_smem_bytes(nb, itemsize)} B "
                           f"of shared memory fits the device")
    return grid_ctas


def _launch_megakernel(name: str, state, table: Tensor, nlevels: int,
                       nslots: int, batch: int, e: Tensor = None) -> None:
    from repro_torch.core import engine

    tiles = state.tiles
    if tiles.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes float32 or float64, "
                        f"got {tiles.dtype}")
    for x in tuple(state) + (table,) + (() if e is None else (e,)):
        if not x.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors")
    from repro_torch.kernels import _build

    lib = _build.library()
    p, q, nb = tiles.shape[-4], tiles.shape[-3], tiles.shape[-1]
    itemsize = tiles.element_size()
    grid_ctas = megakernel_grid(name, nb, tiles.dtype, tiles.device, batch,
                                nslots)
    qe = None if e is None else e.shape[-3]
    runs = engine.megakernel_runs_device(p, q, batch, grid_ctas, tiles.device,
                                         qe=qe)
    barrier = torch.zeros(1, dtype=torch.int32, device=tiles.device)
    grid = ctypes.c_int(0)
    entry = "repro_megakernel_batched" if name.endswith("BATCHED") \
        else "repro_megakernel"
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        rc = getattr(lib, entry)(
            *(x.data_ptr() for x in state), None if e is None else e.data_ptr(),
            table.data_ptr(), runs.data_ptr(),
            nlevels, nslots, batch, p, q, qe or 0, nb,
            megakernel_stages(nb, itemsize), grid_ctas,
            int(tiles.dtype == torch.float64),
            megakernel_launch_smem_bytes(nb, itemsize),
            barrier.data_ptr(), stream, ctypes.byref(grid))
    MEGAKERNEL_GRID[name] = grid.value
    if rc != 0:
        raise RuntimeError(f"{name} cooperative launch failed ({grid_ctas} "
                           f"CTAs): CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES[name] += 1


def _run_megakernel(name: str, plain: Callable, state, table: Tensor,
                    nlevels: int, nslots: int, batched: bool,
                    e: Tensor = None) -> None:
    _check_megakernel(name, state, table, nlevels, nslots, batched, e)
    device = state.tiles.device
    if device.type == "cpu":
        plain(*((state,) if e is None else (state, e)), table, nlevels,
              nslots)
    elif device.type == "cuda":
        batch = state.tiles.shape[0] if batched else 1
        _launch_megakernel(name, state, table, nlevels, nslots, batch, e)
    else:
        raise ValueError(f"{name}: no kernel for device {device}")


def megakernel(state, table: Tensor, nlevels: int, nslots: int) -> None:
    """The whole schedule of ``table`` over a ``(p, q, nb, nb)`` factor
    state, in place: one cooperative launch on a CUDA state, the plain
    walk on a CPU state."""
    _run_megakernel("MEGAKERNEL", megakernel_plain, state, table, nlevels,
                    nslots, batched=False)


def megakernel_batched(state, table: Tensor, nlevels: int, nslots: int
                       ) -> None:
    """The schedule of ``table`` over every slice of a stacked
    ``(B, p, q, nb, nb)`` factor state, in place: one cooperative launch
    on a CUDA state, the plain walk on a CPU state."""
    _run_megakernel("MEGAKERNEL_BATCHED", megakernel_batched_plain, state,
                    table, nlevels, nslots, batched=True)


def megakernel_q(state, e: Tensor, table: Tensor, nlevels: int,
                 nslots: int) -> None:
    """Q formation's whole schedule (``table`` from
    ``engine.q_megakernel_task_table``) over a ``(p, qe, nb, nb)`` Q
    workspace ``e``, in place, the factored ``state`` read only: one
    cooperative launch of the megakernel on CUDA tensors, the plain walk
    on CPU tensors."""
    _run_megakernel("MEGAKERNEL_Q", megakernel_q_plain, state, table,
                    nlevels, nslots, batched=False, e=e)


def megakernel_q_batched(state, e: Tensor, table: Tensor, nlevels: int,
                         nslots: int) -> None:
    """:func:`megakernel_q` over every slice of a stacked state and
    ``(B, p, qe, nb, nb)`` Q workspace: one launch of the batched
    megakernel."""
    _run_megakernel("MEGAKERNEL_Q_BATCHED", megakernel_q_batched_plain,
                    state, table, nlevels, nslots, batched=True, e=e)


# ---------------------------------------------------------------------------
# registry + shared-memory accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MacroOp:
    """Capability card for one DAG macro op.

    body:        value-level batched body (the kernel's plain version)
    kernel:      the workspace wrapper (launches the CUDA kernel)
    plain:       the workspace-level plain version of ``kernel``
    state:       the factor-state fields both take after the workspace
    tile_reads:  workspace tiles read per task  (memory traffic model)
    tile_writes: workspace tiles written per task
    vmem_tiles:  the reference's modeled on-chip tile count per task; read
                 only by ``engine.schedule_stats``, which reports the
                 reference's numbers
    smem_elems:  ``(nb, itemsize) -> elements`` of dynamic shared memory
                 the kernel's launch takes (its layout is in
                 ``csrc/macro_ops.cu``); the launch passes exactly this
                 size, and the budget checks of the planner and the engine
                 read it too
    """

    name: str
    body: Callable
    kernel: Callable
    plain: Callable
    state: Tuple[str, ...]
    tile_reads: int
    tile_writes: int
    vmem_tiles: int
    smem_elems: Callable[[int, int], int]


#: The GEQRT/TSQRT column loops' exchange buffer (``kXchElems`` in
#: ``csrc/macro_ops.cu``): two parities of 8 warps' 32 partials and a
#: 32-wide pivot row, and 32 denominators.
XCH_ELEMS = 2 * (8 * 32 + 32) + 32


def operand_pitch(nb: int, itemsize: int = 4) -> int:
    """Row pitch of the update bodies' operand tiles in shared memory
    (``operand_pitch`` in ``csrc/macro_ops.cu``): nb + 4 for the fp64
    tiles the DMMA products take (nb a multiple of 8, up to 64), a pad
    that puts their fragment loads in distinct banks; else nb."""
    if itemsize == 8 and nb % 8 == 0 and nb <= 64:
        return nb + 4
    return nb


def _walk_elems(nb: int, itemsize: int, stages: int) -> int:
    # Four operand slots of `stages` buffers, then W and W2.
    slot = nb * operand_pitch(nb, itemsize)
    return 4 * stages * slot + 2 * slot


def walk_stages(nb: int, itemsize: int = 4) -> int:
    """Operand buffers per slot of the update walk's CTAs: 2 (the next
    task's tiles stream in while one computes) where they fit the
    shared-memory budget, else 1."""
    from repro_torch.core.engine import DEFAULT_SMEM_BUDGET

    return 2 if _walk_elems(nb, itemsize, 2) * itemsize <= DEFAULT_SMEM_BUDGET \
        else 1


def walk_smem_bytes(nb: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one update-walk CTA (LARFB, SSRFB and the Q
    updates): four operand slots of :func:`walk_stages` buffers at
    :func:`operand_pitch`, and the two scratch tiles."""
    return _walk_elems(nb, itemsize, walk_stages(nb, itemsize)) * itemsize


def _walk_smem_elems(nb: int, itemsize: int) -> int:
    return _walk_elems(nb, itemsize, walk_stages(nb, itemsize))


MACRO_OPS: Dict[str, MacroOp] = {
    # A and the transposed Gram matrix (pitch nb), T (pitch nb + 1), taus,
    # the column loop's exchange buffer.
    "GEQRT": MacroOp("GEQRT", geqrt_body, geqrt, geqrt_plain,
                     ("d_t", "d_taus"), tile_reads=1, tile_writes=1,
                     vmem_tiles=4,
                     smem_elems=lambda nb, _: 3 * nb * nb + 2 * nb + XCH_ELEMS),
    # The update walk's carve-up (walk_smem_bytes).
    "LARFB": MacroOp("LARFB", larfb_body, larfb, larfb_plain, ("d_t",),
                     tile_reads=2, tile_writes=1, vmem_tiles=5,
                     smem_elems=_walk_smem_elems),
    # D, A (-> V2) and the transposed Gram matrix (pitch nb), T (pitch
    # nb + 1), taus, the column loop's exchange buffer.
    "TSQRT": MacroOp("TSQRT", tsqrt_body, tsqrt, tsqrt_plain,
                     ("t_t", "t_taus"), tile_reads=2, tile_writes=2,
                     vmem_tiles=6,
                     smem_elems=lambda nb, _: 4 * nb * nb + 2 * nb + XCH_ELEMS),
    # The update walk's carve-up.
    "SSRFB": MacroOp("SSRFB", ssrfb_body, ssrfb, ssrfb_plain, ("t_t",),
                     tile_reads=3, tile_writes=2, vmem_tiles=7,
                     smem_elems=_walk_smem_elems),
}


#: Q formation's updates: kind -> (kernel wrapper, plain version, the
#: factor-state field that holds its T).  Both take (tiles, T, E, idx).
Q_OPS: Dict[str, Tuple[Callable, Callable, str]] = {
    "QLARFB": (qlarfb, qlarfb_plain, "d_t"),
    "QSSRFB": (qssrfb, qssrfb_plain, "t_t"),
}


def run_batch(kind: str, state, idx: Tensor, *, use_kernel: bool) -> None:
    """One same-kind task batch on a factor state (any object with the
    ``tiles`` / ``d_t`` / ``d_taus`` / ``t_t`` / ``t_taus`` fields), in
    place: the kernel wrapper when ``use_kernel``, else the plain version."""
    op = MACRO_OPS[kind]
    fn = op.kernel if use_kernel else op.plain
    fn(state.tiles, *(getattr(state, name) for name in op.state), idx)


def run_q_batch(kind: str, state, e: Tensor, idx: Tensor, *,
                use_kernel: bool) -> None:
    """One same-kind batch of Q-formation updates on the Q workspace ``e``
    (the factored ``state`` read only), in place: the kernel wrapper when
    ``use_kernel``, else the plain version."""
    kernel, plain, t_name = Q_OPS[kind]
    (kernel if use_kernel else plain)(state.tiles, getattr(state, t_name), e,
                                      idx)


def smem_bytes(kind: str, nb: int, itemsize: int = 4) -> int:
    """Dynamic shared memory one macro op's kernel takes per CTA at tile
    size nb: the size its launch passes."""
    return MACRO_OPS[kind].smem_elems(nb, itemsize) * itemsize


def engine_smem_bytes(nb: int, itemsize: int = 4) -> int:
    """Largest per-CTA shared memory of the four kernels at tile size nb:
    what the planner and the engine hold against the budget."""
    return max(smem_bytes(k, nb, itemsize) for k in MACRO_OPS)


def engine_vmem_bytes(nb: int, itemsize: int = 4) -> int:
    """The reference's modeled per-task working set (its ``vmem_tiles``),
    reported by ``engine.schedule_stats`` only."""
    return max(op.vmem_tiles for op in MACRO_OPS.values()) * nb * nb * itemsize


# The megakernel lowering's resident set: two phases of the worst-case
# operand set (3 tiles + 1 block reflector), the write-back staging
# tiles, and the worst-case body temporaries — the reference's count,
# kept so the dispatch auto rule reads the same number.
MEGAKERNEL_SMEM_TILES = 2 * (3 + 1) + 3 + 4


def megakernel_smem_bytes(nb: int, itemsize: int = 4) -> int:
    return MEGAKERNEL_SMEM_TILES * nb * nb * itemsize


def megakernel_scratch_elems(nb: int, itemsize: int = 4) -> int:
    """The largest compute scratch of the bodies (``csrc/macro_ops.cu``):
    GEQRT's and TSQRT's transposed Gram matrix, T at pitch nb + 1, taus
    and the column exchange, or the updates' two tiles at
    :func:`operand_pitch`."""
    return max(2 * nb * nb + 2 * nb + XCH_ELEMS,
               2 * nb * operand_pitch(nb, itemsize))


def _megakernel_elems(nb: int, stages: int, itemsize: int) -> int:
    return (4 * stages * nb * operand_pitch(nb, itemsize)
            + megakernel_scratch_elems(nb, itemsize))


def megakernel_stages(nb: int, itemsize: int = 4) -> int:
    """Operand buffers per slot of a megakernel CTA: 2 (the next task's
    tiles stream in while one computes) where four double-buffered slots
    and the scratch fit the shared-memory budget, else 1 (reuse, no
    prefetch: e.g. nb = 64 fp64, whose double buffers alone are 272 KiB)."""
    from repro_torch.core.engine import DEFAULT_SMEM_BUDGET

    fits = _megakernel_elems(nb, 2, itemsize) * itemsize <= DEFAULT_SMEM_BUDGET
    return 2 if fits else 1


def megakernel_launch_smem_bytes(nb: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one megakernel CTA, the size its launch
    passes and the engine's guard reads: four operand slots (V, T, C,
    C_i) of :func:`megakernel_stages` buffers of nb rows at
    :func:`operand_pitch`, then the largest compute scratch."""
    return _megakernel_elems(nb, megakernel_stages(nb, itemsize),
                             itemsize) * itemsize

"""Tiled QR task graph: the symbolic tile DAG and ``tiled_qr``.

Counterpart of the reference's ``repro.core.tilegraph``.  The factorization
is a DAG of tile tasks over a (p x q) grid of nb x nb tiles:

    GEQRT(k)      QR of diagonal tile (k,k)          -> V1, R, T
    LARFB(k,j)    apply Q_k^T to tile (k,j), j > k
    TSQRT(i,k)    QR of the stacked pair [R_kk; A_ik]
    SSRFB(k,i,j)  apply the TSQRT reflectors to the tile pair [A_kj; A_ij]

levelized statically (a task's wavefront is 1 + the max over its
dependencies) and executed by :mod:`repro_torch.core.engine`, level by
level or in one megakernel launch.
The DAG arithmetic below is plain Python and equals the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.blocked import unpack_v_panel
from repro_torch.kernels import macro_ops
from repro_torch.observability import metrics as _metrics

__all__ = [
    "TileTask",
    "build_tasks",
    "task_deps",
    "levelize",
    "wavefronts",
    "wavefront_count",
    "domain_rows",
    "domain_wavefronts",
    "merge_levels",
    "sharded_wavefront_count",
    "tile_grid",
    "tiled_qr",
    "tiled_qr_batched",
]


# ---------------------------------------------------------------------------
# symbolic tile-task DAG
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class TileTask:
    """One macro operation on the tile grid.

    kind: "GEQRT" | "LARFB" | "TSQRT" | "SSRFB"
    k:    panel step (0 <= k < min(p, q))
    i:    row-tile index (GEQRT/LARFB: i == k)
    j:    column-tile index (GEQRT/TSQRT: j == k)
    """

    kind: str
    k: int
    i: int
    j: int


def tile_grid(m: int, n: int, tile: int) -> Tuple[int, int]:
    """Tile-grid shape (p, q) covering an m x n matrix (ceil division)."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    return -(-m // tile), -(-n // tile)


def build_tasks(p: int, q: int) -> List[TileTask]:
    """All tile tasks of a p x q grid, in a valid topological order."""
    tasks: List[TileTask] = []
    for k in range(min(p, q)):
        tasks.append(TileTask("GEQRT", k, k, k))
        tasks.extend(TileTask("LARFB", k, k, j) for j in range(k + 1, q))
        for i in range(k + 1, p):
            tasks.append(TileTask("TSQRT", k, i, k))
            tasks.extend(TileTask("SSRFB", k, i, j) for j in range(k + 1, q))
    return tasks


def task_deps(t: TileTask) -> Tuple[TileTask, ...]:
    """Immediate dependencies of one task (the PLASMA flat-tree DAG):
    TSQRT(i,k) and SSRFB(k,i,j) chain in i, and every step-k task waits
    for the step-(k-1) update of its tiles."""
    k, i, j = t.k, t.i, t.j
    deps: List[TileTask] = []
    if t.kind == "GEQRT":
        if k > 0:
            deps.append(TileTask("SSRFB", k - 1, k, k))
    elif t.kind == "LARFB":
        deps.append(TileTask("GEQRT", k, k, k))
        if k > 0:
            deps.append(TileTask("SSRFB", k - 1, k, j))
    elif t.kind == "TSQRT":
        deps.append(TileTask("TSQRT", k, i - 1, k) if i > k + 1
                    else TileTask("GEQRT", k, k, k))
        if k > 0:
            deps.append(TileTask("SSRFB", k - 1, i, k))
    elif t.kind == "SSRFB":
        deps.append(TileTask("TSQRT", k, i, k))
        deps.append(TileTask("SSRFB", k, i - 1, j) if i > k + 1
                    else TileTask("LARFB", k, k, j))
        if k > 0:
            deps.append(TileTask("SSRFB", k - 1, i, j))
    else:
        raise ValueError(f"unknown task kind {t.kind!r}")
    return tuple(deps)


def levelize(p: int, q: int) -> Dict[TileTask, int]:
    """Wavefront index of every task: 1 + max over its dependencies."""
    levels: Dict[TileTask, int] = {}
    for t in build_tasks(p, q):
        levels[t] = 1 + max((levels[d] for d in task_deps(t)), default=0)
    return levels


def wavefronts(p: int, q: int) -> List[List[TileTask]]:
    """Tasks grouped by wavefront (ascending), deterministic order within."""
    levels = levelize(p, q)
    out: List[List[TileTask]] = [[] for _ in range(max(levels.values(), default=0))]
    for t, lv in levels.items():
        out[lv - 1].append(t)
    for wf in out:
        wf.sort()
    return out


def wavefront_count(p: int, q: int) -> int:
    """Closed-form critical path of the p x q flat-tree tile DAG:
    p + 2q - 2 when p >= q, else 3p - 1."""
    if p < 1 or q < 1:
        raise ValueError(f"grid must be at least 1x1, got {p}x{q}")
    return p + 2 * q - 2 if p >= q else 3 * p - 1


# ---------------------------------------------------------------------------
# row-block domains (the sharded schedule's arithmetic, for DAG analysis)
# ---------------------------------------------------------------------------
#
# The sharded schedule partitions the p x q grid into d contiguous
# row-block domains, each running the flat-tree schedule on its own
# (p_i x q) sub-grid, and merges their R factors through a binary tree
# of ceil(log2 d) rounds: the cross-device critical path is
# wavefront_count(ceil(p / d), q) + ceil(log2 d).  ``core/distgraph.py``
# executes it; these helpers are its schedule, the reference's ints.

def domain_rows(p: int, d: int) -> Tuple[Tuple[int, int], ...]:
    """Contiguous per-domain tile-row ranges ``((start, stop), ...)``:
    p rows over d domains, the first ``p % d`` one row longer.  Requires
    ``1 <= d <= p``."""
    if d < 1 or d > p:
        raise ValueError(f"need 1 <= d <= p, got d={d}, p={p}")
    base, extra = divmod(p, d)
    out, start = [], 0
    for i in range(d):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return tuple(out)


def domain_wavefronts(p: int, q: int, d: int) -> List[List[List[TileTask]]]:
    """Per-domain wavefront schedules: ``out[i]`` is the wavefront list of
    domain i's local (p_i x q) DAG (domain-local task indices)."""
    return [wavefronts(stop - start, q) if stop > start else []
            for start, stop in domain_rows(p, d)]


def merge_levels(d: int) -> int:
    """Depth of the binary R-merge tree over d domains."""
    if d < 1:
        raise ValueError(f"need d >= 1, got {d}")
    return (d - 1).bit_length()


def sharded_wavefront_count(p: int, q: int, d: int) -> int:
    """Cross-device critical path of the d-domain schedule: p pads to
    ``d * ceil(p / d)`` rows, so it is the local schedule of ceil(p / d)
    rows plus the merge rounds; ``d=1`` is :func:`wavefront_count`."""
    if d < 1:
        raise ValueError(f"need d >= 1, got {d}")
    if d == 1:
        return wavefront_count(p, q)
    return wavefront_count(-(-p // d), q) + merge_levels(d)


# ---------------------------------------------------------------------------
# tiled QR
# ---------------------------------------------------------------------------
#
# Every helper takes leading batch dimensions: a (B, m, n) stack splits
# into a (B, p, q, nb, nb) stacked workspace and its Q forms with one
# batched product per step across the B slices.

def _split_tiles(a: torch.Tensor, p: int, q: int, nb: int) -> torch.Tensor:
    lead = tuple(a.shape[:-2])
    return a.reshape(lead + (p, nb, q, nb)).transpose(-3, -2).contiguous()


def _join_tiles(tiles: torch.Tensor) -> torch.Tensor:
    *lead, p, q, nb, _ = tiles.shape
    return tiles.transpose(-3, -2).reshape(*lead, p * nb, q * nb)


def _form_q_tiled(f: engine.FactorState, ncols: int) -> torch.Tensor:
    """Q columns from the factored state: the task transforms applied in
    reverse (TSQRT pairs bottom-up, then the GEQRT diagonal block), each
    an in-place update of one or two nb-row blocks of ``e``.  The plain
    lowering's Q, and the plain version the Q kernels
    (:func:`engine.form_q_tiles`) are held against."""
    *lead, p, q, nb, _ = f.tiles.shape
    e = torch.eye(p * nb, ncols, dtype=f.tiles.dtype, device=f.tiles.device)
    e = e.expand(*lead, p * nb, ncols).clone()
    for k in reversed(range(min(p, q))):
        ek = e[..., k * nb:(k + 1) * nb, :]
        for i in reversed(range(k + 1, p)):
            v2, t = f.tiles[..., i, k, :, :], f.t_t[..., i, k, :, :]
            ei = e[..., i * nb:(i + 1) * nb, :]
            w = t @ (ek + v2.mT @ ei)
            ek -= w
            ei -= v2 @ w
        v1 = unpack_v_panel(f.tiles[..., k, k, :, :], 0)
        ek -= v1 @ (f.d_t[..., k, :, :] @ (v1.mT @ ek))
    return e


def _factor_stack_padded(a_pad: torch.Tensor, *, p: int, q: int, nb: int,
                         mode: str, use_kernel: bool = False,
                         dispatch_mode: str = None, filled: int = None):
    """Factor a tile-aligned ``(B, p*nb, q*nb)`` stack through one
    :func:`engine.factor_tiles_batched` call and return the full padded
    factors: ``(r_full,)`` for mode "r", else ``(q_full, r_full)``, both
    with the batch leading.  Q forms through :func:`engine.form_q_tiles`
    (the Q kernels, by the factorization's lowering) on the kernel path,
    through :func:`_form_q_tiled` on the plain one.  ``filled``: the
    slices from it on are zero matrices (a padded batch), which the
    wavefront lowerings skip (:func:`engine.factor_tiles_batched`)."""
    if mode not in ("reduced", "r", "full"):
        raise ValueError(f"unknown mode {mode!r}")
    f = engine.factor_tiles_batched(_split_tiles(a_pad, p, q, nb), p=p, q=q,
                                    nb=nb, use_kernel=use_kernel,
                                    dispatch_mode=dispatch_mode,
                                    filled=filled)
    r_full = torch.triu(_join_tiles(f.tiles))
    if mode == "r":
        return (r_full,)
    ncols = min(p * nb, q * nb) if mode == "reduced" else p * nb
    if not use_kernel:
        return _form_q_tiled(f, ncols), r_full
    # Q through the Q kernels, by the lowering the factorization ran.
    e = engine.form_q_tiles(f, ncols, dispatch_mode=dispatch_mode,
                            filled=filled)
    return _join_tiles(e), r_full


def tiled_qr_batched(a: torch.Tensor, *, tile: int = 32,
                     mode: str = "reduced", use_kernel: bool = False,
                     dispatch_mode: str = None):
    """QR of every slice of a ``(B, m, n)`` stack via the tiled task graph,
    through one batched engine call (:func:`_factor_stack_padded`), on
    ``a``'s device: :func:`tiled_qr`'s modes and shapes with the batch
    leading.

    ``use_kernel=True`` runs the engine's kernel lowering — one launch of
    the batched megakernel for the whole stack, or one wavefront launch
    per (level, kind) for the whole stack, as ``dispatch_mode`` (None: the
    auto rule) says;
    ``False`` runs the plain lowering of the same schedule.  Shapes that
    are not multiples of the tile are zero-padded: padded rows and columns
    factor to exact ``tau = 0`` reflectors, so the unpadded slices of Q
    and R factor ``a`` itself.

    mode: "reduced" -> (Q m x k, R k x n); "r" -> R; "full" -> (Q m x m,
    R m x n), with k = min(m, n).
    """
    if a.ndim != 3:
        raise ValueError(f"tiled_qr_batched expects a (B, m, n) stack, got "
                         f"{tuple(a.shape)}")
    b, m, n = a.shape
    if m == 0 or n == 0:
        raise ValueError(
            f"tiled_qr needs nonempty matrices, got {tuple(a.shape)}; "
            "zero-dim inputs route to the planner's 'degenerate' method")
    p, q = tile_grid(m, n, tile)
    nb = tile
    a_pad = torch.zeros(b, p * nb, q * nb, dtype=a.dtype, device=a.device)
    a_pad[:, :m, :n] = a
    out = _factor_stack_padded(a_pad, p=p, q=q, nb=nb, mode=mode,
                               use_kernel=use_kernel,
                               dispatch_mode=dispatch_mode)
    k = min(m, n)
    if mode == "r":
        return out[0][:, :k, :n]
    q_mat, r_full = out
    if mode == "reduced":
        return q_mat[:, :m, :k], r_full[:, :k, :n]
    return q_mat[:, :m, :m], r_full[:, :m, :n]


def tiled_qr(a: torch.Tensor, *, tile: int = 32, mode: str = "reduced",
             use_kernel: bool = False, dispatch_mode: str = None):
    """QR of one ``(m, n)`` matrix via the tiled task graph: a stack of
    one through :func:`tiled_qr_batched`, whose engine call runs the
    single-matrix path for it (one megakernel launch, or one launch per
    wavefront level and kind)."""
    if a.ndim != 2:
        raise ValueError(f"tiled_qr expects a matrix, got {tuple(a.shape)}")
    out = tiled_qr_batched(a[None], tile=tile, mode=mode,
                           use_kernel=use_kernel, dispatch_mode=dispatch_mode)
    return out[0] if mode == "r" else tuple(x[0] for x in out)


# -- registry -----------------------------------------------------------------
from repro_torch.core.plan import (  # noqa: E402
    MethodSpec, QRConfig, RouteDecision, as_torch_dtype, register_method,
    sign_fix_qr, sign_fix_r)


def _planned_itemsize(cfg: QRConfig, dtype) -> int:
    """Element width of the compute dtype the solve will run."""
    if cfg.precision is not None:
        return as_torch_dtype(cfg.precision).itemsize
    return as_torch_dtype(dtype).itemsize if dtype is not None else 4


def _resolve_dispatch(p: int, q: int, cfg: QRConfig, dtype,
                      explain) -> QRConfig:
    """The engine lowering the kernel path will run on a (p, q) grid at
    ``cfg.block``: a forced megakernel's table checked, or the auto rule
    resolved and recorded (megakernel iff its task table and working set
    fit; a ``megakernel_over_budget`` fallback otherwise), as the
    reference's tiled and sharded resolve hooks share it."""
    if cfg.dispatch_mode == "megakernel":
        engine.check_table(p, q)
    elif cfg.dispatch_mode is None:
        mode, why = engine.explain_dispatch_mode(
            p, q, cfg.block, _planned_itemsize(cfg, dtype))
        if mode == "wavefront":
            _metrics.counter("planner.fallbacks",
                             reason="megakernel_over_budget").inc()
        if explain is not None:
            explain.append(
                RouteDecision("megakernel_over_budget", "fallback", why)
                if mode == "wavefront" else
                RouteDecision("dispatch_mode_auto", "resolved", why))
        cfg = cfg.replace(dispatch_mode=mode)
    return cfg


def _resolve_tiled(m: int, n: int, cfg: QRConfig, *, dtype=None,
                   explain=None) -> QRConfig:
    # cfg.block doubles as the tile size; never exceed the matrix itself.
    cfg = cfg.replace(block=min(cfg.block, m, n))
    if not cfg.use_kernel:
        return cfg
    return _resolve_dispatch(*tile_grid(m, n, cfg.block), cfg, dtype, explain)


def _solve_tiled_batched(a: torch.Tensor, cfg: QRConfig):
    """A ``(B, m, n)`` stack through one batched engine call; the modes,
    ``q_method`` and ``sign_fix`` of a single solve, slice by slice."""
    _, m, n = a.shape
    kw = dict(tile=cfg.block, use_kernel=bool(cfg.use_kernel),
              dispatch_mode=cfg.dispatch_mode)
    if cfg.mode == "r":
        r = tiled_qr_batched(a, mode="r", **kw)
        return sign_fix_r(r) if cfg.sign_fix else r
    if cfg.mode == "reduced" and cfg.q_method == "solve" and m >= n:
        from repro_torch.core.tsqr import triangular_inverse_apply

        r = tiled_qr_batched(a, mode="r", **kw)
        q = triangular_inverse_apply(a, r[:, :n, :n])
    else:
        q, r = tiled_qr_batched(a, mode=cfg.mode, **kw)
    return sign_fix_qr(q, r) if cfg.sign_fix else (q, r)


def _solve_tiled(a: torch.Tensor, cfg: QRConfig):
    out = _solve_tiled_batched(a[None], cfg)
    return out[0] if cfg.mode == "r" else tuple(x[0] for x in out)


def _smem_tiled(m: int, n: int, cfg: QRConfig, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the lowering the kernel path runs: a
    forced megakernel's own launch size, else the largest wavefront
    kernel's.  The auto rule picks the megakernel only where it fits
    too."""
    nb = min(cfg.block, m, n)
    if cfg.dispatch_mode == "megakernel":
        return macro_ops.megakernel_launch_smem_bytes(nb, itemsize)
    return macro_ops.engine_smem_bytes(nb, itemsize)


register_method(MethodSpec(
    name="tiled",
    solve=_solve_tiled,
    solve_batched=_solve_tiled_batched,
    resolve=_resolve_tiled,
    kernel_backed=True,
    smem_bytes=_smem_tiled,
    kernel_policy="macro_ops",
    description="tiled task-graph QR via the macro-op engine "
                "(GEQRT/TSQRT/LARFB/SSRFB: one persistent megakernel "
                "launch where its task table fits, else one kernel launch "
                "per level and kind; a stack through one batched launch)",
))

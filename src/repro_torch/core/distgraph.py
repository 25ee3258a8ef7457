"""Sharded tiled QR — row-block wavefront domains over a process group.

Counterpart of the reference's ``repro.core.distgraph`` (the
``sharded_tiled`` method): the hierarchical tiled QR of Dongarra et al.
(arXiv:1110.1553) on the PLASMA tile DAG, the paper's §5.2 parallel QR
carried beyond one device.  The reference maps it onto a JAX device mesh
with ``shard_map``; the port maps it onto the ranks of a
``torch.distributed`` process group, SPMD: every rank calls :func:`qr`
(or :func:`sharded_tiled_qr`) with the same whole matrix, which plays
the part of the reference's replicated global array.

  1. **Domain partition**: the p x q tile grid splits into ``d``
     contiguous row-block domains of ``ceil(p/d)`` tile rows each (rows
     zero-padded to ``d * ceil(p/d)`` tiles: padded rows give exact-zero
     reflectors); rank i owns domain i.
  2. **Domain-local wavefronts**: each rank factors its rows through
     :func:`repro_torch.core.tilegraph.tiled_qr` (``mode="r"``), so the
     sweep runs the wavefront kernels or the megakernel by the engine's
     rule on the per-domain grid — no traffic during the sweep.
  3. **R merge**: the per-domain R factors reduce through the TSQR
     butterfly (:func:`repro_torch.core.tsqr.butterfly_merge_r`), one
     n x n triangle per link a round; after ``log2(d)`` rounds every
     rank holds the same R.  The combine is
     :func:`repro_torch.core.tsqr._local_r` with the solve's
     ``use_kernel`` (on the card: the panel kernels; the reference's
     merge runs jnp, ROADMAP §C).
  4. **Thin Q** (``mode="reduced"``): ``Q = A R^{-1}`` on each domain,
     refined by a second merge (CQR2), then the Q rows are all-gathered,
     so every rank returns the whole thin Q and R.

First, on a group of more than one rank, every rank all-gathers a
fingerprint of its ``a`` (shape, dtype, float64 checksums), before any
rank reads the shape or picks a domain count; when the copies differ
every rank raises :class:`repro_torch.distributed.sharding.DivergentCopiesError`
(a ``ValueError``), so a rank's own matrix is never mixed with another's
(ROADMAP C10).  Ranks at or past ``d`` (a grid with fewer tile rows than ranks) compute
nothing and receive the result from group rank 0.  Degeneracies, as the
reference's: ``d == 1`` (one rank, no process group, ``ndomains=1``, or
wide input) is the tiled backend's result bit for bit; ``d`` is capped at
the tile-row count and rounded down to a power of two.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plan import resolve_device
from repro_torch.core.tilegraph import merge_levels, tile_grid, tiled_qr
from repro_torch.core.tsqr import (_local_r, butterfly_merge_r,
                                   triangular_inverse_apply)
from repro_torch.distributed import sharding
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace

Tensor = torch.Tensor

__all__ = [
    "effective_domains",
    "sharded_tiled_qr",
]


def effective_domains(m: int, n: int, tile: int,
                      requested: Optional[int] = None,
                      device_count: Optional[int] = None) -> int:
    """The domain count the executor will use: the request (default:
    every rank) capped at ``device_count`` (default: the default process
    group's size, 1 without one) and the tile-row count, rounded down to
    a power of two (butterfly merge); 1 for wide matrices."""
    if m < n:
        return 1
    p, _ = tile_grid(m, n, tile)
    avail = sharding.world_size() if device_count is None else device_count
    d = avail if requested is None else min(requested, avail)
    return sharding.largest_pow2(max(1, min(d, p)))


def _pad_rows(x: Tensor, rows: int) -> Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def _merged_r(a_dom: Tensor, tile: int, use_kernel: bool, dispatch_mode,
              group) -> Tensor:
    """Global R from this rank's domain: the tiled wavefronts on its rows
    (R padded to n x n: a domain shorter than n adds zero rows to the
    merge stack), then the butterfly over the domain group."""
    n = a_dom.shape[1]
    with _trace.span("distgraph.domain_r", rows=a_dom.shape[0]) as sp:
        r = sp.sync(_pad_rows(tiled_qr(a_dom, tile=tile, mode="r",
                                       use_kernel=use_kernel,
                                       dispatch_mode=dispatch_mode), n))
    return butterfly_merge_r(
        r, group, lambda stack: _local_r(stack, qr_block=min(32, n),
                                         use_kernel=use_kernel))


def _domain_solve(a_dom: Tensor, *, tile: int, mode: str, use_kernel: bool,
                  refine: bool, dispatch_mode, group):
    """One rank's program: local wavefronts -> R merge (-> thin Q of its
    rows): ``r`` or ``(q_dom, r)``."""
    kw = dict(tile=tile, use_kernel=use_kernel, dispatch_mode=dispatch_mode,
              group=group)
    r1 = _merged_r(a_dom, **kw)
    if mode == "r":
        return r1
    q_dom = triangular_inverse_apply(a_dom, r1)
    if refine:
        r2 = _merged_r(q_dom, **kw)
        return triangular_inverse_apply(q_dom, r2), r2 @ r1
    return q_dom, r1


def sharded_tiled_qr(a, *, tile: int = 32, mode: str = "reduced",
                     use_kernel: bool = False, ndomains: Optional[int] = None,
                     refine: bool = True, dispatch_mode: Optional[str] = None,
                     group=None, device=None):
    """QR of ``a`` via per-rank tiled wavefront domains and the R merge
    tree, over ``group`` (None: the default process group).  Every rank of
    the group calls it with the same ``a`` and arguments, and every rank
    returns the same result.

    mode: "reduced" -> (Q m x k, R k x n) with k = min(m, n); "r" -> R.
    With more than one domain the thin Q is always solve-based
    (CQR2-refined ``A R^{-1}``): the merge tree never forms the
    domain-crossing reflectors.  ``ndomains=None`` uses every rank; the
    count run is :func:`effective_domains`.  With one domain this is
    :func:`tiled_qr`, bit for bit.  ``refine`` runs the CQR2 second pass.
    ``dispatch_mode`` picks the engine lowering of each domain's sweep on
    the kernel path (None: the engine's rule on the per-domain grid).

    Runs on ``a``'s device when ``a`` is a tensor and ``device`` is None;
    otherwise on ``device`` ("cuda" unless the caller asks for the CPU).
    """
    if mode not in ("reduced", "r"):
        raise ValueError(
            f"sharded_tiled supports modes 'reduced'/'r', got {mode!r}")
    if device is not None or not isinstance(a, Tensor):
        a = torch.as_tensor(a, device=resolve_device(device))
    # Every rank must hold the same matrix: checked on all of the group's
    # ranks before any of them reads its shape (collective).
    sharding.check_same_copies(a, group)
    m, n = a.shape
    d = effective_domains(m, n, tile, ndomains,
                          device_count=sharding.group_size(group))
    if d == 1:
        return tiled_qr(a, tile=tile, mode=mode, use_kernel=use_kernel,
                        dispatch_mode=dispatch_mode)

    p, _ = tile_grid(m, n, tile)
    p_dom = -(-p // d)
    rows = p_dom * tile
    k = min(m, n)
    levels = merge_levels(d)
    _metrics.counter("distributed.solves", domains=d, mode=mode).inc()
    _metrics.counter("distributed.merge_rounds", domains=d).inc(
        levels * (2 if mode != "r" and refine else 1))
    _metrics.gauge("distributed.domain_tile_rows", domains=d).set(p_dom)

    domains = sharding.row_domain_mesh(d, group)    # collective: every rank
    rank = sharding.group_rank(group)
    with _trace.span("distgraph.sharded_tiled_qr", domains=d,
                     shape=f"{m}x{n}", tile=tile,
                     merge_levels=levels) as sp:
        out = None
        if rank < d:
            a_dom = _pad_rows(a[rank * rows:(rank + 1) * rows], rows)
            res = _domain_solve(a_dom, tile=tile, mode=mode,
                                use_kernel=use_kernel, refine=refine,
                                dispatch_mode=dispatch_mode, group=domains)
            if mode == "r":
                out = (res[:k, :n],)
            else:
                q = sharding.all_gather_rows(res[0], domains)
                out = (q[:m, :k], res[1][:k, :n])
        if d < sharding.group_size(group):
            # The idle ranks receive group rank 0's result; the others
            # keep their own (the same bits).
            shapes = [(k, n)] if mode == "r" else [(m, k), (k, n)]
            parent = sharding.resolve_group(group)
            got = tuple(
                sharding.broadcast_from_first(
                    None if out is None else out[i], parent,
                    out=a.new_empty(shape))
                for i, shape in enumerate(shapes))
            out = got if out is None else out
        return sp.sync(out[0] if mode == "r" else out)


# -- registry -----------------------------------------------------------------
from repro_torch.core.plan import (  # noqa: E402
    MethodSpec, QRConfig, RouteDecision, kernel_smem_budget, register_method,
    sign_fix_qr, sign_fix_r)
from repro_torch.core.tilegraph import (  # noqa: E402
    _planned_itemsize, _resolve_dispatch, _smem_tiled, _solve_tiled)

# Keep each domain's task DAG within the single-device size: grow the
# tile until the per-domain grid is at most this many tiles on its long
# side (a domain's task count is O(p q min(p, q))).
_MAX_DOMAIN_GRID = 64


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _resolve_sharded(m: int, n: int, cfg: QRConfig, *, dtype=None,
                     explain=None) -> QRConfig:
    d = effective_domains(m, n, cfg.block, cfg.ndomains)
    tile = min(cfg.block, m, n)

    # Silent-degradation sites: the executor runs fewer domains than the
    # request (or the rank count) implies — surface the concrete cause.
    avail = sharding.world_size()
    wanted = avail if cfg.ndomains is None else min(cfg.ndomains, avail)
    if d == 1 and wanted > 1:
        _metrics.counter("planner.fallbacks",
                         reason="sharded_degraded_to_tiled").inc()
        if explain is not None:
            explain.append(RouteDecision(
                "sharded_degraded_to_tiled", "fallback",
                f"wide matrix m={m} < n={n} shards to 1 domain"
                if m < n else
                f"{wanted} domains requested but the {m}x{n} grid at "
                f"tile {cfg.block} supports 1 — running the "
                f"single-device tiled path bit-for-bit"))
    elif d < wanted:
        _metrics.counter("planner.fallbacks",
                         reason="sharded_domains_capped").inc()
        if explain is not None:
            explain.append(RouteDecision(
                "sharded_domains_capped", "fallback",
                f"{wanted} domains requested, running {d} (capped at "
                f"the tile-row count and rounded down to a power of "
                f"two for the butterfly merge)"))

    def domain_rows_of(t: int) -> int:
        return _ceil_div(_ceil_div(m, t), d)  # ceil(p / d) tile rows/rank

    def domain_grid_side(t: int) -> int:
        return max(domain_rows_of(t), _ceil_div(n, t))

    while domain_grid_side(tile) > _MAX_DOMAIN_GRID and tile < min(m, n):
        tile = min(2 * tile, m, n)
    if explain is not None and tile != min(cfg.block, m, n):
        explain.append(RouteDecision(
            "sharded_tile_grown", "resolved",
            f"tile grown {cfg.block} -> {tile} to keep each domain's "
            f"grid side <= {_MAX_DOMAIN_GRID} (task count is "
            f"O(p q min(p, q)) per domain)"))
    cfg = cfg.replace(block=tile)
    if cfg.use_kernel:
        # The kernels never run a tile their shared memory cannot hold,
        # and the solve never leaves them for it unasked.
        itemsize = _planned_itemsize(cfg, dtype)
        need = _smem_tiled(m, n, cfg, itemsize)
        budget = kernel_smem_budget("macro_ops")
        if need > budget:
            raise ValueError(
                f"sharded_tiled at {m}x{n} over {d} domain(s): each "
                f"domain's grid needs tile {tile}, whose kernels' per-task "
                f"shared memory ({need} B at {itemsize}-byte elements) "
                f"exceeds the budget ({budget} B); run more domains, or "
                f"pass use_kernel=False for the plain lowering")
        # The lowering each domain's sweep will run: the engine's rule on
        # the per-domain grid, not the global one.
        cfg = _resolve_dispatch(domain_rows_of(tile), _ceil_div(n, tile),
                                cfg, dtype, explain)
    if d > 1:
        # Across domains the thin Q is always solve-based (the merge tree
        # never forms the domain-crossing reflectors); with d == 1 the
        # tiled path runs and honors q_method as planned.
        return cfg.replace(ndomains=d, q_method="solve")
    return cfg.replace(ndomains=d)


def _solve_sharded(a: Tensor, cfg: QRConfig):
    m, n = a.shape
    d = effective_domains(m, n, cfg.block, cfg.ndomains)
    if d == 1:
        # Bit for bit the single-device tiled backend (same solve hook).
        return _solve_tiled(a, cfg)
    kw = dict(tile=cfg.block, use_kernel=bool(cfg.use_kernel), ndomains=d,
              dispatch_mode=cfg.dispatch_mode)
    if cfg.mode == "r":
        r = sharded_tiled_qr(a, mode="r", **kw)
        return sign_fix_r(r) if cfg.sign_fix else r
    q, r = sharded_tiled_qr(a, mode="reduced", refine=cfg.refine, **kw)
    return sign_fix_qr(q, r) if cfg.sign_fix else (q, r)


register_method(MethodSpec(
    name="sharded_tiled",
    solve=_solve_sharded,
    resolve=_resolve_sharded,
    supports_full_q=False,
    batched=False,
    kernel_backed=True,
    # A rank's working set is one domain's engine dispatch: sharding
    # divides the grid, not the tiles.
    smem_bytes=_smem_tiled,
    kernel_policy="macro_ops",
    description="multi-rank tiled QR: per-rank row-block wavefront "
                "domains over a torch.distributed process group + "
                "TSQR-style butterfly R merge",
))

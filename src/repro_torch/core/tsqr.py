"""TSQR — tall-skinny QR through a reduction tree of small stacked-R
factorizations (paper §5.2's parallel QR, on one device).

Counterpart of the reference's ``repro.core.tsqr`` single-device layer:
:func:`tsqr_r` / :func:`tsqr_qr` and the ``tsqr`` method.  The row blocks
(leaves) and each merge level are one batched :func:`geqrf` call, so on
the card a panel step of a whole level is one ``mht_panel`` launch and
one ``wy_trailing`` launch; a ``(B, m, n)`` stack of matrices runs its
levels together too.  ``Q = A R^{-1}`` is a triangular solve
(``torch.linalg.solve_triangular``), as the reference computes it
outside its kernels.

The collective layer — :func:`butterfly_merge_r`,
:func:`tsqr_tree_sharded`, :func:`distributed_qr` — runs over a
``torch.distributed`` process group where the reference runs inside
``shard_map`` over a mesh axis: every rank of the group calls it with
its own rows (SPMD), and the n x n triangles travel through
:mod:`repro_torch.distributed.sharding`'s exchanges (a host copy on
gloo, device memory on NCCL).  The merge's combine is :func:`_local_r`
with the caller's ``use_kernel``, so on the card it runs the panel
kernels; the reference's merge inside ``sharded_tiled`` runs jnp
(ROADMAP §C).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.blocked import geqrf
from repro_torch.core.householder import unpack_r
from repro_torch.core.plan import (MethodSpec, QRConfig, RouteDecision,
                                   register_method, sign_fix_qr, sign_fix_r)
from repro_torch.distributed import sharding
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace

__all__ = ["tsqr_r", "tsqr_qr", "triangular_inverse_apply", "default_nblocks",
           "butterfly_merge_r", "tsqr_tree_sharded", "distributed_qr"]

Tensor = torch.Tensor


def _local_r(blocks: Tensor, *, qr_block: int = 32,
             use_kernel: bool = False) -> Tensor:
    """R factors ``(..., n, n)`` of ``(..., mb, n)`` blocks via blocked MHT
    QR, all in one :func:`geqrf` call."""
    n = blocks.shape[-1]
    packed, _ = geqrf(blocks, block=min(qr_block, n), panel_method="mht",
                      use_kernel=use_kernel)
    return unpack_r(packed)[..., :n, :n]


def tsqr_r(a: Tensor, *, nblocks: int = 4, qr_block: int = 32,
           use_kernel: bool = False) -> Tensor:
    """R factor of tall-skinny ``(..., m, n)`` matrices (m a multiple of
    ``nblocks``): R of each of the ``nblocks`` row blocks, then a binary
    tree of QRs of stacked R pairs (an odd one is carried up a level)."""
    m, n = a.shape[-2:]
    if m % nblocks != 0:
        raise ValueError(f"m={m} not divisible by nblocks={nblocks}")
    lead = a.shape[:-2]
    rs = _local_r(a.reshape((-1, nblocks, m // nblocks, n)),
                  qr_block=qr_block, use_kernel=use_kernel)
    while rs.shape[1] > 1:
        carry = None
        if rs.shape[1] % 2:
            carry, rs = rs[:, -1:], rs[:, :-1]
        stacked = torch.cat([rs[:, 0::2], rs[:, 1::2]], dim=-2)
        rs = _local_r(stacked, qr_block=qr_block, use_kernel=use_kernel)
        if carry is not None:
            rs = torch.cat([rs, carry], dim=1)
    return rs[:, 0].reshape(lead + (n, n))


def triangular_inverse_apply(a: torch.Tensor, r: torch.Tensor, *,
                             rcond: float = 1e-7) -> torch.Tensor:
    """``a @ r^{-1}`` by triangular solve, with a sign-preserving diagonal
    clamp for near-singular R; leading batch dimensions are independent."""
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    dmax = torch.clamp(d.abs().amax(-1, keepdim=True), min=1e-30)
    floor = rcond * dmax
    clamp = torch.where(d.abs() < floor, torch.where(d >= 0, floor, -floor), d)
    r_safe = r + torch.diag_embed(clamp - d)
    # a r^{-1}  <=>  solve r^T x^T = a^T with lower-triangular r^T
    return torch.linalg.solve_triangular(r_safe.mT, a.mT, upper=False).mT


def default_nblocks(m: int, n: int) -> int:
    """Largest divisor of m in [2, 8] scaled by aspect."""
    nb = max(2, min(8, m // max(n, 1)))
    while m % nb != 0:
        nb -= 1
    return max(nb, 1)


def _resolve_tsqr(m: int, n: int, cfg: QRConfig, *, dtype=None,
                  explain=None) -> QRConfig:
    nb = cfg.nblocks if cfg.nblocks is not None else default_nblocks(m, n)
    if m % nb != 0:
        raise ValueError(f"m={m} not divisible by nblocks={nb}")
    if explain is not None and cfg.nblocks is None:
        explain.append(RouteDecision(
            "tsqr_nblocks", "resolved",
            f"nblocks={nb} (largest divisor of m={m} in [2, 8] scaled "
            f"by aspect) — merge tree depth {(nb - 1).bit_length()}"))
    return cfg.replace(nblocks=nb)


def tsqr_qr(a: Tensor, *, nblocks: int = 4, refine: bool = True,
            qr_block: int = 32, use_kernel: bool = False
            ) -> Tuple[Tensor, Tensor]:
    """Thin QR of tall-skinny ``a`` via TSQR-R and ``Q = A R^{-1}``;
    ``refine=True`` runs a second pass (CQR2-style) that restores
    orthogonality to about machine eps."""
    kw = dict(nblocks=nblocks, qr_block=qr_block, use_kernel=use_kernel)
    r1 = tsqr_r(a, **kw)
    q = triangular_inverse_apply(a, r1)
    if refine:
        r2 = tsqr_r(q, **kw)
        return triangular_inverse_apply(q, r2), r2 @ r1
    return q, r1


# ---------------------------------------------------------------------------
# collective versions (over a process group)
# ---------------------------------------------------------------------------

def butterfly_merge_r(r: Tensor, group, combine) -> Tensor:
    """Merge every rank's (n x n) R into the global R, on every rank of
    ``group`` — the TSQR combine tree, shared with the sharded tiled QR.

    Round ``level`` exchanges the current R with the partner ``rank XOR
    2^level``, stacks the pair with the lower rank's on top and reduces it
    with ``combine((2n x n) stack) -> (n x n) R``.  After log2(P) rounds
    every rank holds the same R, bit for bit when ``combine`` is
    deterministic (both partners reduce the same stack).  One n x n
    triangle crosses each link a round.  The group's size must be a power
    of two."""
    p = sharding.group_size(group)
    if p & (p - 1):
        raise ValueError(f"butterfly_merge_r needs a power-of-two group, "
                         f"got {p} ranks")
    rank = sharding.group_rank(group)
    with _trace.span("tsqr.butterfly_merge_r", ranks=p) as sp:
        for level in range(p.bit_length() - 1):
            stride = 1 << level
            partner = sharding.exchange(r, rank ^ stride, group)
            top, bot = (r, partner) if (rank & stride) == 0 else (partner, r)
            r = combine(torch.cat([top, bot], dim=0))
        return sp.sync(r)


def tsqr_tree_sharded(a_local: Tensor, group, *, qr_block: int = 32,
                      use_kernel: bool = False) -> Tensor:
    """Global R of a row-sharded tall matrix: this rank's rows
    ``a_local`` (at least n of them) factored by blocked MHT, then the
    :func:`butterfly_merge_r` tree; every rank of ``group`` ends with the
    same R."""
    kw = dict(qr_block=qr_block, use_kernel=use_kernel)
    return butterfly_merge_r(_local_r(a_local, **kw), group,
                             lambda stack: _local_r(stack, **kw))


def distributed_qr(a_local: Tensor, group, *, refine: bool = True,
                   qr_block: int = 32, use_kernel: bool = False
                   ) -> Tuple[Tensor, Tensor]:
    """Thin QR of a row-sharded matrix: ``(q_local, r)``, this rank's rows
    of the thin Q and the global R (the same on every rank).  ``refine``
    runs the CQR2 second pass (a second merge tree)."""
    kw = dict(qr_block=qr_block, use_kernel=use_kernel)
    r1 = tsqr_tree_sharded(a_local, group, **kw)
    q_local = triangular_inverse_apply(a_local, r1)
    if refine:
        r2 = tsqr_tree_sharded(q_local, group, **kw)
        return triangular_inverse_apply(q_local, r2), r2 @ r1
    return q_local, r1


def _solve_tsqr_batched(a: Tensor, cfg: QRConfig):
    """A ``(B, m, n)`` stack through one tree: each level one batched
    factorization of every matrix's blocks.  Counts ``tsqr.solves`` and
    sets ``tsqr.tree_depth``, as the reference's solve does."""
    _metrics.counter("tsqr.solves", nblocks=cfg.nblocks, mode=cfg.mode).inc()
    _metrics.gauge("tsqr.tree_depth", nblocks=cfg.nblocks).set(
        (cfg.nblocks - 1).bit_length())
    kw = dict(nblocks=cfg.nblocks, qr_block=min(cfg.block, a.shape[-1]),
              use_kernel=bool(cfg.use_kernel))
    if cfg.mode == "r":
        r = tsqr_r(a, **kw)
        return sign_fix_r(r) if cfg.sign_fix else r
    q, r = tsqr_qr(a, refine=cfg.refine, **kw)
    return sign_fix_qr(q, r) if cfg.sign_fix else (q, r)


def _solve_tsqr(a: Tensor, cfg: QRConfig):
    return _solve_tsqr_batched(a, cfg)


def _smem_tsqr(m: int, n: int, cfg: QRConfig, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the kernel path: the leaves' panels (the
    tallest, ``(m / nblocks, bw)``) and the trailing kernel."""
    from repro_torch.kernels import ops

    nb = cfg.nblocks if cfg.nblocks is not None else default_nblocks(m, n)
    bw = min(cfg.block, n)
    return ops.panel_path_smem_bytes(max(m // nb, 2 * n), bw, (bw,), itemsize)


register_method(MethodSpec(
    name="tsqr",
    solve=_solve_tsqr,
    solve_batched=_solve_tsqr_batched,
    resolve=_resolve_tsqr,
    supports_full_q=False,
    min_aspect=4.0,
    kernel_backed=True,
    smem_bytes=_smem_tsqr,
    description="tall-skinny tree QR (single device; sharded via shard_map)",
))

"""DAG-level parallelism quantification — paper §4, eq. 6-10, Fig. 9.

Counterpart of the reference's ``repro.core.dag`` (numpy only; the tile
schedule comes from :mod:`repro_torch.core.tilegraph`).  The paper
measures the fine-grained parallelism of a routine as

    beta = (total scalar operations) / (number of levels in the DAG)

and compares classical HT (fig 6: Householder matrix P materialized, then
P A) against MHT (fig 8: fused macro-op, P never formed), showing the
ratio theta = beta_HT / beta_MHT = levels_MHT / levels_HT saturating
around 0.75 — i.e. ~1.33x more operations available per level in MHT.

Both DAGs are rebuilt *symbolically*: every scalar op node's level is
1 + max(level of its operands), inputs are level 0.  Levels propagate
with vectorized numpy and op counts are tallied exactly.  Balanced binary
reduction trees are simulated pairwise in operand order, matching the
paper's tree-sum DAGs.

Conventions (the reference's):
  * classical HT = explicit P: per column, P = I - 2 v v^T costs 3 level-
    chained elementwise ops, then PA is a full matmul (mul + add-tree).
  * MHT = fused: w = v^T A (mul + add-tree), then a - 2 v_i w_k as a
    2-op chain.
  * The Householder-vector computation (norm, sqrt, divide) is identical
    in both, as in the paper.

The tiled DAG's depth, :func:`analyze_tiled`, is the level count the
engine dispatches: one wavefront launch batch a level, or one megakernel
level.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["DagStats", "analyze_ht", "analyze_mht", "analyze_tiled",
           "analyze_sharded_tiled", "theta_curve", "tiled_curve",
           "sharded_curve"]


@dataclasses.dataclass
class DagStats:
    ops: int       # total scalar operations
    depth: int     # number of levels in the DAG

    @property
    def beta(self) -> float:
        return self.ops / max(self.depth, 1)


class _Counter:
    def __init__(self) -> None:
        self.ops = 0

    def add(self, n: int) -> None:
        self.ops += int(n)


def _tree_reduce_levels(levels: np.ndarray, axis: int, counter: _Counter) -> np.ndarray:
    """Level of a balanced pairwise reduction along ``axis``; counts the
    (size-1) combine ops per reduced vector."""
    levels = np.moveaxis(levels, axis, 0)
    n = levels.shape[0]
    counter.add(max(n - 1, 0) * int(np.prod(levels.shape[1:], dtype=np.int64)))
    while levels.shape[0] > 1:
        k = levels.shape[0]
        even = levels[0 : k - (k % 2) : 2]
        odd = levels[1 : k : 2]
        merged = 1 + np.maximum(even, odd)
        if k % 2 == 1:
            merged = np.concatenate([merged, levels[-1:]], axis=0)
        levels = merged
    return levels[0]


def _house_vector_levels(col_levels: np.ndarray, counter: _Counter) -> Tuple[np.ndarray, int]:
    """Levels of v (per element) and of alpha, for one column's reflector.

    alpha = -sign(a_p) * sqrt(sum_i a_i^2)
    r     = sqrt((alpha^2 - a_p * alpha) / 2)
    v_i   = numerator_i / (2 r)
    """
    L = col_levels.shape[0]
    sq = col_levels + 1                      # a_i^2
    counter.add(L)
    ssum = _tree_reduce_levels(sq, 0, counter)
    sqrt_lvl = int(ssum) + 1                 # sqrt
    alpha = sqrt_lvl + 1                     # sign/negate merge
    counter.add(2)
    # r: alpha^2 (1), a_p*alpha (parallel), sub, half, sqrt
    a2 = alpha + 1
    ap_a = max(alpha, int(col_levels[0])) + 1
    sub = max(a2, ap_a) + 1
    r = sub + 2                              # half, then sqrt
    counter.add(5)
    two_r = r + 1
    counter.add(1)
    num = col_levels.copy()
    num[0] = max(int(col_levels[0]), alpha) + 1   # a_p - alpha
    counter.add(1)
    v = np.maximum(num, two_r) + 1           # divide
    counter.add(L)
    return v, alpha


def _analyze(n: int, mode: str) -> DagStats:
    """Walk the full n x n factorization, propagating entry levels."""
    counter = _Counter()
    a = np.zeros((n, n), dtype=np.int64)  # input levels
    depth = 0
    for j in range(n - 1):
        L = n - j                  # active column height
        w = n - j - 1              # trailing width
        col = a[j:, j]
        v, alpha = _house_vector_levels(col, counter)
        depth = max(depth, alpha)
        trail = a[j:, j + 1 :]     # (L, w)

        if mode == "ht":
            # P = I - 2 v v^T: mul, scale, sub  (3 chained ops per entry)
            p = np.maximum(v[:, None], v[None, :]) + 3
            counter.add(3 * L * L)
            # (PA)_ik = tree-add_t( P_it * A_tk )
            mul = 1 + np.maximum(p[:, :, None], trail[None, :, :])  # (L,L,w)
            counter.add(L * L * w)
            new_trail = _tree_reduce_levels(mul, 1, counter)         # (L,w)
        elif mode == "mht":
            # w_k = tree-add_i( v_i * a_ik )
            mul = 1 + np.maximum(v[:, None], trail)                  # (L,w)
            counter.add(L * w)
            wk = _tree_reduce_levels(mul, 0, counter)                # (w,)
            # a_ik' = a_ik - 2 * v_i * w_k : two chained ops (2v_i folds)
            upd = 1 + np.maximum(v[:, None], wk[None, :])
            counter.add(L * w)
            new_trail = 1 + np.maximum(trail, upd)
            counter.add(L * w)
        else:
            raise ValueError(mode)

        a[j:, j + 1 :] = new_trail
        a[j, j] = alpha
        a[j + 1 :, j] = v[1:]
        depth = max(depth, int(new_trail.max()) if new_trail.size else 0)
    depth = max(depth, int(a.max()))
    return DagStats(ops=counter.ops, depth=depth)


def analyze_ht(n: int) -> DagStats:
    """DAG stats for classical HT (paper fig 6) on an n x n matrix."""
    return _analyze(n, "ht")


def analyze_mht(n: int) -> DagStats:
    """DAG stats for MHT (paper fig 8) on an n x n matrix."""
    return _analyze(n, "mht")


# ---------------------------------------------------------------------------
# tiled task-graph parallelism (extends the beta metric to the tile DAG)
# ---------------------------------------------------------------------------

def _qr_column_ops(length: int, trailing: int) -> int:
    """Scalar ops of one Householder column: reflector generation
    (~3L + const for the norm/sqrt/divide chain) plus the fused MHT
    macro update (~4 ops per trailing entry: mul, tree-add share, scale,
    subtract) — the same accounting _analyze tallies node-by-node."""
    return 3 * length + 10 + 4 * length * trailing


def _geqrt_ops(nb: int) -> int:
    return sum(_qr_column_ops(nb - j, nb - 1 - j) for j in range(nb))


def _tsqrt_ops(nb: int) -> int:
    # Structured stacked QR: each column's reflector touches the pivot
    # row of R plus the full nb-tall A block (length nb + 1).
    return sum(_qr_column_ops(nb + 1, nb - 1 - j) for j in range(nb))


def _larfb_ops(nb: int) -> int:
    return 6 * nb**3          # three chained nb x nb GEMMs

def _ssrfb_ops(nb: int) -> int:
    return 6 * nb**3 + 2 * nb**2   # three GEMMs + two tile subtracts


def _tiled_grid_ops(p: int, q: int, tile: int) -> int:
    """Total scalar ops of the flat-tree tile DAG on a p x q grid."""
    ops = 0
    for k in range(min(p, q)):
        ops += _geqrt_ops(tile)
        ops += (q - 1 - k) * _larfb_ops(tile)
        ops += (p - 1 - k) * _tsqrt_ops(tile)
        ops += (p - 1 - k) * (q - 1 - k) * _ssrfb_ops(tile)
    return ops


def analyze_tiled(n: int, tile: int = 16) -> DagStats:
    """DAG stats for the tiled task-graph QR on an n x n matrix.

    The tiled runtime executes *macro operations* (GEQRT / TSQRT / LARFB
    / SSRFB tile tasks) as its DAG nodes — the paper's co-design premise
    realized one level up: each node is a fused tile kernel, and a DAG
    level is one wavefront of the static schedule
    (:func:`repro_torch.core.tilegraph.wavefront_count`).
    ``ops`` tallies the scalar work inside every macro node with the
    same per-column accounting as :func:`analyze_mht`, so beta =
    ops/levels measures how much scalar work each wavefront exposes.
    Tiling multiplies beta: levels collapse from O(n log n) scalar steps
    to p + 2q - 2 wavefronts while total ops stay O(n^3).
    """
    from repro_torch.core.tilegraph import tile_grid, wavefront_count

    p, q = tile_grid(n, n, tile)
    return DagStats(ops=_tiled_grid_ops(p, q, tile),
                    depth=wavefront_count(p, q))


def _merge_ops(n: int) -> int:
    """Scalar ops of one butterfly-merge node: QR of two stacked n x n
    triangles.  Column j touches ~2(j+1) structurally-nonzero rows."""
    return sum(_qr_column_ops(2 * (j + 1), n - 1 - j) for j in range(n))


def analyze_sharded_tiled(n: int, tile: int = 16, ndomains: int = 4
                          ) -> DagStats:
    """DAG stats for the multi-device sharded tiled QR on an n x n matrix.

    The schedule (``core/distgraph.py`` executes it) runs d independent
    row-block domains — each a (p/d x q) flat-tree tile DAG — then a
    binary merge tree of stacked-triangle QR nodes over the per-domain R
    factors.  A level is one cross-device wavefront
    (:func:`repro_torch.core.tilegraph.sharded_wavefront_count`): depth drops
    from p + 2q - 2 to p/d + 2q - 2 + ceil(log2 d) while ops gain only
    the (d - 1) merge nodes, so beta = ops/levels rises with d — the
    paper's more-macro-ops-per-level thesis extended across devices.

    Like the executor, domain counts round down to a power of two and
    cap at the tile-row count; p pads up to d * ceil(p/d).
    """
    from repro_torch.core.tilegraph import (
        sharded_wavefront_count, tile_grid, wavefront_count)

    p, q = tile_grid(n, n, tile)
    d = max(1, min(ndomains, p))
    # round down to a power of two, matching the reference's executor
    d = 1 << (d.bit_length() - 1)
    if d == 1:
        return DagStats(ops=_tiled_grid_ops(p, q, tile),
                        depth=wavefront_count(p, q))
    p_dom = -(-p // d)
    ops = d * _tiled_grid_ops(p_dom, q, tile) + (d - 1) * _merge_ops(n)
    return DagStats(ops=ops, depth=sharded_wavefront_count(p, q, d))


def sharded_curve(sizes: Tuple[int, ...] = (128, 256, 512),
                  tile: int = 16, ndomains: int = 4) -> dict:
    """beta of the sharded schedule vs the single-device tiled DAG per
    matrix size (the multi-device extension of :func:`tiled_curve`)."""
    rows = []
    for n in sizes:
        tl = analyze_tiled(n, tile)
        sh = analyze_sharded_tiled(n, tile, ndomains)
        rows.append(dict(
            n=n, tile=tile, ndomains=ndomains,
            sharded_ops=sh.ops, sharded_levels=sh.depth,
            beta_sharded=sh.beta, beta_tiled=tl.beta,
            beta_gain_sharded=sh.beta / tl.beta,
            level_gain=tl.depth / sh.depth,
        ))
    return {"rows": rows}


def tiled_curve(sizes: Tuple[int, ...] = (64, 128, 256),
                tile: int = 16) -> dict:
    """beta of the tiled task DAG vs MHT per matrix size (bench fig-9
    companion: HT vs MHT vs tiled ops-per-level)."""
    rows = []
    for n in sizes:
        mht = analyze_mht(n)
        tl = analyze_tiled(n, tile)
        rows.append(dict(
            n=n, tile=tile,
            tiled_ops=tl.ops, tiled_levels=tl.depth,
            beta_tiled=tl.beta, beta_mht=mht.beta,
            beta_gain_tiled=tl.beta / mht.beta,
        ))
    return {"rows": rows}


def phase_model_theta(n: int, *, width: int = 4, v_const: int = 9) -> dict:
    """theta under the paper's *width-bound* hardware model (fig 9).

    The paper's RDP executes at most ``width`` (=4, the DOT4) scalar ops
    per level, so every length-L phase of a column costs ~L/width levels
    regardless of tree shape.  Per column of height L, classical HT runs
    FOUR such phases — norm reduction, P materialization (fig 6 shows the
    p_ik nodes explicitly), the P.A dot pass, and the subtract pass —
    while MHT runs THREE (norm, v^T A dot, fused update; the paper's new
    DOT4 configuration merges dot+scale+subtract into one pass).  Hence

        theta(n) = levels_MHT / levels_HT
                 = (3 * sum_L L + c n) / (4 * sum_L L + c n)  ->  3/4,

    matching the paper's reported saturation at 0.749.  ``v_const`` models
    the L-independent sqrt/div chain of the reflector computation.
    """
    tot_ht = 0.0
    tot_mht = 0.0
    for j in range(n - 1):
        L = n - j
        tot_ht += 4.0 * L / width + v_const
        tot_mht += 3.0 * L / width + v_const
    return dict(n=n, levels_ht=tot_ht, levels_mht=tot_mht,
                theta=tot_mht / tot_ht, parallelism_gain=tot_ht / tot_mht)


def theta_curve(sizes: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)) -> dict:
    """theta(n) = levels_MHT / levels_HT, plus beta gain, per matrix size.

    Paper fig 9: theta saturates at ~0.749.  Returns a dict of rows for
    the benchmark harness / EXPERIMENTS.md.
    """
    rows = []
    for n in sizes:
        ht = analyze_ht(n)
        mht = analyze_mht(n)
        pm = phase_model_theta(n)
        rows.append(
            dict(
                n=n,
                ht_ops=ht.ops,
                ht_levels=ht.depth,
                mht_ops=mht.ops,
                mht_levels=mht.depth,
                theta_levels=mht.depth / ht.depth,
                beta_ht=ht.beta,
                beta_mht=mht.beta,
                # Equal-ops accounting (paper eq. 9/10): parallelism gain is
                # the inverse level ratio.
                beta_gain_equal_ops=ht.depth / mht.depth,
                theta_width4=pm["theta"],
                gain_width4=pm["parallelism_gain"],
            )
        )
    return {"rows": rows}

"""The port's DAG analysis (``repro_torch.core.dag``) and the domain
helpers of its tilegraph against the reference's, on the CPU.

Every quantity here is an integer count or a ratio of two: the tests
hold op counts, depths and domain schedules to exact equality with the
reference over the sizes tests/test_dag.py and tests/test_distgraph.py
use, the float curves to equality at fp64 rounding (rel 1e-12), and the
paper's constant theta ~ 0.75 under the width-4 model within 0.02.  The
port's own twins of the reference's property tests follow.
"""

import numpy as np
import pytest

from repro.core import dag as jdag
from repro.core import tilegraph as jtg
from repro_torch.core import dag, engine, tilegraph
from worker_threads import share_the_cores  # noqa: F401  (autouse)

_SIZES = (4, 8, 16, 32)
_TILED = ((64, 16), (128, 16), (256, 16), (256, 32), (2048, 32), (640, 32))
_SHARDED = ((128, 16, 4), (256, 16, 8), (256, 32, 2), (128, 16, 1),
            (128, 16, 3), (96, 32, 16))


@pytest.mark.parametrize("n", _SIZES)
def test_ht_mht_stats_equal_reference(n):
    for mine, ref in ((dag.analyze_ht(n), jdag.analyze_ht(n)),
                      (dag.analyze_mht(n), jdag.analyze_mht(n))):
        assert (mine.ops, mine.depth) == (ref.ops, ref.depth)
        assert mine.beta == ref.beta


@pytest.mark.parametrize("n,tile", _TILED)
def test_tiled_stats_equal_reference(n, tile):
    mine, ref = dag.analyze_tiled(n, tile), jdag.analyze_tiled(n, tile)
    assert (mine.ops, mine.depth) == (ref.ops, ref.depth)


@pytest.mark.parametrize("n,tile,d", _SHARDED)
def test_sharded_stats_equal_reference(n, tile, d):
    mine = dag.analyze_sharded_tiled(n, tile, d)
    ref = jdag.analyze_sharded_tiled(n, tile, d)
    assert (mine.ops, mine.depth) == (ref.ops, ref.depth)


def _close(a, b):
    if isinstance(a, float):
        return abs(a - b) <= 1e-12 * max(1.0, abs(b))
    return a == b


@pytest.mark.parametrize("curve,args", [
    ("theta_curve", ((4, 8, 16, 32),)),
    ("tiled_curve", ((64, 128), 16)),
    ("sharded_curve", ((128, 256), 16, 4)),
])
def test_curves_equal_reference(curve, args):
    mine = getattr(dag, curve)(*args)["rows"]
    ref = getattr(jdag, curve)(*args)["rows"]
    assert [sorted(r) for r in mine] == [sorted(r) for r in ref]
    for a, b in zip(mine, ref):
        assert all(_close(a[k], b[k]) for k in b), (a, b)


@pytest.mark.parametrize("n", (8, 32, 128, 512))
def test_phase_model_equals_reference(n):
    mine, ref = dag.phase_model_theta(n), jdag.phase_model_theta(n)
    assert all(_close(mine[k], ref[k]) for k in ref)


def test_paper_constant_at_width_4():
    """The paper's Fig. 9 constant: theta ~ 0.75 (1.33x the parallelism)
    under the 4-wide model, in both packages alike."""
    mine, ref = dag.phase_model_theta(512), jdag.phase_model_theta(512)
    assert abs(mine["theta"] - 0.75) < 0.02
    assert abs(mine["parallelism_gain"] - 4.0 / 3.0) < 0.04
    assert mine["theta"] == ref["theta"]


# ------------------------------------------------------- domain helpers

@pytest.mark.parametrize("p,d", [(8, 4), (7, 3), (5, 5), (64, 8), (9, 2),
                                 (1, 1)])
def test_domain_rows_equal_reference(p, d):
    assert tilegraph.domain_rows(p, d) == jtg.domain_rows(p, d)


@pytest.mark.parametrize("p,d", [(4, 5), (4, 0)])
def test_domain_rows_rejects_like_reference(p, d):
    for f in (tilegraph.domain_rows, jtg.domain_rows):
        with pytest.raises(ValueError):
            f(p, d)


@pytest.mark.parametrize("p,q,d", [(8, 4, 4), (7, 3, 3), (6, 6, 2)])
def test_domain_wavefronts_equal_reference(p, q, d):
    mine = tilegraph.domain_wavefronts(p, q, d)
    ref = jtg.domain_wavefronts(p, q, d)
    as_tuples = lambda w: [[[(t.kind, t.k, t.i, t.j) for t in lv]  # noqa: E731
                            for lv in dom] for dom in w]
    assert as_tuples(mine) == as_tuples(ref)


def test_merge_levels_and_sharded_count_equal_reference():
    for d in (1, 2, 3, 4, 5, 8, 16):
        assert tilegraph.merge_levels(d) == jtg.merge_levels(d)
    for p in range(1, 13):
        for q in range(1, 9):
            for d in (1, 2, 3, 4, 8):
                assert (tilegraph.sharded_wavefront_count(p, q, d)
                        == jtg.sharded_wavefront_count(p, q, d))
    for f in (tilegraph.merge_levels, jtg.merge_levels):
        with pytest.raises(ValueError):
            f(0)


# ------------------------------------------- the tiled depth the engine runs

@pytest.mark.parametrize("n", (256, 640, 768, 2048))
def test_tiled_depth_is_the_engines_level_count(n):
    """``analyze_tiled(n, 32).depth`` is the number of levels the engine
    dispatches: the wavefront lowering's level batches and the megakernel
    table's levels (190 at 2048^2, 58 at 640^2)."""
    g = n // 32
    depth = dag.analyze_tiled(n, 32).depth
    assert depth == len(engine.wavefront_task_arrays(g, g))
    if g <= 20:
        assert depth == engine.megakernel_task_table(g, g)[1]
    assert {2048: 190, 640: 58}.get(n, depth) == depth


# --------------------------------------------- the reference's properties

def test_mht_shallower_and_fewer_ops():
    for n in _SIZES:
        assert dag.analyze_mht(n).depth < dag.analyze_ht(n).depth
    assert dag.analyze_mht(16).ops < dag.analyze_ht(16).ops


def test_theta_below_one_and_sharded_beta_grows():
    rows = dag.theta_curve((8, 16, 32, 64))["rows"]
    assert all(0.5 < r["theta_levels"] < 1.0 for r in rows)
    assert all(r["beta_gain_equal_ops"] > 1.0 for r in rows)
    for n, tile, d in [(128, 16, 4), (256, 16, 8), (256, 32, 2)]:
        tl = dag.analyze_tiled(n, tile)
        sh = dag.analyze_sharded_tiled(n, tile, d)
        p, q = tilegraph.tile_grid(n, n, tile)
        assert sh.depth == tilegraph.sharded_wavefront_count(p, q, d)
        assert sh.depth < tl.depth and sh.ops > tl.ops and sh.beta > tl.beta
    tl, sh = dag.analyze_tiled(128, 16), dag.analyze_sharded_tiled(128, 16, 1)
    assert (sh.ops, sh.depth) == (tl.ops, tl.depth)
    assert np.isfinite(dag.DagStats(ops=0, depth=0).beta)

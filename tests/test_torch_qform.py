"""Tiled Q formation through the Q task graph, on the CPU.

The engine forms Q's first ncols columns in a (p, qe, nb, nb) workspace E
by the factorization's updates run in reverse (``engine.q_task_arrays``,
``engine.q_megakernel_task_table``): QSSRFB(k, i, j) and QLARFB(k, j),
leveled by the E tiles they touch, with the column tiles j < k skipped.
These tests check the schedule's invariants and replay it through the Q
updates' plain versions — the wavefront lowering's per-level batches and
the megakernel's table walk, which on CPU tensors are what the kernel
wrappers run — holding E against the plain Q loop
(``tilegraph._form_q_tiled``) and the JAX reference's
(``repro.core.tilegraph._form_q_tiled``) on the same factored state,
within ``10 * eps * max(m, n)`` (a tenth of the conformance bar; the
lowerings sum in the same order, so the port's lowerings agree exactly).
The card's kernels are held against these plain versions in
tests/test_torch_cuda.py.
"""

import contextlib
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import tilegraph as jtg
from repro_torch.core import engine as teng
from repro_torch.core import tilegraph as ttg
from repro_torch.kernels import macro_ops as tmo
from worker_threads import share_the_cores  # noqa: F401  (autouse)

# (label, (m, n), nb): square, tall, wide, at grids up to 6 x 6.
CASES = [("square", (48, 48), 8), ("tall", (96, 32), 16),
         ("wide", (40, 96), 16), ("tall8", (48, 24), 8)]
GRIDS = [(1, 1, 1), (3, 3, 3), (6, 4, 4), (6, 4, 6), (4, 6, 4), (6, 6, 6),
         (5, 2, 5)]


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _factored(shape, nb, dtype, seed, batch=None):
    """A seeded matrix (or stack) factored by the port's plain lowering:
    ``(state, p, q)``."""
    m, n = shape
    lead = () if batch is None else (batch,)
    a = np.random.default_rng(seed).standard_normal(lead + (m, n))
    p, q = ttg.tile_grid(m, n, nb)
    pad = np.zeros(lead + (p * nb, q * nb))
    pad[..., :m, :n] = a
    tiles = ttg._split_tiles(torch.from_numpy(pad.astype(dtype)), p, q, nb)
    if batch is None:
        return teng.factor_tiles(tiles, p=p, q=q, nb=nb), p, q
    return teng.factor_tiles_batched(tiles, p=p, q=q, nb=nb), p, q


def _sequential_tasks(p, q, qe):
    """Q formation's tasks in ``_form_q_tiled``'s order, j < k skipped."""
    out = []
    for k in reversed(range(min(p, q))):
        for i in reversed(range(k + 1, p)):
            out += [("QSSRFB", k, i, j) for j in range(k, qe)]
        out += [("QLARFB", k, k, j) for j in range(k, qe)]
    return out


@pytest.mark.parametrize("p,q,qe", GRIDS)
def test_q_schedule_invariants(p, q, qe):
    """Every task once, j >= k; no two tasks of a level write the same E
    tile; along the sequential order every E tile's touches rise in
    level; at most two launches a level; the megakernel table holds the
    same tasks, each level's ahead of its NOOP rows, its kinds the Q ids,
    and fits the table budget at these grids."""
    levels = teng.q_task_arrays(p, q, qe)
    level_of = {}
    for lv, by_kind in enumerate(levels):
        assert set(by_kind) <= set(teng.Q_KINDS)
        written = []
        for kind, idx in by_kind.items():
            for k, i, j in idx.tolist():
                assert j >= k and (kind == "QSSRFB") == (i > k)
                level_of[(kind, k, i, j)] = lv
                written += [(k, j)] + ([(i, j)] if i > k else [])
        assert len(written) == len(set(written))
    seq = _sequential_tasks(p, q, qe)
    assert sorted(level_of) == sorted(seq)
    assert len(seq) == teng.q_task_count(p, q, qe)
    last = {}
    for task in seq:
        kind, k, i, j = task
        for tile in {(k, j), (i, j)}:
            assert level_of[task] > last.get(tile, -1)
            last[tile] = level_of[task]
    counts = teng.q_dispatch_counts(p, q, qe)
    assert sum(counts.values()) <= 2 * len(levels)
    table, nlevels, nslots = teng.q_megakernel_task_table(p, q, qe)
    assert nlevels == len(levels)
    rows = table.reshape(nlevels, nslots, -1)
    ids = {v: k for k, v in tmo.Q_KIND_ID.items()}
    for lv in range(nlevels):
        kinds = rows[lv, :, 0]
        n = int((kinds != tmo.NOOP).sum())
        assert (kinds[n:] == tmo.NOOP).all()
        got = sorted((ids[kd], k, i, j) for kd, k, i, j in rows[lv, :n, :4].tolist())
        want = sorted(t for t, at in level_of.items() if at == lv)
        assert got == want
    assert teng.q_table_fits(p, q, qe, teng.DEFAULT_TABLE_BUDGET)[0]
    teng.check_table(p, q, qe=qe)


def test_q_schedule_at_the_main_paths():
    """640^2 (20 x 20 grid) forms Q in 2,870 tasks, as many as the
    factorization, over 39 levels, and its table fits the 512 KiB budget
    the factorization's does; 2048^2 (64 x 64) in 127 levels, at most two
    launches each (253); the (576, 576) stack's 18 x 18 grid fits too."""
    assert teng.q_task_count(20, 20, 20) == teng.task_count(20, 20) == 2870
    assert len(teng.q_task_arrays(20, 20, 20)) == 39
    fits, nbytes = teng.q_table_fits(20, 20, 20, teng.DEFAULT_TABLE_BUDGET)
    assert fits and nbytes <= teng.DEFAULT_TABLE_BUDGET
    assert teng.q_table_fits(18, 18, 18, teng.DEFAULT_TABLE_BUDGET)[0]
    assert len(teng.q_task_arrays(64, 64, 64)) == 127
    assert sum(teng.q_dispatch_counts(64, 64, 64).values()) == 253
    assert teng.q_dispatch_counts(20, 20, 20, "megakernel") == {"MEGAKERNEL_Q": 1}
    assert teng.q_dispatch_counts(18, 18, 18, "megakernel", 60) == {
        "MEGAKERNEL_Q_BATCHED": 1}


@pytest.mark.parametrize("p,q,qe", GRIDS)
def test_q_levels_share_v_and_t_only_past_the_factored_columns(p, q, qe):
    """A Q level holds two tasks with the same V tile and T (a same-(k, i)
    QSSRFB pair or a same-k QLARFB pair) exactly when Q has more column
    tiles than the factored grid (qe > q: full Q of a tall matrix); the
    megakernel table's reuse columns mark such pairs and nothing else."""
    shared = 0
    for by_kind in teng.q_task_arrays(p, q, qe):
        for idx in by_kind.values():
            keys = [(k, i) for k, i, _ in idx.tolist()]
            shared += len(keys) - len(set(keys))
    assert (shared > 0) == (qe > q)
    table = teng.q_megakernel_task_table(p, q, qe)[0]
    assert int(table[:, teng._COL_REUSE0].sum()) == shared
    assert int(table[:, teng._COL_REUSET].sum()) == shared


def test_q_megakernel_runs_keep_groups():
    """The Q table's runs cover every level's work list once, in order,
    and split a same-(k, i) QSSRFB or same-k QLARFB group only where
    both of its ends lie more than a sixteenth of an even run away, as
    the factorization's runs do (such groups exist only for qe > q)."""
    for (p, q, qe), (batch, grid) in itertools.product(
            ((6, 6, 6), (6, 4, 6), (8, 3, 8)), ((1, 4), (3, 5), (2, 64))):
        table, nlevels, nslots = teng.q_megakernel_task_table(p, q, qe)
        runs = teng.q_megakernel_runs(p, q, qe, batch, grid)
        assert runs.shape == (nlevels, grid, 8)
        for lv in range(nlevels):
            rows = table[lv * nslots:(lv + 1) * nslots]
            n = int((rows[:, 0] != tmo.NOOP).sum())
            starts, ends = runs[lv, :, 0], runs[lv, :, 1]
            assert starts[0] == 0 and ends[-1] == batch * n
            assert (starts[1:] == ends[:-1]).all() and (ends >= starts).all()
            chained = teng._chained(rows[:n])
            slack = batch * n // grid // 16
            for x in starts[1:].tolist():
                t = x % n
                if x >= batch * n or not chained[t]:
                    continue
                g0 = t
                while chained[g0]:
                    g0 -= 1
                g1 = t
                while g1 < n and chained[g1]:
                    g1 += 1
                assert min(t - g0, g1 - t) > slack


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label,shape,nb", CASES, ids=[c[0] for c in CASES])
def test_skipped_columns_are_exact_no_ops(label, shape, nb, dtype):
    """Skipping the column tiles j < k changes nothing: E through the Q
    schedule equals the full loop (every column at every step) bit for
    bit, in both modes."""
    f, p, q = _factored(shape, nb, dtype, seed=3)
    for ncols in (min(p, q) * nb, p * nb):
        full = ttg._form_q_tiled(f, ncols)
        e = teng.run_q_levels(f, teng.q_workspace((), p, ncols // nb, nb,
                                                  f.tiles.dtype, f.tiles.device))
        assert torch.equal(ttg._join_tiles(e), full)


@pytest.mark.parametrize("mode", ["reduced", "full"])
@pytest.mark.parametrize("lowering", ["wavefront", "megakernel"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label,shape,nb", CASES, ids=[c[0] for c in CASES])
def test_q_replay_matches_plain_and_reference(label, shape, nb, dtype,
                                              lowering, mode):
    """The Q schedule replayed through the Q updates' plain versions (the
    lowering's own walk) against the port's plain Q loop and the JAX
    package's, on the same factored state, within 10 eps max(m, n)."""
    m, n = shape
    f, p, q = _factored(shape, nb, dtype, seed=4)
    ncols = min(p, q) * nb if mode == "reduced" else p * nb
    got = ttg._join_tiles(teng.form_q_tiles(f, ncols, dispatch_mode=lowering))
    plain = ttg._form_q_tiled(f, ncols)
    tol = 10 * np.finfo(dtype).eps * max(m, n)
    assert float((got - plain).abs().max()) <= tol
    with _x64(dtype):
        ref = np.asarray(jtg._form_q_tiled(
            jeng.FactorState(*(jax.numpy.asarray(x.numpy()) for x in f)), ncols))
    assert ref.dtype == np.dtype(dtype)
    assert float(np.abs(got.numpy().astype(np.float64) - ref).max()) <= tol


@pytest.mark.parametrize("lowering", ["wavefront", "megakernel"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_q_replay_on_a_stack(dtype, lowering):
    """A 3-slice stack: the batched lowering's Q equals each slice's own
    Q formation bitwise and the JAX package's within 10 eps max(m, n)."""
    nb, shape = 8, (40, 24)
    f, p, q = _factored(shape, nb, dtype, seed=5, batch=3)
    ncols = min(p, q) * nb
    got = teng.form_q_tiles(f, ncols, dispatch_mode=lowering)
    assert got.shape == (3, p, ncols // nb, nb, nb)
    tol = 10 * np.finfo(dtype).eps * max(shape)
    for b in range(3):
        single = teng.FactorState(*(x[b] for x in f))
        assert torch.equal(got[b], teng.form_q_tiles(single, ncols,
                                                     dispatch_mode=lowering))
        with _x64(dtype):
            ref = np.asarray(jtg._form_q_tiled(
                jeng.FactorState(*(jax.numpy.asarray(x.numpy())
                                   for x in single)), ncols))
        assert float(np.abs(ttg._join_tiles(got[b]).numpy() - ref).max()) <= tol


def test_tiled_qr_forms_q_through_the_engine():
    """On the kernel path ``tiled_qr`` forms Q through ``form_q_tiles`` (on
    the CPU the wrappers' plain versions: no launch is counted) and equals
    the plain lowering's Q bit for bit; the plain lowering keeps the
    plain loop."""
    a = torch.from_numpy(np.random.default_rng(6).standard_normal((40, 24)))
    tmo.reset_launch_counts()
    for mode in ("reduced", "full"):
        for dispatch in ("wavefront", "megakernel"):
            qk, rk = ttg.tiled_qr(a, tile=8, mode=mode, use_kernel=True,
                                  dispatch_mode=dispatch)
            qp, rp = ttg.tiled_qr(a, tile=8, mode=mode)
            assert torch.equal(qk, qp) and torch.equal(rk, rp)
    assert not any(tmo.LAUNCHES.values())


def test_q_wrappers_check_their_workspace():
    """The Q wrappers take a (p, qe, nb, nb) E of the state's dtype."""
    f, p, q = _factored((16, 16), 8, "float32", seed=7)
    idx = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="Q workspace"):
        tmo.qlarfb(f.tiles, f.d_t, torch.zeros(p + 1, 2, 8, 8), idx)
    with pytest.raises(ValueError, match="dtype"):
        tmo.qssrfb(f.tiles, f.t_t, torch.zeros(p, 2, 8, 8,
                                               dtype=torch.float64), idx)

"""The port's wavefront engine (``repro_torch.core.engine``) against the
JAX package's (``repro.core.engine``).

The schedule functions are numpy on both sides and must agree integer for
integer.  The factorization state is compared element by element within
a stated tolerance, never bitwise: the two packages sum in different
orders.  Tolerance for a whole (p, q) factorization at tile nb:
``|port - jax| <= 100 * eps * max(p, q) * nb * max(1, max |jax|)``, the
conformance suite's 100 eps max(m, n) scaled to the array's magnitude.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import engine as teng
from repro_torch.core import tilegraph as ttg
from repro.core import tilegraph as jtg
from worker_threads import share_the_cores  # noqa: F401  (autouse)

GRIDS = [(1, 1), (1, 3), (3, 1), (2, 3), (3, 2), (4, 4), (5, 3), (3, 6), (6, 6)]


@pytest.mark.parametrize("p,q", GRIDS)
def test_dag_and_wavefront_arrays_equal_reference(p, q):
    assert ttg.build_tasks(p, q) == [ttg.TileTask(*astuple(t))
                                     for t in jtg.build_tasks(p, q)]
    assert ttg.wavefront_count(p, q) == jtg.wavefront_count(p, q)
    assert len(ttg.wavefronts(p, q)) == ttg.wavefront_count(p, q)
    mine, ref = teng.wavefront_task_arrays(p, q), jeng.wavefront_task_arrays(p, q)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert list(a) == list(b)
        for kind in a:
            assert a[kind].dtype == b[kind].dtype == np.int32
            np.testing.assert_array_equal(a[kind], b[kind])
    assert teng.task_count(p, q) == jeng.task_count(p, q)


def astuple(t):
    return (t.kind, t.k, t.i, t.j)


@pytest.mark.parametrize("p,q", GRIDS)
def test_megakernel_table_equals_reference(p, q):
    tab, nl, ns = teng.megakernel_task_table(p, q)
    rtab, rnl, rns = jeng.megakernel_task_table(p, q)
    assert (nl, ns) == (rnl, rns)
    assert tab.dtype == rtab.dtype
    np.testing.assert_array_equal(tab, rtab)
    for budget in (0, 4096, 512 * 1024):
        assert teng.table_fits(p, q, budget) == jeng.table_fits(p, q, budget)


@pytest.mark.parametrize("nb,itemsize", [(8, 4), (32, 4), (32, 8), (64, 4)])
@pytest.mark.parametrize("p,q", [(2, 3), (4, 4), (6, 6), (3, 6)])
def test_schedule_stats_and_auto_rule_equal_reference(p, q, nb, itemsize):
    for vbudget, tbudget in ((8 << 20, 512 * 1024), (232_448, 512 * 1024),
                             (232_448, 1024), (1024, 512 * 1024)):
        kw = dict(vmem_budget=vbudget, table_budget=tbudget)
        assert teng.schedule_stats(p, q, nb, itemsize, **kw) == \
            jeng.schedule_stats(p, q, nb, itemsize, **kw)
        assert teng.explain_dispatch_mode(p, q, nb, itemsize, **kw)[0] == \
            jeng.explain_dispatch_mode(p, q, nb, itemsize, **kw)[0]
        assert teng.modeled_dma_bytes(p, q, nb, itemsize) == \
            jeng.modeled_dma_bytes(p, q, nb, itemsize)


def test_main_path_schedule_counts():
    """2048^2 at nb = 32: 190 levels, 499 launches (64/63/186/186), and
    the auto rule picks wavefront (the task table is over 512 KiB)."""
    assert teng.dispatch_counts(64, 64) == {
        "GEQRT": 64, "LARFB": 63, "TSQRT": 186, "SSRFB": 186}
    assert len(teng.wavefront_task_arrays(64, 64)) == 190
    mode, why = teng.explain_dispatch_mode(64, 64, 32, 4)
    assert mode == "wavefront" and "table" in why


def _workspace(p, q, nb, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p, q, nb, nb)).astype(dtype)


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _assert_state_close(mine, ref, p, q, nb, dtype):
    eps = np.finfo(dtype).eps
    for name, a, b in zip(teng.FactorState._fields, teng.state_to_numpy(mine), ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        tol = 100 * eps * max(p, q) * nb * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("ref_kernel,dtype", [
    (False, "float32"), (True, "float32"), (False, "float64")],
    ids=["jnp-float32", "pallas-float32", "jnp-float64"])
@pytest.mark.parametrize("p,q", [(1, 1), (2, 3), (3, 2), (3, 3)])
def test_factor_tiles_matches_reference(p, q, ref_kernel, dtype):
    """The port's plain lowering and its wrapper lowering (the plain
    versions on a CPU workspace) against JAX ``factor_tiles`` with the jnp
    oracle and with interpret-mode Pallas ``dispatch_mode="wavefront"``
    (fp64 against the jnp oracle)."""
    nb = 8
    ws = _workspace(p, q, nb, seed=p * 10 + q, dtype=dtype)
    with _x64(dtype):
        ref = jeng.factor_tiles(jnp.asarray(ws), p=p, q=q, nb=nb,
                                use_kernel=ref_kernel,
                                dispatch_mode="wavefront" if ref_kernel else None)
        ref = tuple(np.asarray(x) for x in ref)
    for use_kernel in (False, True):
        tiles = torch.from_numpy(ws.copy())
        st = teng.factor_tiles(tiles, p=p, q=q, nb=nb, use_kernel=use_kernel)
        assert st.tiles is tiles  # in place
        _assert_state_close(st, ref, p, q, nb, dtype)


@pytest.mark.parametrize("stop", [0, 2, 4])
def test_state_carried_across_mid_schedule(stop):
    """JAX runs levels 0..stop, the state crosses as numpy, and the port
    finishes the schedule; the result matches a whole JAX run."""
    p, q, nb = 3, 3, 8
    ws = _workspace(p, q, nb, seed=7)
    r = min(p, q)
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    state = jeng.FactorState(jnp.asarray(ws), z(r, nb, nb), z(r, nb),
                             z(p, r, nb, nb), z(p, r, nb))
    levels = jeng.wavefront_task_arrays(p, q)
    for lv in range(stop + 1):
        state = jeng._jnp_wavefront(state, levels[lv])
    mine = teng.state_from_numpy([np.asarray(x) for x in state], device="cpu")
    teng.run_levels(mine, range(stop + 1, len(levels)))
    full = jeng.factor_tiles(jnp.asarray(ws), p=p, q=q, nb=nb)
    _assert_state_close(mine, [np.asarray(x) for x in full], p, q, nb, "float32")


def test_dispatch_guards():
    """A forced megakernel runs (on a CPU workspace: its plain walk, one
    task at a time) and agrees with the wavefront plain lowering; one
    whose task table exceeds the 512 KiB budget raises ValueError, as the
    reference does."""
    ws = torch.from_numpy(_workspace(2, 2, 8, seed=11))
    mega = teng.factor_tiles(ws.clone(), p=2, q=2, nb=8, use_kernel=True,
                             dispatch_mode="megakernel")
    wave = teng.factor_tiles(ws.clone(), p=2, q=2, nb=8)
    _assert_state_close(mega, teng.state_to_numpy(wave), 2, 2, 8, "float32")
    assert not teng.table_fits(24, 24, teng.DEFAULT_TABLE_BUDGET)[0]
    with pytest.raises(ValueError, match="task table"):
        teng.factor_tiles(torch.zeros(24, 24, 1, 1), p=24, q=24, nb=1,
                          use_kernel=True, dispatch_mode="megakernel")
    ws = torch.zeros(2, 2, 8, 8)
    with pytest.raises(ValueError, match="dispatch_mode"):
        teng.factor_tiles(ws, p=2, q=2, nb=8, dispatch_mode="bogus")
    with pytest.raises(TypeError, match="float32 or float64"):
        teng.factor_tiles(ws.half(), p=2, q=2, nb=8, use_kernel=True)
    with pytest.raises(ValueError, match="shared-memory budget"):
        teng.factor_tiles(torch.zeros(1, 1, 128, 128), p=1, q=1, nb=128,
                          use_kernel=True)
    with pytest.raises(ValueError, match="workspace"):
        teng.factor_tiles(ws, p=2, q=3, nb=8)


def test_state_numpy_round_trip():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in [(2, 3, 4, 4), (2, 4, 4), (2, 4), (2, 2, 4, 4), (2, 2, 4)]]
    st = teng.state_from_numpy(arrays, device="cpu")
    for a, b in zip(teng.state_to_numpy(st), arrays):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p,q", [(3, 2), (4, 4), (2, 5)])
def test_plain_lowering_of_a_stack_equals_slice_by_slice(p, q, dtype):
    """The plain lowering runs each level's task batches over all slices
    of a stack at once; each slice's state equals ``factor_tiles`` on it
    bit for bit, and slices past ``filled`` stay the zero state."""
    nb, batch = 8, 4
    ws = np.random.default_rng(p * 10 + q).standard_normal(
        (batch, p, q, nb, nb)).astype(dtype)
    ws[-1] = 0.0
    st = teng.factor_tiles_batched(torch.from_numpy(ws.copy()), p=p, q=q,
                                   nb=nb, filled=batch - 1)
    for b in range(batch - 1):
        one = teng.factor_tiles(torch.from_numpy(ws[b].copy()), p=p, q=q,
                                nb=nb)
        assert all(torch.equal(x[b], y) for x, y in zip(st, one))
    assert all(not x[-1].any() for x in st)

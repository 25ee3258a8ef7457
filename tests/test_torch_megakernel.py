"""The port's megakernel, batched engine and batched ``qr`` against the JAX
package.

Inputs are numpy arrays from fixed seeds; fp64 runs under the scoped
``jax.enable_x64(True)``.  The factorization state is held to the
tolerance tests/test_torch_engine.py states: ``|port - jax| <= 100 * eps
* max(p, q) * nb * max(1, max |jax|)``.  On the CPU the megakernel
wrappers run their plain walks (the table's rows in order, one task at a
time); tests/test_torch_cuda.py holds the kernels against those walks
on a Hopper card.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import engine as jeng
from repro.core import tilegraph as jtg
from repro_torch.core import engine as teng
from repro_torch.core import tilegraph as ttg
from repro_torch.kernels import macro_ops as tmo
from worker_threads import share_the_cores  # noqa: F401  (autouse)

tplan = importlib.import_module("repro_torch.core.plan")

NB = 8


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _workspace(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ragged(ws):
    """Odd slices of a stack hold a matrix nb/2 rows and columns short of
    the grid, zero-padded (tests/test_conformance.py's bucket padding)."""
    h = ws.shape[-1] // 2
    ws[1::2, -1, :, h:, :] = 0
    ws[1::2, :, -1, :, h:] = 0
    return ws


def _assert_close(mine, ref, p, q, nb, dtype):
    eps = np.finfo(dtype).eps
    for name, a, b in zip(teng.FactorState._fields, mine, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        tol = 100 * eps * max(p, q) * nb * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p,q", [(1, 1), (2, 4), (4, 4), (5, 2)])
def test_megakernel_plain_matches_reference(p, q, dtype):
    """The plain walk, directly and through ``factor_tiles``'s forced
    megakernel on a CPU workspace, against the reference's interpret-mode
    megakernel, on all five state arrays.  In fp64 the reference's
    megakernel does not trace on this jax (its ``lax.rem`` of an int32
    table index by an int64 step), so fp64 is held against its jnp oracle,
    which the reference asserts equal to its megakernel bit for bit."""
    ws = _workspace((p, q, NB, NB), seed=10 * p + q, dtype=dtype)
    with _x64(dtype):
        ref = jeng.factor_tiles(jnp.asarray(ws), p=p, q=q, nb=NB,
                                use_kernel=dtype == "float32",
                                dispatch_mode="megakernel", interpret=True)
        ref = [np.asarray(x) for x in ref]
    walked = teng.init_state(torch.from_numpy(ws.copy()))
    tmo.megakernel_plain(walked, *teng.megakernel_table(p, q, "cpu"))
    _assert_close(teng.state_to_numpy(walked), ref, p, q, NB, dtype)
    tiles = torch.from_numpy(ws.copy())
    st = teng.factor_tiles(tiles, p=p, q=q, nb=NB, use_kernel=True,
                           dispatch_mode="megakernel")
    assert st.tiles is tiles  # in place
    _assert_close(teng.state_to_numpy(st), ref, p, q, NB, dtype)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("p,q", [(3, 3), (3, 2), (2, 3)],
                         ids=["square", "tall", "wide"])
def test_factor_tiles_batched_matches_reference(p, q, batch, use_kernel):
    """``factor_tiles_batched`` (the batched megakernel's plain walk with
    ``use_kernel``, else the plain lowering slice by slice) against the
    reference's batched megakernel in interpret mode, with ragged slices;
    each slice equals the port's single factorization of it exactly."""
    ws = _ragged(_workspace((batch, p, q, NB, NB), seed=p * 7 + q,
                            dtype="float32"))
    ref = jeng.factor_tiles_batched(jnp.asarray(ws), p=p, q=q, nb=NB,
                                    use_kernel=True,
                                    dispatch_mode="megakernel",
                                    interpret=True)
    ref = [np.asarray(x) for x in ref]
    mode = "megakernel" if use_kernel else None
    tiles = torch.from_numpy(ws.copy())
    st = teng.factor_tiles_batched(tiles, p=p, q=q, nb=NB,
                                   use_kernel=use_kernel, dispatch_mode=mode)
    assert st.tiles is tiles  # in place
    _assert_close(teng.state_to_numpy(st), ref, p, q, NB, "float32")
    for b in range(batch):
        single = teng.factor_tiles(torch.from_numpy(ws[b].copy()), p=p, q=q,
                                   nb=NB, use_kernel=use_kernel,
                                   dispatch_mode=mode)
        for x, y in zip(st, single):
            assert torch.equal(x[b], y)
    if batch > 1:
        walked = teng.init_state(torch.from_numpy(ws.copy()))
        tmo.megakernel_batched_plain(walked, *teng.megakernel_table(p, q, "cpu"))
        _assert_close(teng.state_to_numpy(walked), ref, p, q, NB, "float32")


@pytest.mark.parametrize("mode", ["reduced", "r", "full"])
@pytest.mark.parametrize("ref_kernel", [False, True], ids=["jnp", "megakernel"])
def test_tiled_qr_batched_matches_reference(mode, ref_kernel):
    """``tiled_qr_batched`` on a (3, 70, 50) stack at tile 16 (padded to
    a 5 x 4 grid) against the reference's, with its jnp oracle and with
    its interpret-mode batched megakernel; the port runs its plain
    lowering and its megakernel's plain walk.  Tolerance: a tenth of the
    conformance bar, 10 * eps * max(m, n) * max(1, max |jax|)."""
    a = _workspace((3, 70, 50), seed=12, dtype="float32")
    kw = dict(use_kernel=True, dispatch_mode="megakernel") if ref_kernel \
        else {}
    ref = jtg.tiled_qr_batched(jnp.asarray(a), tile=16, mode=mode, **kw)
    ref = [np.asarray(ref)] if mode == "r" else [np.asarray(x) for x in ref]
    mine = ttg.tiled_qr_batched(torch.from_numpy(a), tile=16, mode=mode, **kw)
    mine = [mine] if mode == "r" else list(mine)
    assert len(mine) == len(ref)
    tol = 10 * float(np.finfo(np.float32).eps) * 70
    for x, y in zip(mine, ref):
        assert tuple(x.shape) == y.shape
        assert float(np.abs(x.numpy() - y).max()) <= tol * max(1.0, np.abs(y).max())


def test_qr_on_a_stack_is_one_batched_engine_call(monkeypatch):
    """``repro_torch.qr`` and ``orthogonalize`` on a (2, 3, 40, 24) input
    hand all six matrices to one ``factor_tiles_batched`` call; every
    slice equals ``qr`` of that matrix alone."""
    calls = []
    real = teng.factor_tiles_batched

    def counting(tiles, **kw):
        calls.append(tuple(tiles.shape))
        return real(tiles, **kw)

    monkeypatch.setattr(teng, "factor_tiles_batched", counting)
    a = _workspace((2, 3, 40, 24), seed=4, dtype="float32")
    cfg = tplan.QRConfig(method="tiled", block=8)
    q, r = repro_torch.qr(a, config=cfg, device="cpu")
    assert calls == [(6, 5, 3, 8, 8)]
    assert q.shape == (2, 3, 40, 24) and r.shape == (2, 3, 24, 24)
    for i in range(2):
        for j in range(3):
            q1, r1 = repro_torch.qr(a[i, j], config=cfg, device="cpu")
            assert torch.equal(q[i, j], q1) and torch.equal(r[i, j], r1)
    calls.clear()
    wide = np.swapaxes(a, -1, -2)
    o = repro_torch.orthogonalize(wide, config=cfg, device="cpu")
    assert len(calls) == 1 and o.shape == wide.shape
    eye = np.eye(24)
    for x in o.numpy().reshape(6, 24, 40):
        assert np.abs(x @ x.T - eye).max() <= 100 * np.finfo(np.float32).eps * 40


@pytest.mark.parametrize("q_method,sign_fix", [("formq", True), ("solve", False)])
def test_solve_batched_modes_match_single(q_method, sign_fix):
    """``sign_fix`` and ``q_method="solve"`` on a stack: each slice equals
    the single solve of it."""
    a = _workspace((3, 48, 32), seed=9, dtype="float32")
    cfg = tplan.QRConfig(method="tiled", block=8, q_method=q_method,
                         sign_fix=sign_fix)
    q, r = repro_torch.qr(a, config=cfg, device="cpu")
    for b in range(3):
        q1, r1 = repro_torch.qr(a[b], config=cfg, device="cpu")
        assert torch.allclose(q[b], q1, atol=1e-6) and torch.equal(r[b], r1)
    if sign_fix:
        assert bool((torch.diagonal(r, dim1=-2, dim2=-1) >= 0).all())


def test_dispatch_counts_and_batched_guards():
    """One launch per megakernel call, one schedule's per-kind wavefront
    launches on a stack of any size; the batched entry point's shape
    checks."""
    assert teng.dispatch_counts(20, 20, "megakernel") == {"MEGAKERNEL": 1}
    assert teng.dispatch_counts(18, 18, "megakernel", 60) == {
        "MEGAKERNEL_BATCHED": 1}
    assert sum(teng.dispatch_counts(20, 20).values()) == 147
    assert teng.dispatch_counts(18, 18, batch=60) == \
        teng.dispatch_counts(18, 18)
    assert teng.schedule_stats(20, 20)["megakernel"]["dispatches"] == 1
    with pytest.raises(ValueError, match="stacked workspace"):
        teng.factor_tiles_batched(torch.zeros(0, 2, 2, 4, 4), p=2, q=2, nb=4)
    with pytest.raises(ValueError, match="workspace"):
        teng.factor_tiles_batched(torch.zeros(2, 2, 2, 4, 4), p=2, q=3, nb=4)
    with pytest.raises(ValueError, match="task table"):
        teng.factor_tiles_batched(torch.zeros(2, 24, 24, 1, 1), p=24, q=24,
                                  nb=1, use_kernel=True,
                                  dispatch_mode="megakernel")


@pytest.mark.parametrize("p,q,qe", [(18, 18, 18), (5, 3, 5), (3, 5, 3)])
def test_stacked_dispatch_counts_are_one_schedules(p, q, qe):
    """A stack of any size takes one schedule's wavefront launches, to
    factor and to form Q: each launch runs its batch on every slice."""
    for batch in (2, 7, 360):
        assert teng.dispatch_counts(p, q, batch=batch) == \
            teng.dispatch_counts(p, q)
        assert teng.q_dispatch_counts(p, q, qe, batch=batch) == \
            teng.q_dispatch_counts(p, q, qe)


@pytest.mark.parametrize("kind", ["GEQRT", "LARFB", "TSQRT", "SSRFB",
                                  "QLARFB", "QSSRFB"])
def test_wrappers_take_a_stacked_state(kind):
    """Each workspace wrapper takes a (B, p, q, nb, nb) stack with (B, ...)
    state fields and E: on the CPU its plain version runs the batch on
    every slice at once, each slice equal bit for bit to the wrapper on
    that slice alone, and no launch is counted; a field without the
    stack's leading B is refused."""
    p, q, batch = 3, 2, 3
    r = min(p, q)
    rng = np.random.default_rng(70)
    shapes = [(batch, p, q, NB, NB), (batch, r, NB, NB), (batch, r, NB),
              (batch, p, r, NB, NB), (batch, p, r, NB)]
    state = teng.FactorState(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for s in shapes))
    e = torch.from_numpy(rng.standard_normal(
        (batch, p, q, NB, NB)).astype(np.float32))
    levels = (teng.q_task_arrays(p, q, q) if kind in tmo.Q_OPS
              else teng.wavefront_task_arrays(p, q))
    idx = torch.from_numpy(max((lv[kind] for lv in levels if kind in lv),
                               key=len))

    def run(st, e_):
        if kind in tmo.Q_OPS:
            tmo.run_q_batch(kind, st, e_, idx, use_kernel=True)
        else:
            tmo.run_batch(kind, st, idx, use_kernel=True)

    stacked = teng.FactorState(*(x.clone() for x in state))
    e_stacked = e.clone()
    tmo.reset_launch_counts()
    run(stacked, e_stacked)
    assert not any(tmo.LAUNCHES.values())
    for b in range(batch):
        alone = teng.FactorState(*(x[b].clone() for x in state))
        e_alone = e[b].clone()
        run(alone, e_alone)
        for x, y in zip(stacked, alone):
            assert torch.equal(x[b], y)
        assert torch.equal(e_stacked[b], e_alone)
    with pytest.raises(ValueError, match="must be"):
        run(teng.FactorState(stacked.tiles, *(x[0] for x in stacked[1:])),
            e_stacked)
    if kind in tmo.Q_OPS:
        with pytest.raises(ValueError, match="Q workspace"):
            run(stacked, e_stacked[0])


def test_stacked_wavefront_counts_its_filled_slices():
    """The wavefront kernel lowering on a padded (5, 3, 2) stack filled to
    3: one stacked call each to factor and to form Q, each adding 3 to
    ``engine.stacked_wavefront_slices`` and one schedule to
    ``engine.dispatches``; the filled slices equal their single runs bit
    for bit, the rest stay the zero state and the identity Q.  The plain
    lowering, the megakernel and a stack of one add nothing."""
    from repro_torch.observability import metrics

    p, q, batch, filled = 3, 2, 5, 3
    ws = _workspace((batch, p, q, NB, NB), seed=71, dtype="float32")
    ws[filled:] = 0
    kw = dict(p=p, q=q, nb=NB, use_kernel=True, dispatch_mode="wavefront")

    def slices(stage):
        return metrics.counter_value("engine.stacked_wavefront_slices",
                                     stage=stage)

    metrics.reset()
    f = teng.factor_tiles_batched(torch.from_numpy(ws.copy()), filled=filled,
                                  **kw)
    e = teng.form_q_tiles(f, p * NB, dispatch_mode="wavefront", filled=filled)
    assert (slices("factor"), slices("q")) == (filled, filled)
    assert metrics.counter_value("engine.dispatches", mode="wavefront",
                                 phase="execute") == \
        sum(teng.dispatch_counts(p, q).values())
    zero = teng.init_state(torch.zeros(p, q, NB, NB))
    eye = teng.q_workspace((), p, p, NB, torch.float32, torch.device("cpu"))
    for b in range(batch):
        if b < filled:
            single = teng.factor_tiles(torch.from_numpy(ws[b].copy()), **kw)
            e_single = teng.form_q_tiles(single, p * NB,
                                         dispatch_mode="wavefront")
        else:
            single, e_single = zero, eye
        for x, y in zip(f, single):
            assert torch.equal(x[b], y)
        assert torch.equal(e[b], e_single)
    teng.factor_tiles_batched(torch.from_numpy(ws.copy()), **kw)
    assert slices("factor") == filled + batch
    metrics.reset()
    teng.factor_tiles_batched(torch.from_numpy(ws.copy()), p=p, q=q, nb=NB)
    teng.factor_tiles_batched(torch.from_numpy(ws[:1].copy()), **kw)
    teng.factor_tiles_batched(torch.from_numpy(ws.copy()), p=p, q=q, nb=NB,
                              use_kernel=True, dispatch_mode="megakernel")
    assert (slices("factor"), slices("q")) == (0, 0)


def test_megakernel_table_upload_and_wrapper_checks():
    """The device table is the reference's table; the wrappers refuse a
    table of the wrong shape or dtype, and on a CPU state run the plain
    walk without counting a launch."""
    table, nlevels, nslots = teng.megakernel_table(3, 2, "cpu")
    np.testing.assert_array_equal(table.numpy(),
                                  jeng.megakernel_task_table(3, 2)[0])
    assert (nlevels, nslots) == jeng.megakernel_task_table(3, 2)[1:]
    st = teng.init_state(torch.zeros(3, 2, 4, 4))
    with pytest.raises(ValueError, match="table"):
        tmo.megakernel(st, table.long(), nlevels, nslots)
    with pytest.raises(ValueError, match="table"):
        tmo.megakernel(st, table[:-1], nlevels, nslots)
    stacked = teng.init_state(torch.zeros(2, 3, 2, 4, 4))
    with pytest.raises(ValueError, match="workspace"):
        tmo.megakernel_batched(st, table, nlevels, nslots)
    tmo.reset_launch_counts()
    tmo.megakernel_batched(stacked, table, nlevels, nslots)
    tmo.megakernel(st, table, nlevels, nslots)
    assert tmo.LAUNCHES["MEGAKERNEL"] == tmo.LAUNCHES["MEGAKERNEL_BATCHED"] == 0


def test_launch_shared_memory_is_the_largest_body():
    """The megakernel's launch takes four operand slots (two buffers each
    wherever they fit the budget, else one) of nb rows at the update
    bodies' padded pitch and the largest body's compute scratch (GEQRT's
    and TSQRT's, or the updates' two padded tiles); it holds every
    wavefront kernel's carve-up; the auto rule keeps the reference's
    15-tile model."""
    for nb, itemsize in ((8, 4), (32, 4), (32, 8), (64, 4), (64, 8)):
        stages = tmo.megakernel_stages(nb, itemsize)
        need = tmo.megakernel_launch_smem_bytes(nb, itemsize)
        pitch = tmo.operand_pitch(nb, itemsize)
        assert need == (4 * stages * nb * pitch
                        + max(2 * nb * nb + 2 * nb + tmo.XCH_ELEMS,
                              2 * nb * pitch)) * itemsize
        assert need <= teng.DEFAULT_SMEM_BUDGET
        assert need >= max(tmo.smem_bytes(k, nb, itemsize)
                           for k in tmo.MACRO_OPS)
    assert [tmo.megakernel_stages(nb, size) for nb, size in
            ((16, 8), (32, 4), (32, 8), (64, 4), (64, 8))] == [2, 2, 2, 2, 1]
    assert tmo.megakernel_smem_bytes(32) == 15 * 32 * 32 * 4
    cfg = tplan.QRConfig(method="tiled", dispatch_mode="megakernel")
    assert ttg._smem_tiled(640, 640, cfg) == tmo.megakernel_launch_smem_bytes(32)

"""The port's panel path against the JAX package: the ``mht_panel`` and
``wy_trailing`` wrappers (on the CPU: their kernels' plain versions)
against the reference's kernels in interpret mode, the oracles of
``kernels/ref.py``, and ``qr`` / ``orthogonalize`` / ``lstsq`` through
every newly ported method with ``device="cpu"``, the planner's routes and
the ``factor`` entry point.

Inputs are made with numpy from fixed seeds and handed to both packages;
float64 cases enable x64 on the JAX side with the scoped
``jax.enable_x64(True)``.

Tolerances: one panel or one trailing update sums m terms per entry and
carries each column's rounding into the next: ``4 * eps * m *
max(1, max |jax|)``.  A whole QR is held to ``10 * eps * max(m, n) *
max(1, max |jax|)`` (a tenth of the conformance bar) and to the bar
itself, ``100 * eps * max(m, n)`` (tests/test_conformance.py).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import mht as jmht
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro_torch
from repro_torch.core import blocked as tbl
from repro_torch.core import mht as tmht
from repro_torch.kernels import macro_ops as tmo
from repro_torch.kernels import mht_panel as tpanel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from worker_threads import share_the_cores  # noqa: F401  (autouse)

jplan = importlib.import_module("repro.core.plan")
tplan = importlib.import_module("repro_torch.core.plan")

DTYPES = ("float32", "float64")
BLOCK = 8


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _matrix(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _conformance(a, q, r, dtype):
    a64, q64, r64 = (np.asarray(x, np.float64) for x in (a, q, r))
    m, n = a64.shape[-2:]
    bar = 100 * _eps(dtype) * max(m, n)
    k = q64.shape[-1]
    assert np.abs(q64.swapaxes(-1, -2) @ q64 - np.eye(k)).max() <= bar
    assert (np.linalg.norm(a64 - q64 @ r64, axis=(-2, -1))
            / np.linalg.norm(a64, axis=(-2, -1))).max() <= bar


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,row0", [((24, 8), 0), ((24, 8), 5),
                                        ((40, 16), 16)], ids=str)
def test_mht_panel_matches_reference_kernel(shape, row0, dtype):
    """``ops.mht_panel`` (the plain version on the CPU) against the
    reference's Pallas kernel in interpret mode: packed and taus; a stack
    of two panels is the two panels."""
    a = _matrix(shape, row0 + shape[0], dtype)
    with _x64(dtype):
        jp, jt = (np.asarray(x) for x in jops.mht_panel(
            jnp.asarray(a), row0=row0, interpret=True))
    tp, tt = tops.mht_panel(torch.from_numpy(a), row0=row0)
    tol = 4 * _eps(dtype) * shape[0]
    _close(tp.numpy(), jp, tol)
    _close(tt.numpy(), jt, tol)
    assert np.array_equal(tp.numpy()[:row0], a[:row0])
    sp, st = tops.mht_panel(torch.from_numpy(np.stack([a, 2 * a])), row0=row0)
    torch.testing.assert_close(sp[0], tp, rtol=0, atol=0)
    torch.testing.assert_close(st[0], tt, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 20])
def test_wy_trailing_matches_reference_kernel(n, dtype):
    """``ops.wy_trailing`` against the reference's Pallas kernel in
    interpret mode, and against the oracle; in place on a column view."""
    a = _matrix((30, 6), n, dtype)
    packed, taus = tbl.panel_factor(torch.from_numpy(a), 0)
    v = tbl.unpack_v_panel(packed, 0)
    t = tbl.larft(v, taus)
    c = _matrix((30, n), 1, dtype)
    with _x64(dtype):
        want = np.asarray(jops.wy_trailing(
            jnp.asarray(v.numpy()), jnp.asarray(t.numpy()), jnp.asarray(c),
            interpret=True))
    tol = 4 * _eps(dtype) * 30
    _close(tops.wy_trailing(v, t, torch.from_numpy(c)).numpy(), want, tol)
    whole = torch.from_numpy(np.concatenate([a, c], axis=1))
    tops.wy_trailing_(v, t, whole[:, 6:])
    _close(whole[:, 6:].numpy(), want, tol)
    assert np.array_equal(whole[:, :6].numpy(), a)


def test_oracles_match_reference_oracles():
    """``kernels/ref.py`` against the reference's oracles (all float32,
    whatever the input type, as the reference's)."""
    rng = np.random.default_rng(8)
    panel = rng.standard_normal((20, 6)).astype(np.float32)
    r_t = np.triu(rng.standard_normal((8, 8))).astype(np.float32)
    a_t, ck, ci, t2 = (rng.standard_normal((8, 8)).astype(np.float32)
                       for _ in range(4))
    v = np.asarray(tbl.unpack_v_panel(tbl.panel_factor(
        torch.from_numpy(panel), 0)[0], 0))
    c = rng.standard_normal((20, 5)).astype(np.float32)
    t = rng.standard_normal((6, 6)).astype(np.float32)
    tau = np.asarray(0.4, np.float32)
    pairs = [
        (jref.mht_panel_ref(jnp.asarray(panel), 2), tref.mht_panel_ref(
            torch.from_numpy(panel), 2)),
        (jref.wy_trailing_ref(*map(jnp.asarray, (v, t, c))),
         tref.wy_trailing_ref(*map(torch.from_numpy, (v, t, c)))),
        (jref.tsqrt_ref(*map(jnp.asarray, (r_t, a_t))),
         tref.tsqrt_ref(*map(torch.from_numpy, (r_t, a_t)))),
        (jref.ssrfb_ref(*map(jnp.asarray, (a_t, t2, ck, ci))),
         tref.ssrfb_ref(*map(torch.from_numpy, (a_t, t2, ck, ci)))),
        (jref.ht_update_two_pass_ref(*map(jnp.asarray, (c, v[:, 0], tau))),
         tref.ht_update_two_pass_ref(*map(torch.from_numpy,
                                          (c, v[:, 0], tau)))),
    ]
    for want, got in pairs:
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, g in zip(want, got):
            _close(g.numpy(), np.asarray(w), 4 * _eps("float32") * 20)
    p64 = tref.mht_panel_ref(torch.from_numpy(panel.astype(np.float64)), 0)
    assert p64[0].dtype == torch.float64


def test_wide_panel_gives_min_m_n_taus():
    """The reference's kernel path returns b taus for a wide panel (20 for
    8 x 20, so its form_q fails); the port's gives min(m, n) = 8 and
    equals the reference's jnp ``geqr2_ht``, through the kernel path (on
    the CPU: the kernels' plain versions) and ``qr``."""
    a = _matrix((8, 20), 12, "float32")
    jp, jt = (np.asarray(x) for x in jmht.geqr2_ht(jnp.asarray(a)))
    assert jops.mht_panel(jnp.asarray(a), interpret=True)[1].shape == (20,)
    cfg = tplan.QRConfig(use_kernel=True)
    packed, taus = tplan.plan(a.shape, torch.float32, cfg,
                              backend="cpu").factor(torch.from_numpy(a))
    assert taus.shape == (8,) and tops.mht_panel(torch.from_numpy(a))[1].shape == (8,)
    tol = 10 * _eps("float32") * 20
    _close(packed.numpy(), jp, tol)
    _close(taus.numpy(), jt, tol)
    q, r = repro_torch.qr(a, config=cfg, device="cpu")
    assert q.shape == (8, 8) and r.shape == (8, 20)
    _conformance(a, q, r, "float32")


_METHODS = [("geqr2", False), ("geqr2_ht", False), ("geqr2_ht", True),
            ("geqrf", False), ("geqrf_ht", False), ("geqrf_ht", True),
            ("geqrf_fori", False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["reduced", "r", "full"])
@pytest.mark.parametrize("method,use_kernel", _METHODS,
                         ids=[f"{m}-{'kernel' if k else 'plain'}"
                              for m, k in _METHODS])
def test_qr_methods_match_reference(method, use_kernel, mode, dtype):
    """``qr`` through each newly ported method (the kernel path on the CPU
    runs the kernels' plain versions; Q forms by WY panels) against the
    reference's jnp realization, every mode, and the conformance bar."""
    m, n = 40, 24
    a = _matrix((m, n), 3, dtype)
    cfg = tplan.QRConfig(method=method, block=BLOCK, mode=mode,
                         use_kernel=use_kernel)
    jcfg = jplan.QRConfig(method=method, block=BLOCK, mode=mode,
                          use_kernel=False)
    with _x64(dtype):
        want = japi.qr(jnp.asarray(a), config=jcfg)
        want = tuple(np.asarray(x) for x in (want if isinstance(want, tuple)
                                              else (want,)))
    got = repro_torch.qr(a, config=cfg, device="cpu")
    got = got if isinstance(got, tuple) else (got,)
    tol = 10 * _eps(dtype) * max(m, n)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g.numpy(), w, tol)
    if mode != "r":
        _conformance(a, *got, dtype)


@pytest.mark.parametrize("method", ["geqrf_ht", "geqr2_ht", "tsqr"])
def test_orthogonalize_lstsq_and_factor_match_reference(method):
    """orthogonalize (sign-fixed Q), lstsq (Q^T b through the packed
    factor where the method has one) and ``QRSolver.factor``."""
    m, n = 64, 12
    a = _matrix((m, n), 21, "float32")
    b = _matrix((m, 2), 22, "float32")
    cfg = tplan.QRConfig(method=method, block=BLOCK)
    jcfg = jplan.QRConfig(method=method, block=BLOCK)
    tol = 10 * _eps("float32") * m
    o = repro_torch.orthogonalize(a, config=cfg, device="cpu")
    _close(o.numpy(), np.asarray(japi.orthogonalize(jnp.asarray(a), config=jcfg)),
           tol)
    x = repro_torch.lstsq(a, b, config=cfg, device="cpu")
    jx = np.asarray(japi.lstsq(jnp.asarray(a), jnp.asarray(b), config=jcfg))
    _close(x.numpy(), jx, tol)
    x_k = repro_torch.lstsq(a, b[:, 0], config=cfg.replace(use_kernel=True),
                            device="cpu")
    _close(x_k.numpy(), jx[:, 0], tol)
    solver = tplan.plan(a.shape, torch.float32, cfg, backend="cpu")
    if method == "tsqr":
        with pytest.raises(ValueError, match="packed factored form"):
            solver.factor(torch.from_numpy(a))
        return
    jp, jt = jplan.plan(a.shape, jnp.float32, jcfg).factor(jnp.asarray(a))
    packed, taus = solver.factor(torch.from_numpy(a))
    _close(packed.numpy(), np.asarray(jp), tol)
    _close(taus.numpy(), np.asarray(jt), tol)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", ["geqrf_ht", "geqr2_ht", "tsqr"])
def test_stack_through_solve_batched_equals_per_slice(method, use_kernel):
    """A (3, 96, 40) stack (tsqr: (3, 96, 20)) is one call of the method
    — on the card one launch per panel step for the whole stack — and
    equals the per-slice runs, in every mode the method has, with
    ``q_method="solve"`` and ``sign_fix`` too."""
    shape = (3, 96, 20) if method == "tsqr" else (3, 96, 40)
    a = torch.from_numpy(_matrix(shape, 30, "float64"))
    modes = ("reduced", "r") if method == "tsqr" else ("reduced", "r", "full")
    for mode in modes:
        for extra in ({}, dict(q_method="solve", sign_fix=True)):
            cfg = tplan.QRConfig(method=method, block=BLOCK, mode=mode,
                                 use_kernel=use_kernel, **extra)
            out = repro_torch.qr(a, config=cfg, device="cpu")
            out = out if isinstance(out, tuple) else (out,)
            for i in range(3):
                one = repro_torch.qr(a[i], config=cfg, device="cpu")
                one = one if isinstance(one, tuple) else (one,)
                for x, y in zip(out, one):
                    torch.testing.assert_close(x[i], y, rtol=0, atol=1e-12)
    factor = tplan.plan(shape, torch.float64, tplan.QRConfig(
        method="geqrf_ht", block=BLOCK, use_kernel=use_kernel),
        backend="cpu").factor
    packed, taus = factor(a)
    assert packed.shape == shape and taus.shape == (3, shape[-1])
    torch.testing.assert_close(packed[1], factor(a[1])[0], rtol=0, atol=1e-12)


# Shapes the auto route sends off the tiled path, planned for the card.
_ROUTES = [((200, 200), "blocked_default", "geqrf_ht"),
           ((16, 1000), "single_panel", "geqr2_ht"),
           ((4096, 4096), "blocked_default", "geqrf_ht"),
           ((60, 576, 192), "blocked_default", "geqrf_ht"),
           ((49152, 576), "tsqr_tall_skinny", "tsqr")]


@pytest.mark.parametrize("shape,slug,method", _ROUTES, ids=str)
def test_panel_routes_match_reference(shape, slug, method):
    """The port planned for "cuda" takes the reference's route (planned
    for a non-TPU accelerator, "gpu", which shares the 256 tiled floor):
    the same method and decision trail, and on the card the kernels,
    whose estimated per-CTA shared memory fits the budget (plan only)."""
    cfg = tplan.QRConfig(use_tuning_cache=False)
    mine = tplan.plan(shape, torch.float32, cfg, backend="cuda",
                      ndevices=1, explain=True)
    ref = jplan.plan(shape, jnp.float32, jplan.QRConfig(use_tuning_cache=False),
                     backend="gpu", ndevices=1, explain=True)
    assert mine.config.method == ref.config.method == method
    assert mine.explain.selected.rule == ref.explain.selected.rule == slug
    trail = [(d.rule, d.outcome) for d in mine.explain.decisions]
    assert trail == [(d.rule, d.outcome) for d in ref.explain.decisions]
    assert mine.config.use_kernel is True
    m, n = shape[-2:]
    assert mine.spec.smem_bytes(m, n, mine.config, 4) <= tplan.DEFAULT_SMEM_BUDGET
    if method == "tsqr":
        assert mine.config.nblocks == ref.config.nblocks == 8


def test_panel_kernel_layout_and_cap():
    """The panel kernel's row split: a cluster of up to MAX_CLUSTER CTAs of
    about CLUSTER_ROWS rows while one cluster holds the panel, a group of
    row blocks of at most ROWS_TARGET beyond; per-CTA bytes within the
    budget and equal to the estimator's; past the cap the planner raises
    naming it, and the plain lowering stays available."""
    assert tpanel.layout(576, 32)[:3] == ("cluster", 3, 192)
    assert tpanel.layout(4096, 32)[:3] == ("cluster", 16, 256)
    path, ctas, rows, nbytes = tpanel.layout(6144, 32, 8)
    assert (path, ctas, rows) == ("cluster", 16, 384)
    assert ctas * rows >= 6144 and nbytes <= tplan.DEFAULT_SMEM_BUDGET
    assert tops.mht_panel_smem_bytes(6144, 32, 8) == nbytes
    assert nbytes == (rows * 33 + 15 * 32 + 8) * 8
    path, groups, rows, nbytes = tpanel.layout(30000, 32, 8)
    assert path == "group" and groups * rows >= 30000
    assert nbytes == rows * 34 * 8 + (8 * 32 + 32 + 8) * 8
    with pytest.raises(ValueError, match="cooperative launch can hold"):
        tplan.plan((8000, 1000), torch.float32,
                   tplan.QRConfig(method="geqr2_ht"), backend="cuda")
    assert tplan.plan((8000, 1000), torch.float32, tplan.QRConfig(
        method="geqr2_ht", use_kernel=False), backend="cuda").config.use_kernel is False


@pytest.mark.parametrize("m,b,itemsize,want", [
    (576, 32, 4, ("cluster", 3, 192)),       # the (60, 576, 192) stack's panels
    (4096, 32, 4, ("cluster", 16, 256)),     # 4096^2, the first panel
    (6144, 32, 4, ("cluster", 16, 384)),     # the TSQR leaves
    (1152, 32, 4, ("cluster", 5, 231)),      # a TSQR merge of two leaves' R
    (16, 16, 4, ("cluster", 1, 16)),         # 16 x 1000: the pivot block
    (200, 32, 8, ("cluster", 1, 200)),       # 200^2 in fp64
    (20000, 32, 4, ("cluster", 16, 1250)),   # near a cluster's limit
    (20000, 32, 8, ("group", 24, 834)),      # past it in fp64
    (30000, 32, 4, ("group", 30, 1000)),     # past it in fp32
], ids=str)
def test_panel_kernel_layout_per_shape(m, b, itemsize, want):
    """The path, CTAs per panel and rows per CTA that ``layout`` picks from
    the shape alone, and its bytes: within the budget, enough rows, and
    the cluster path never past MAX_CLUSTER CTAs."""
    lay = tpanel.layout(m, b, itemsize)
    assert tuple(lay[:3]) == want
    assert lay.ctas * lay.rows >= m
    assert lay.smem_bytes <= tplan.DEFAULT_SMEM_BUDGET
    if lay.path == "cluster":
        assert lay.ctas <= tpanel.MAX_CLUSTER
        assert lay.smem_bytes == (lay.rows * (b | 1) + 15 * b + 8) * itemsize
    else:
        assert lay.ctas <= tpanel.MAX_GROUP
    assert tops.mht_panel_smem_bytes(m, b, itemsize) == lay.smem_bytes


def test_launch_counters_untouched_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    before = dict(tmo.LAUNCHES)
    a = torch.from_numpy(_matrix((3, 50, 30), 2, "float32"))
    repro_torch.qr(a, config=tplan.QRConfig(use_kernel=True, block=BLOCK),
                   device="cpu")
    tmht.geqr2_ht(a)
    assert tmo.LAUNCHES == before

"""The port's blocked WY QR (``repro_torch.core.blocked``) against the JAX
package's: panels (MHT and classical HT), DLARFT, the WY update,
``geqrf`` (DGEQRF / DGEQRFHT), ``geqrf_fori``, and Q formed panel by
panel against the one-reflector-at-a-time ``form_q``.

Inputs are made with numpy from fixed seeds and handed to both packages;
each matrix has an exactly zero column (the ``tau = 0`` branch).  float64
cases enable x64 on the JAX side with the scoped ``jax.enable_x64(True)``.

Tolerance: a whole factorization, or Q from it, is held to ``10 * eps *
max(m, n) * max(1, max |jax|)`` — the same reflectors summed in other
orders, each column's rounding carried into the next (a tenth of the
conformance bar); one panel step to ``4 * eps * m * max(1, max |jax|)``.
T is held relative to its own size, ``4 * eps * m * max |T|``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jbl
from repro.core import householder as jhh
from repro_torch.core import blocked as tbl
from repro_torch.core import householder as thh
from worker_threads import share_the_cores  # noqa: F401  (autouse)

DTYPES = ("float32", "float64")
SHAPES = [(32, 32), (40, 24), (24, 40), (37, 23)]
BLOCK = 8


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _matrix(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape)
    a[..., min(2, shape[-1] - 1)] = 0.0
    return a.astype(dtype)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _eps(dtype):
    return float(np.finfo(dtype).eps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row0", [0, 5])
@pytest.mark.parametrize("method", ["mht", "ht"])
def test_panel_factor_matches_jax(method, row0, dtype):
    """An (m, b) panel with pivots from ``row0``: rows above are kept."""
    a = _matrix((30, 6), row0, dtype)
    with _x64(dtype):
        jp, jt = (np.asarray(x) for x in jbl.panel_factor(
            jnp.asarray(a), row0, method=method))
    tp, tt = tbl.panel_factor(torch.from_numpy(a), row0, method=method)
    tol = 4 * _eps(dtype) * 30
    _close(tp.numpy(), jp, tol)
    _close(tt.numpy(), jt, tol)
    assert np.array_equal(tp.numpy()[:row0], a[:row0])
    with pytest.raises(ValueError, match="panel method"):
        tbl.panel_factor(torch.from_numpy(a), 0, method="qr")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 5, 8, 13])
def test_larft_matches_jax(b, dtype):
    """T of the reflectors of a factored panel (one tau exactly 0), for
    widths that are and are not powers of two: the doubling recurrence
    against the reference's column recurrence."""
    a = _matrix((25, b), b, dtype)
    packed, taus = tbl.panel_factor(torch.from_numpy(a), 0)
    v = tbl.unpack_v_panel(packed, 0)
    with _x64(dtype):
        want = np.asarray(jbl.larft(jnp.asarray(v.numpy()),
                                    jnp.asarray(taus.numpy())))
    got = tbl.larft(v, taus)
    assert np.array_equal(np.triu(got.numpy()), got.numpy())
    _close(got.numpy(), want, 4 * _eps(dtype) * 25)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wy_apply_matches_jax(dtype):
    a = _matrix((20, 6), 1, dtype)
    c = np.random.default_rng(2).standard_normal((20, 9)).astype(dtype)
    packed, taus = tbl.panel_factor(torch.from_numpy(a), 0)
    v = tbl.unpack_v_panel(packed, 0)
    t = tbl.larft(v, taus)
    with _x64(dtype):
        want = np.asarray(jbl.wy_apply(jnp.asarray(v.numpy()),
                                       jnp.asarray(t.numpy()), jnp.asarray(c)))
    for use_kernel in (False, True):   # True on the CPU: the plain version
        got = tbl.wy_apply(v, t, torch.from_numpy(c), use_kernel=use_kernel)
        _close(got.numpy(), want, 4 * _eps(dtype) * 20)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("panel_method", ["mht", "ht"])
def test_geqrf_matches_jax(panel_method, shape, dtype):
    """DGEQRFHT / DGEQRF at block 8: packed and taus element by element;
    the MHT kernel path (on the CPU: the kernels' plain versions) too."""
    a = _matrix(shape, sum(shape), dtype)
    with _x64(dtype):
        jp, jt = (np.asarray(x) for x in jbl.geqrf(
            jnp.asarray(a), block=BLOCK, panel_method=panel_method))
    tol = 10 * _eps(dtype) * max(shape)
    runs = [dict(use_kernel=False)]
    if panel_method == "mht":
        runs.append(dict(use_kernel=True))
    for kw in runs:
        tp, tt = tbl.geqrf(torch.from_numpy(a), block=BLOCK,
                           panel_method=panel_method, **kw)
        assert tt.shape == (min(shape),)
        _close(tp.numpy(), jp, tol)
        _close(tt.numpy(), jt, tol)
    with pytest.raises(ValueError, match="MHT panels only"):
        tbl.geqrf(torch.from_numpy(a), panel_method="ht", use_kernel=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(32, 16), (16, 24)], ids=str)
def test_geqrf_fori_matches_jax(shape, dtype):
    a = _matrix(shape, 3, dtype)
    with _x64(dtype):
        jp, jt = (np.asarray(x) for x in jbl.geqrf_fori(jnp.asarray(a),
                                                        block=BLOCK))
    tp, tt = tbl.geqrf_fori(torch.from_numpy(a), block=BLOCK)
    tol = 10 * _eps(dtype) * max(shape)
    _close(tp.numpy(), jp, tol)
    _close(tt.numpy(), jt, tol)
    with pytest.raises(ValueError, match="not divisible"):
        tbl.geqrf_fori(torch.from_numpy(a), block=5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_q_by_panels_matches_form_q(shape, dtype):
    """Q formed panel by panel (the kernel path's way, here through the
    trailing kernel's plain version) against the one-reflector-at-a-time
    ``form_q`` and the reference's ``form_q`` on the reference's own
    factorization, thin and full, and Q^T C likewise."""
    a = _matrix(shape, 9 + sum(shape), dtype)
    c = np.random.default_rng(4).standard_normal((shape[0], 3)).astype(dtype)
    with _x64(dtype):
        jp, jt = jbl.geqrf(jnp.asarray(a), block=BLOCK)
        want = [np.asarray(x) for x in (
            jhh.form_q(jp, jt), jhh.form_q(jp, jt, full=True),
            jhh.apply_q(jp, jt, jnp.asarray(c), transpose=True),
            jhh.apply_q(jp, jt, jnp.asarray(c)))]
        jp, jt = np.asarray(jp), np.asarray(jt)
    tp, tt, tc = (torch.from_numpy(np.array(x)) for x in (jp, jt, c))
    tol = 10 * _eps(dtype) * max(shape)
    for use_kernel in (False, True):
        kw = dict(block=BLOCK, use_kernel=use_kernel)
        got = [tbl.form_q_blocked(tp, tt, **kw),
               tbl.form_q_blocked(tp, tt, full=True, **kw),
               tbl.apply_q_blocked(tp, tt, tc, transpose=True, **kw),
               tbl.apply_q_blocked(tp, tt, tc, **kw)]
        for g, w in zip(got, want):
            _close(g.numpy(), w, tol)
        _close(got[0].numpy(), thh.form_q(tp, tt).numpy(), tol)
    # Any panel width applies the same Q.
    _close(tbl.form_q_blocked(tp, tt, block=3).numpy(), want[0], tol)


def test_geqrf_stack_equals_per_slice():
    """A (2, 2, m, n) stack through one geqrf call equals each matrix's
    own run, on both paths (the kernel path's stack is one launch per
    panel step on the card)."""
    a = torch.from_numpy(_matrix((2, 2, 30, 20), 5, "float64"))
    for use_kernel in (False, True):
        packed, taus = tbl.geqrf(a, block=BLOCK, use_kernel=use_kernel)
        assert packed.shape == a.shape and taus.shape == (2, 2, 20)
        for i in range(2):
            for j in range(2):
                p1, t1 = tbl.geqrf(a[i, j], block=BLOCK, use_kernel=use_kernel)
                torch.testing.assert_close(packed[i, j], p1, rtol=0, atol=1e-13)
                torch.testing.assert_close(taus[i, j], t1, rtol=0, atol=1e-13)

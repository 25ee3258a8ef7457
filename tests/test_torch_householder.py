"""The port's classical Householder QR and packed-form helpers
(``repro_torch.core.householder``) and its MHT (``repro_torch.core.mht``)
against the JAX package's.

Inputs are made with numpy from fixed seeds and handed to both packages;
every matrix has an exactly zero column, so the ``tau = 0`` branch runs.
float64 cases enable x64 on the JAX side with the scoped
``jax.enable_x64(True)``.

Tolerance: both packages compute the same reflectors in the same order
but sum in different orders, and each column's rounding carries into the
next, so a whole factorization is held to ``10 * eps * max(m, n) *
max(1, max |jax|)`` (a tenth of the conformance bar); one reflector or one
update, which sums m terms, to ``4 * eps * m * max(1, max |jax|)``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import householder as jhh
from repro.core import mht as jmht
from repro_torch.core import householder as thh
from repro_torch.core import mht as tmht
from worker_threads import share_the_cores  # noqa: F401  (autouse)

SHAPES = [(12, 12), (20, 7), (7, 15), (1, 5), (6, 1)]
DTYPES = ("float32", "float64")


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _matrix(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape)
    if shape[-1] > 1:
        a[..., 1] = 0.0
    return a.astype(dtype)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0), err


def _factor_tol(dtype, shape):
    return 10 * float(np.finfo(dtype).eps) * max(shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 3, 7])
def test_house_vector_matches_jax(offset, dtype):
    """v, tau, beta of random vectors, one with an exactly zero tail (tau
    = 0, beta = x0) and one all zero, at pivots inside and at the end."""
    x = np.random.default_rng(offset).standard_normal((3, 8)).astype(dtype)
    x[1, offset + 1:] = 0.0
    x[2] = 0.0
    with _x64(dtype):
        outs = [jhh.house_vector(jnp.asarray(row), offset) for row in x]
        want = [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]
    got = thh.house_vector(torch.from_numpy(x), offset)
    tol = 4 * float(np.finfo(dtype).eps) * x.shape[-1]
    for g, w in zip(got, want):
        _close(g.numpy(), w.reshape(g.shape), tol)
    assert float(got[1][1]) == 0.0 and float(got[2][1]) == x[1, offset]


_FACTORS = {
    "geqr2": (jhh.geqr2, thh.geqr2),
    "geqr2_ht": (jmht.geqr2_ht, tmht.geqr2_ht),
    "geqr2_explicit_p": (jhh.geqr2_explicit_p, thh.geqr2_explicit_p),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", list(_FACTORS))
def test_unblocked_factorizations_match_jax(name, shape, dtype):
    """Packed factor and taus, element by element, in the LAPACK layout;
    ``min(m, n)`` taus, the zero column's exactly 0."""
    jfn, tfn = _FACTORS[name]
    a = _matrix(shape, sum(shape), dtype)
    with _x64(dtype):
        jp, jt = (np.asarray(x) for x in jfn(jnp.asarray(a)))
    tp, tt = tfn(torch.from_numpy(a))
    assert tt.shape == (min(shape),) and tp.dtype == getattr(torch, dtype)
    tol = _factor_tol(dtype, shape)
    _close(tp.numpy(), jp, tol)
    _close(tt.numpy(), jt, tol)
    if min(shape) > 1:
        assert float(tt[1]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_q_helpers_match_jax(shape, dtype):
    """unpack_r / unpack_v, thin and full form_q, and apply_q / apply_q^T
    from the same packed factorization (the reference's own)."""
    a = _matrix(shape, 7 + sum(shape), dtype)
    c = np.random.default_rng(3).standard_normal((shape[0], 3)).astype(dtype)
    with _x64(dtype):
        jp, jt = jhh.geqr2(jnp.asarray(a))
        want = [np.asarray(x) for x in (
            jhh.unpack_r(jp), jhh.unpack_v(jp), jhh.form_q(jp, jt),
            jhh.form_q(jp, jt, full=True),
            jhh.apply_q(jp, jt, jnp.asarray(c)),
            jhh.apply_q(jp, jt, jnp.asarray(c), transpose=True))]
        jp, jt = np.asarray(jp), np.asarray(jt)
    tp, tt, tc = (torch.from_numpy(x) for x in (jp, jt, c))
    got = [thh.unpack_r(tp), thh.unpack_v(tp), thh.form_q(tp, tt),
           thh.form_q(tp, tt, full=True), thh.apply_q(tp, tt, tc),
           thh.apply_q(tp, tt, tc, transpose=True)]
    tol = _factor_tol(dtype, shape)
    for g, w in zip(got, want):
        _close(g.numpy(), w, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mht_update_matches_jax(dtype):
    """The fused update leaves columns up to ``col`` alone and equals the
    reference's on the rest."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((9, 6)).astype(dtype)
    v = rng.standard_normal(9).astype(dtype)
    tau = np.asarray(0.7, dtype)
    with _x64(dtype):
        want = np.asarray(jmht.mht_update(jnp.asarray(a), jnp.asarray(v),
                                          jnp.asarray(tau), 2))
    got = tmht.mht_update(torch.from_numpy(a), torch.from_numpy(v),
                          torch.from_numpy(tau), 2)
    _close(got.numpy(), want, 4 * float(np.finfo(dtype).eps) * 9)
    assert np.array_equal(got.numpy()[:, :3], a[:, :3])


def test_batched_unblocked_equal_per_slice():
    """Leading dimensions are independent matrices: a (2, 3, m, n) stack
    through geqr2_ht / geqr2 / form_q equals each matrix on its own."""
    a = torch.from_numpy(_matrix((2, 3, 10, 6), 4, "float64"))
    for fn in (tmht.geqr2_ht, tmht.geqr2_ht_batched, thh.geqr2):
        packed, taus = fn(a)
        q = thh.form_q(packed, taus)
        for i in range(2):
            for j in range(3):
                p1, t1 = fn(a[i, j])
                torch.testing.assert_close(packed[i, j], p1, rtol=0, atol=1e-14)
                torch.testing.assert_close(taus[i, j], t1, rtol=0, atol=1e-14)
                torch.testing.assert_close(q[i, j], thh.form_q(p1, t1),
                                           rtol=0, atol=1e-14)
    p, t = tmht.mht_panel_jnp(a[0, 0])
    torch.testing.assert_close(p, tmht.geqr2_ht(a[0, 0])[0], rtol=0, atol=0)

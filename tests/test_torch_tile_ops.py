"""The port's single-tile TSQRT / SSRFB entry points
(``repro_torch.kernels.tile_ops``; on the CPU their plain bodies) against
the reference's single-tile Pallas kernels in interpret mode and against
the oracles of ``kernels/ref.py``.

Inputs are made with numpy from fixed seeds and handed to both packages;
float64 cases enable x64 on the JAX side with the scoped
``jax.enable_x64(True)``.  Each batch of cases holds a random pair and one
whose A tile has an exactly zero first column (``tau = 0``).

Tolerance: a tile's column loop sums nb-term products in another order
than the reference's: ``50 * eps * nb * max(1, max |jax|)``, the macro-op
bodies' bound (tests/test_torch_macro_ops.py).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tile_ops as jtile
from repro_torch.kernels import macro_ops as tmo
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_ops as ttile
from worker_threads import share_the_cores  # noqa: F401  (autouse)

DTYPES = ("float32", "float64")


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _close(got, want, dtype, nb):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    tol = 50 * np.finfo(dtype).eps * nb * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


def _pair(nb, seed, dtype, zero_col):
    rng = np.random.default_rng(seed)
    r = np.triu(rng.standard_normal((nb, nb)))
    a = rng.standard_normal((nb, nb))
    if zero_col:
        a[:, 0] = 0.0
    return r.astype(dtype), a.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_col", [False, True])
@pytest.mark.parametrize("nb", [8, 16])
def test_tsqrt_matches_reference_kernel(nb, zero_col, dtype):
    """(R new, V2, taus) against the reference's kernel (interpret mode)
    and, in float32 (its only type), the dense oracle; the zero column's
    tau is exactly 0."""
    r, a = _pair(nb, nb, dtype, zero_col)
    with _x64(dtype):
        want = [np.asarray(x) for x in jtile.tsqrt(jnp.asarray(r), jnp.asarray(a),
                                                   interpret=True)]
    got = ttile.tsqrt(torch.from_numpy(r), torch.from_numpy(a))
    for g, w in zip(got, want):
        _close(g.numpy(), w, dtype, nb)
    if dtype == "float32":
        for g, w in zip(got, tref.tsqrt_ref(torch.from_numpy(r),
                                            torch.from_numpy(a))):
            _close(g.numpy(), w.numpy(), dtype, nb)
    if zero_col:
        assert float(got[2][0]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [8, 16])
def test_ssrfb_matches_reference_kernel(nb, dtype):
    """(C_k, C_i) from the reflectors of a real TSQRT, against the
    reference's kernel (interpret mode) and, in float32, the oracle."""
    r, a = _pair(nb, 3 * nb, dtype, True)
    _, v2, t, _ = tmo.tsqrt_body(torch.from_numpy(r)[None],
                                 torch.from_numpy(a)[None])
    rng = np.random.default_rng(nb)
    ck, ci = (rng.standard_normal((nb, nb)).astype(dtype) for _ in range(2))
    args = (v2[0].numpy(), t[0].numpy(), ck, ci)
    with _x64(dtype):
        want = [np.asarray(x) for x in jtile.ssrfb(*map(jnp.asarray, args),
                                                   interpret=True)]
    got = ttile.ssrfb(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        _close(g.numpy(), w, dtype, nb)
    if dtype == "float32":
        for g, w in zip(got, tref.ssrfb_ref(*map(torch.from_numpy, args))):
            _close(g.numpy(), w.numpy(), dtype, nb)


def test_tile_entries_check_their_inputs():
    """Non-square or mismatched tiles, and a tile whose kernel would not
    fit one CTA's shared memory, are refused; the CPU path counts no
    launch."""
    before = dict(tmo.LAUNCHES)
    sq = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="square same-shape"):
        ttile.tsqrt(sq, torch.zeros(8, 4))
    with pytest.raises(ValueError, match="square same-shape"):
        ttile.ssrfb(sq, sq, sq, torch.zeros(4, 8))
    big = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="shared"):
        ttile.tsqrt(big, big)
    ttile.tsqrt(sq, sq)
    assert tmo.LAUNCHES == before
    assert ttile.smem_bytes_tsqrt(32) == tmo.smem_bytes("TSQRT", 32)
    assert ttile.smem_bytes_ssrfb(32, 8) == tmo.smem_bytes("SSRFB", 32, 8)

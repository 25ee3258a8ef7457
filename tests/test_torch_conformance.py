"""The port's twin of ``tests/test_conformance.py``: every ported method
held to the one bar, ``100 * eps * max(m, n)`` on ||Q^T Q - I||_max and
||A - QR||_F / ||A||_F, with R exactly upper triangular, on the stress
inputs the reference's suite adds to its shape sweep:

  * a graded spectrum (64 x 32, cond 1e3);
  * exact rank deficiency (48 x 16 rank 8, 128 x 32 rank 3): finite
    factors and a triangular R (Q's orthogonality is method-defined there,
    as in the reference);
  * an all-zero input (48 x 16): the exact ``tau = 0`` reflectors give
    Q = I and R = 0;
  * the degenerate shapes with a batch dimension, (2, 0, 5), (2, 5, 0)
    and (3, 2, 0, 4), whose shapes and values must equal the JAX
    package's in every mode (``qr`` and ``orthogonalize``).

Each CPU case runs the plain lowering and, for the kernel-backed methods,
the kernel wrappers (their plain versions on a CPU tensor).  The
``cuda``-marked cases run the same inputs on the card through the
kernels and skip without an sm_90 device.  The JAX package is imported
only by the tests that compare against it, so the card's cases also run
where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_conformance.py -m cuda -q
"""

import importlib

import numpy as np
import pytest
import torch

import repro_torch
from worker_threads import share_the_cores  # noqa: F401  (autouse)

tplan = importlib.import_module("repro_torch.core.plan")

BLOCK = 8
# Every method but the trivial zero-dim one (sharded_tiled runs here in
# one process: one domain, the tiled backend's path).
METHODS = [m for m in tplan.available_methods() if m != "degenerate"]
KERNEL_METHODS = [m for m in METHODS if tplan.get_method(m).kernel_backed]
CASES = [(m, False) for m in METHODS] + [(m, True) for m in KERNEL_METHODS]
CASE_IDS = [f"{m}-{'kernel' if k else 'plain'}" for m, k in CASES]


def _svd_matrix(m, n, s, seed, dtype=np.float32):
    """U diag(s) V^T with Haar-random U, V from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = min(m, n)
    return ((u[:, :k] * s) @ v[:, :k].T).astype(dtype)


def graded(m, n, cond, seed):
    k = min(m, n)
    return _svd_matrix(m, n, np.logspace(0.0, -np.log10(cond), k), seed)


def rank_deficient(m, n, rank, seed):
    s = np.zeros(min(m, n))
    s[:rank] = np.logspace(0.0, -1.0, max(rank, 1))[:rank]
    return _svd_matrix(m, n, s, seed)


def _tol(dtype, m, n):
    return 100.0 * float(torch.finfo(dtype).eps) * max(m, n)


def _solve(a, method, use_kernel, device="cpu"):
    cfg = repro_torch.QRConfig(method=method, block=BLOCK,
                               use_kernel=use_kernel)
    try:
        solver = repro_torch.plan(a.shape, a.dtype, cfg, backend=device)
    except ValueError as e:   # the planner's capability checks, as the
        pytest.skip(f"capability: {e}")   # reference's suite reads them
    return solver.solve(torch.as_tensor(a, device=device))


def _assert_conformance(a, q, r, tol):
    a = torch.as_tensor(a, device=q.device).double()
    q, r = q.double(), r.double()
    k = min(a.shape)
    eye = torch.eye(q.shape[-1], dtype=torch.float64, device=q.device)
    orth = float((q.mT @ q - eye).abs().max())
    rec = float(torch.linalg.norm(q @ r - a)
                / max(float(torch.linalg.norm(a)), 1e-30))
    assert orth <= tol, f"||Q^T Q - I|| = {orth} > {tol}"
    assert rec <= tol, f"||A - QR||/||A|| = {rec} > {tol}"
    assert float(torch.tril(r[:, :k], -1).abs().max()) == 0.0, \
        "R not strictly upper triangular"


@pytest.mark.parametrize("method,use_kernel", CASES, ids=CASE_IDS)
def test_graded_spectrum_conformance(method, use_kernel):
    """cond = 1e3 graded singular values (64 x 32): the same bar."""
    a = graded(64, 32, 1e3, seed=11)
    q, r = _solve(a, method, use_kernel)
    _assert_conformance(a, q, r, _tol(torch.float32, 64, 32))


@pytest.mark.parametrize("shape,rank", [((48, 16), 8), ((128, 32), 3)],
                         ids=["48x16r8", "128x32r3"])
@pytest.mark.parametrize("method,use_kernel", CASES, ids=CASE_IDS)
def test_rank_deficient_finite_and_triangular(method, use_kernel, shape,
                                              rank):
    """Exactly rank-deficient input: finite factors, R triangular, and
    the reconstruction inside the bar."""
    m, n = shape
    a = rank_deficient(m, n, rank, seed=12 + rank)
    q, r = _solve(a, method, use_kernel)
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(r).all())
    assert float(torch.tril(r[:, :n], -1).abs().max()) == 0.0
    rec = float(torch.linalg.norm(q.double() @ r.double()
                                  - torch.as_tensor(a).double())
                / torch.linalg.norm(torch.as_tensor(a).double()))
    assert rec <= _tol(torch.float32, m, n), rec


@pytest.mark.parametrize("method,use_kernel", CASES, ids=CASE_IDS)
def test_zero_input(method, use_kernel):
    """An all-zero 48 x 16 input: every reflector is the exact tau = 0
    one, so R is zero and Q has orthonormal columns."""
    a = np.zeros((48, 16), np.float32)
    q, r = _solve(a, method, use_kernel)
    assert bool(torch.isfinite(q).all()) and float(r.abs().max()) == 0.0
    eye = torch.eye(16, dtype=torch.float64)
    assert float((q.double().mT @ q.double() - eye).abs().max()) \
        <= _tol(torch.float32, 48, 16)


_EMPTY = [(2, 0, 5), (2, 5, 0), (3, 2, 0, 4)]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("method", ["auto", "tiled", "geqrf_ht", "tsqr"])
@pytest.mark.parametrize("mode", ["reduced", "r", "full"])
@pytest.mark.parametrize("shape", _EMPTY, ids=["2x0x5", "2x5x0", "3x2x0x4"])
def test_empty_stack_matches_reference(shape, mode, method):
    """A stack of empty matrices returns the JAX package's factors: the
    same shapes and values (identity Q, zero R) in every mode."""
    import repro.core as jcore

    a = np.zeros(shape, np.float32)
    got = _as_tuple(repro_torch.qr(
        a, config=repro_torch.QRConfig(mode=mode, method=method),
        device="cpu"))
    want = _as_tuple(jcore.qr(a, config=jcore.QRConfig(mode=mode,
                                                       method=method)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("shape", _EMPTY, ids=["2x0x5", "2x5x0", "3x2x0x4"])
def test_empty_stack_orthogonalize_matches_reference(shape):
    import repro.core as jcore

    a = np.zeros(shape, np.float32)
    got = repro_torch.orthogonalize(a, device="cpu")
    want = np.asarray(jcore.orthogonalize(a))
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("method", KERNEL_METHODS)
def test_stress_inputs_on_hopper(method):
    """The graded, rank-deficient and zero inputs through the kernels on
    the card: the bar on the graded input, finite triangular factors on
    the rank-deficient ones, Q = I-like and R = 0 on the zero input."""
    _need_hopper()
    a = graded(64, 32, 1e3, seed=11)
    q, r = _solve(a, method, True, device="cuda")
    _assert_conformance(a, q, r, _tol(torch.float32, 64, 32))
    for (m, n), rank in (((48, 16), 8), ((128, 32), 3)):
        a = rank_deficient(m, n, rank, seed=12 + rank)
        q, r = _solve(a, method, True, device="cuda")
        assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(r).all())
        assert float(torch.tril(r[:, :n], -1).abs().max()) == 0.0
    q, r = _solve(np.zeros((48, 16), np.float32), method, True, device="cuda")
    assert bool(torch.isfinite(q).all()) and float(r.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _EMPTY, ids=["2x0x5", "2x5x0", "3x2x0x4"])
def test_empty_stack_on_hopper(shape):
    """The empty stacks on the card give the CPU's shapes and values."""
    _need_hopper()
    a = np.zeros(shape, np.float32)
    for mode in ("reduced", "r", "full"):
        cfg = repro_torch.QRConfig(mode=mode)
        got = _as_tuple(repro_torch.qr(a, config=cfg))
        want = _as_tuple(repro_torch.qr(a, config=cfg, device="cpu"))
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


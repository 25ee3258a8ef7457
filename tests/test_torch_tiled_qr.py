"""The port's ``tiled_qr``, planner and API against the JAX package.

``tiled_qr`` runs on the conformance shapes at block 8 in every mode and
is held against JAX ``tiled_qr`` within ``10 * eps * max(m, n) *
max(1, max |jax|)`` (summation order; a tenth of the conformance bar) and
against the conformance bar itself, ``100 * eps * max(m, n)``
(tests/test_conformance.py).  Routing is held against the reference's
routing table (tests/test_plan.py) decision by decision.
"""

import contextlib
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tilegraph as jtg
import repro_torch
from repro_torch.core import tilegraph as ttg
from test_plan import _ROUTING_TABLE
from worker_threads import share_the_cores  # noqa: F401  (autouse)

# Both packages export a function named ``plan`` from ``core``.
jplan = importlib.import_module("repro.core.plan")
tplan = importlib.import_module("repro_torch.core.plan")

BLOCK = 8
SHAPES = [("square", (32, 32)), ("tall", (96, 16)), ("wide", (16, 40)),
          ("offblock", (37, 23))]


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _bar(dtype, m, n):
    return 100.0 * float(np.finfo(dtype).eps) * max(m, n)


def _matrix(m, n, seed, dtype):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def _conformance(a, q, r, dtype):
    m, n = a.shape
    a64, q64, r64 = (np.asarray(x, np.float64) for x in (a, q, r))
    k = q64.shape[1]
    assert np.abs(q64.T @ q64 - np.eye(k)).max() <= _bar(dtype, m, n)
    resid = np.linalg.norm(a64 - q64 @ r64) / np.linalg.norm(a64)
    assert resid <= _bar(dtype, m, n)
    assert np.allclose(np.tril(r64, -1), 0.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label,shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_tiled_qr_modes_match_jax(label, shape, dtype):
    m, n = shape
    a = _matrix(m, n, seed=m * 100 + n, dtype=dtype)
    with _x64(dtype):
        jq, jr = (np.asarray(x) for x in jtg.tiled_qr(
            jnp.asarray(a), tile=BLOCK, mode="full"))
    k = min(m, n)
    mine = {mode: ttg.tiled_qr(torch.from_numpy(a), tile=BLOCK, mode=mode)
            for mode in ("reduced", "r", "full")}
    want = {"reduced": (jq[:, :k], jr[:k]), "r": (jr[:k],), "full": (jq, jr)}
    tol = 10 * float(np.finfo(dtype).eps) * max(m, n)
    for mode, outs in mine.items():
        outs = outs if isinstance(outs, tuple) else (outs,)
        for got, ref in zip(outs, want[mode]):
            assert got.shape == ref.shape, mode
            err = float(np.abs(got.numpy().astype(np.float64) - ref).max())
            assert err <= tol * max(1.0, float(np.abs(ref).max())), (mode, err)
    _conformance(a, *mine["reduced"], dtype)
    _conformance(a, *mine["full"], dtype)
    np.testing.assert_array_equal(mine["r"].numpy(), mine["reduced"][1].numpy())


def _route_trail(decisions):
    return [(d.rule, d.outcome) for d in decisions]


@pytest.mark.parametrize("shape,backend,ndevices,expected", _ROUTING_TABLE)
def test_routing_matches_reference(shape, backend, ndevices, expected):
    """Same method and the same decision trail as the reference, row by
    row.  The reference's "tpu" rows run here on "cuda", held against the
    reference planned for a non-TPU accelerator ("gpu"), which shares the
    256 floor and declines the TPU panel-kernel rule just as "cuda" does.
    Resolve-hook decisions of methods not ported (sharded_tiled) and the
    dispatch-mode decisions of the kernel path are compared in their own
    tests."""
    heur = tplan.QRConfig(use_tuning_cache=False)
    mine_backend = "cuda" if backend == "tpu" else backend
    ref_backend = "gpu" if backend == "tpu" else backend
    assert tplan.select_method(shape, torch.float32, heur, backend=mine_backend,
                               ndevices=ndevices) == expected
    ref_method, ref_dec, _ = jplan._route(shape, jnp.float32, jplan.QRConfig(
        use_tuning_cache=False), ref_backend, ndevices)
    method, dec, _ = tplan._route(shape, torch.float32, heur, mine_backend,
                                  ndevices)
    assert method == ref_method == expected
    if backend != "tpu":
        assert [(d.rule, d.outcome, d.reason) for d in dec] == \
            [(d.rule, d.outcome, d.reason) for d in ref_dec]
    else:
        assert _route_trail(dec) == _route_trail(ref_dec)
    if expected != "sharded_tiled":
        ex = tplan.plan(shape, torch.float32, heur, backend=mine_backend,
                        ndevices=ndevices, explain=True).explain
        ref_ex = jplan.plan(shape, jnp.float32, jplan.QRConfig(
            use_tuning_cache=False), backend=ref_backend, ndevices=ndevices,
            explain=True).explain
        drop = ("megakernel_over_budget", "dispatch_mode_auto")
        assert [r for r in _route_trail(ex.decisions) if r[0] not in drop] == \
            [r for r in _route_trail(ref_ex.decisions) if r[0] not in drop]
        assert ex.method == ref_ex.method == expected


def test_main_path_plan_on_cuda():
    """2048^2 fp32 on "cuda": tiled, kernel path, wavefront lowering, with
    the megakernel's rejection recorded as a fallback.  512^2, whose task
    table fits: the megakernel, resolved with a ``dispatch_mode_auto``
    decision, as the reference resolves it on its kernel path."""
    s = tplan.plan((2048, 2048), torch.float32, backend="cuda", explain=True)
    assert (s.config.method, s.config.use_kernel, s.config.dispatch_mode,
            s.config.block) == ("tiled", True, "wavefront", 32)
    assert s.explain.fallback_reasons == ("megakernel_over_budget",)
    s = tplan.plan((512, 512), torch.float32, backend="cuda", explain=True)
    ref = jplan.plan((512, 512), jnp.float32, backend="tpu", explain=True)
    assert s.config.dispatch_mode == ref.config.dispatch_mode == "megakernel"
    assert s.explain.fallback_reasons == ref.explain.fallback_reasons == ()
    mine, theirs = (x.explain.decision("dispatch_mode_auto")
                    for x in (s, ref))
    assert (mine.rule, mine.outcome) == (theirs.rule, theirs.outcome) == (
        "dispatch_mode_auto", "resolved")
    s = tplan.plan((512, 512), torch.float32, backend="cpu")
    assert s.config.use_kernel is False and s.config.dispatch_mode is None


def test_cuda_plan_raises_when_kernels_do_not_fit():
    """On "cuda" the plan runs the kernels or raises: a tile whose
    per-task shared memory exceeds the budget is refused, not resolved to
    the plain lowering.  The plain lowering stays on request or on the
    CPU; the largest tile that fits is held to the kernels' own sizes."""
    big = tplan.QRConfig(block=128)
    with pytest.raises(ValueError, match=r"232448 B"):
        tplan.plan((2048, 2048), torch.float32, big, backend="cuda")
    with pytest.raises(ValueError, match="block 80"):
        tplan.plan((2048, 2048), torch.float64, big.replace(block=80),
                   backend="cuda")
    assert tplan.plan((2048, 2048), torch.float64, big.replace(block=64),
                      backend="cuda").config.use_kernel is True
    s = tplan.plan((2048, 2048), torch.float32, big.replace(use_kernel=False),
                   backend="cuda")
    assert s.config.use_kernel is False
    assert tplan.plan((2048, 2048), torch.float32, big,
                      backend="cpu").config.use_kernel is False
    s = tplan.plan((2048, 2048), torch.float32, tplan.QRConfig(block=96),
                   backend="cuda")
    assert s.config.use_kernel is True


def test_forced_megakernel_verify_and_backend_raise():
    with pytest.raises(ValueError, match="task table"):
        tplan.plan((2048, 2048), torch.float32,
                   tplan.QRConfig(dispatch_mode="megakernel"), backend="cuda")
    # verify=True plans: the knob reaches the solver, and
    # qr() runs the health-checked solve.
    assert tplan.plan((64, 64), torch.float32, tplan.QRConfig(verify=True),
                      backend="cpu").config.verify is True
    a = _matrix(64, 48, 0, "float32")
    q, r = repro_torch.qr(a, device="cpu", config=tplan.QRConfig(verify=True))
    assert float((q @ r - torch.from_numpy(a)).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="backend"):
        tplan.plan((64, 64), torch.float32, backend="tpu")
    # sharded_tiled is ported: without a process group it is the tiled
    # backend, bit for bit.
    eye = np.eye(8, dtype=np.float32)
    got = repro_torch.qr(eye, device="cpu",
                         config=tplan.QRConfig(method="sharded_tiled"))
    want = repro_torch.qr(eye, device="cpu",
                          config=tplan.QRConfig(method="tiled"))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_entry_points_without_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _matrix(64, 64, 0, "float32")
    cfg = tplan.QRConfig(method="tiled")
    for call in (lambda: repro_torch.qr(a, config=cfg),
                 lambda: repro_torch.orthogonalize(a, config=cfg),
                 lambda: repro_torch.lstsq(a, a[:, 0], config=cfg),
                 lambda: repro_torch.qr(a, config=cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_api_on_cpu_matches_jax():
    """qr / orthogonalize / lstsq with method="tiled" on the CPU."""
    m, n = 48, 40
    a = _matrix(m, n, 5, "float32")
    b = _matrix(m, 2, 6, "float32")
    cfg = tplan.QRConfig(method="tiled", block=BLOCK)
    jcfg = jplan.QRConfig(method="tiled", block=BLOCK)
    from repro.core import api as japi

    tol = 10 * float(np.finfo(np.float32).eps) * max(m, n)
    q, r = repro_torch.qr(a, config=cfg, device="cpu")
    jq, jr = japi.qr(jnp.asarray(a), config=jcfg)
    assert np.abs(q.numpy() - np.asarray(jq)).max() <= tol
    assert np.abs(r.numpy() - np.asarray(jr)).max() <= tol * np.abs(jr).max()
    o = repro_torch.orthogonalize(a.T, config=cfg, device="cpu")
    jo = japi.orthogonalize(jnp.asarray(a.T), config=jcfg)
    assert np.abs(o.numpy() - np.asarray(jo)).max() <= tol
    x = repro_torch.lstsq(a, b, config=cfg, device="cpu")
    jx = japi.lstsq(jnp.asarray(a), jnp.asarray(b), config=jcfg)
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= tol * max(
        1.0, float(np.abs(jx).max()))
    qs, rs = repro_torch.qr(a, config=cfg.replace(q_method="solve",
                                                  sign_fix=True), device="cpu")
    _conformance(a, qs, rs, "float32")
    assert (torch.diagonal(rs) >= 0).all()
    stack = np.stack([a, 2 * a])
    qb, rb = repro_torch.qr(stack, config=cfg, device="cpu")
    assert qb.shape == (2, m, n) and rb.shape == (2, n, n)
    np.testing.assert_allclose(rb[1].numpy(), 2 * rb[0].numpy(), rtol=1e-5,
                               atol=1e-4)


def test_degenerate_shapes():
    q, r = repro_torch.qr(np.zeros((0, 5), np.float32), device="cpu")
    assert q.shape == (0, 0) and r.shape == (0, 5)
    q, r = repro_torch.qr(np.zeros((4, 0), np.float32), device="cpu",
                          config=tplan.QRConfig(mode="full"))
    assert torch.equal(q, torch.eye(4)) and r.shape == (4, 0)


def test_import_pulls_in_no_jax_and_no_reference():
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; import repro_torch; "
            "import repro_torch.core.engine, repro_torch.core.tilegraph, "
            "repro_torch.core.tsqr, repro_torch.kernels.macro_ops, "
            "repro_torch.kernels._build, repro_torch.kernels.ops, "
            "repro_torch.kernels.tile_ops, repro_torch.kernels.ref, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.fault_tolerance, "
            "repro_torch.launch.mesh, repro_torch.launch.train, "
            "repro_torch.training.trainer, repro_torch.checkpoint.manager, "
            "repro_torch.optim.qr_muon; "
            "repro_torch.plan((4096, 4096), backend='cuda'); "
            "repro_torch.plan((2048, 2048), backend='cuda'); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(src),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

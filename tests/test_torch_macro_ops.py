"""The port's macro-op bodies (``repro_torch.kernels.macro_ops``) against
the JAX package's (``repro.kernels.macro_ops``); each CUDA kernel against
its plain version on a Hopper card is in tests/test_torch_cuda.py.

Inputs are made with numpy from fixed seeds and handed to both packages.
Every batch holds a random tile, one with an exactly zero column, and one
zero-padded like ``tiled_qr``'s padding (rows and columns past nb/2 are
zero), so the exact ``tau = 0`` branch runs.  float64 rows enable x64 on
the JAX side with the scoped ``jax.enable_x64(True)``.

Tolerance: the two packages sum in different orders, so results differ
by rounding, amplified at most by the nb-step column loops:
``|port - jax| <= 50 * eps * nb * max(1, max |jax|)``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.kernels import macro_ops as jmo
from repro_torch.core import blocked as tblocked
from repro_torch.core import engine
from repro_torch.kernels import macro_ops as tmo
from worker_threads import share_the_cores  # noqa: F401  (autouse)

NBS = (4, 8, 16)
DTYPES = ("float32", "float64")


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _tiles(nb, seed, batch=3):
    """(batch, nb, nb): random / zero column / zero-padded."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((batch, nb, nb))
    t[1, :, nb // 3] = 0.0
    t[2, nb // 2:, :] = 0.0
    t[2, :, nb // 2:] = 0.0
    return t


def _close(got, want, dtype, nb):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    tol = 50 * np.finfo(dtype).eps * nb * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _run(jfn, tfn, args, dtype, nb):
    """Run the JAX body (vmapped) and the port's body on the same inputs."""
    with _x64(dtype):
        jout = jax.vmap(jfn)(*(jnp.asarray(a.astype(dtype)) for a in args))
        jout = jax.tree_util.tree_map(np.asarray, jout)
    tout = tfn(*(torch.from_numpy(a.astype(dtype)) for a in args))
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert t.dtype == getattr(torch, dtype)
        _close(t.numpy(), j, dtype, nb)
    return jout, tout


def _unit_lower(nb, seed):
    return np.asarray(tblocked.unpack_v_panel(
        torch.from_numpy(_tiles(nb, seed)), 0))


# Each body with the inputs it takes: (jax body, port body, input maker).
_BODIES = {
    "panel_body": (lambda a: jmo.panel_body(a, 0),
                   lambda a: tmo.panel_body(a, 0),
                   lambda nb: (_tiles(nb, 1),)),
    "panel_body_row0": (lambda a: jmo.panel_body(a, 2),
                        lambda a: tmo.panel_body(a, 2),
                        lambda nb: (_tiles(nb, 2),)),
    "wy_body": (jmo.wy_body, tmo.wy_body,
                lambda nb: (_unit_lower(nb, 3), _tiles(nb, 4), _tiles(nb, 5))),
    "larft": (jblocked.larft, tblocked.larft,
              lambda nb: (_unit_lower(nb, 6), _tiles(nb, 7)[:, 0, :])),
    "stacked_larft": (jmo.stacked_larft, tmo.stacked_larft,
                      lambda nb: (_tiles(nb, 8), _tiles(nb, 9)[:, 0, :])),
    "geqrt_body": (jmo.geqrt_body, tmo.geqrt_body,
                   lambda nb: (_tiles(nb, 10),)),
    "larfb_body": (jmo.larfb_body, tmo.larfb_body,
                   lambda nb: (_tiles(nb, 11), _tiles(nb, 12), _tiles(nb, 13))),
    "tsqrt_factor": (jmo.tsqrt_factor, tmo.tsqrt_factor,
                     lambda nb: (_tiles(nb, 14), _tiles(nb, 15))),
    "tsqrt_body": (jmo.tsqrt_body, tmo.tsqrt_body,
                   lambda nb: (_tiles(nb, 16), _tiles(nb, 17))),
    "ssrfb_body": (jmo.ssrfb_body, tmo.ssrfb_body,
                   lambda nb: (_tiles(nb, 18), _tiles(nb, 19), _tiles(nb, 20),
                               _tiles(nb, 21))),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("body", sorted(_BODIES))
def test_body_matches_jax(body, nb, dtype):
    jfn, tfn, make = _BODIES[body]
    _run(jfn, tfn, make(nb), dtype, nb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", NBS)
def test_zero_padding_gives_exact_tau_zero(nb, dtype):
    """Zero-padded columns factor to tau = 0 exactly, in both packages,
    for GEQRT and for TSQRT with an all-zero sub tile."""
    t = _tiles(nb, 30)
    jout, tout = _run(jmo.geqrt_body, tmo.geqrt_body, (t,), dtype, nb)
    assert (tout[2][2, nb // 2:] == 0).all() and (jout[2][2, nb // 2:] == 0).all()
    assert (tout[2][1] != 0).any()
    sub = _tiles(nb, 31)
    sub[0] = 0.0
    jout, tout = _run(jmo.tsqrt_body, tmo.tsqrt_body, (_tiles(nb, 32), sub),
                      dtype, nb)
    assert (tout[3][0] == 0).all() and (jout[3][0] == 0).all()
    assert (tout[1][0] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_reflector_coeffs_matches_jax(dtype):
    x0 = np.array([1.5, -2.0, 0.0, 0.0, 3.0, -0.0, 1e-3])
    tail2 = np.array([4.0, 1.0, 2.0, 0.0, 0.0, 0.0, 1e-8])
    with _x64(dtype):
        jout = [np.asarray(x) for x in jmo.reflector_coeffs(
            jnp.asarray(x0.astype(dtype)), jnp.asarray(tail2.astype(dtype)))]
    tout = tmo.reflector_coeffs(torch.from_numpy(x0.astype(dtype)),
                                torch.from_numpy(tail2.astype(dtype)))
    for j, t in zip(jout, tout):
        _close(t.numpy(), j, dtype, 1)
    beta, tau, denom = (t.numpy() for t in tout)
    degen = tail2 == 0
    assert (tau[degen] == 0).all() and (denom[degen] == 1).all()
    assert (beta[degen] == x0[degen].astype(dtype)).all()


def test_macro_op_cards_match_reference():
    for kind, op in tmo.MACRO_OPS.items():
        ref = jmo.MACRO_OPS[kind]
        assert (op.tile_reads, op.tile_writes, op.vmem_tiles) == (
            ref.tile_reads, ref.tile_writes, ref.vmem_tiles)
    assert tmo.MEGAKERNEL_SMEM_TILES == jmo.MEGAKERNEL_VMEM_TILES
    for nb in NBS:
        assert tmo.engine_vmem_bytes(nb, 8) == jmo.engine_vmem_bytes(nb, 8)


def test_kernel_shared_memory_is_what_the_budget_checks_read():
    """The launch size and the budget checks read one number per kind:
    the kernel's layout in elements.  GEQRT and TSQRT carry T at pitch
    nb + 1 and the column loop's exchange buffer; LARFB and SSRFB run the
    update walk: four operand slots of two buffers (one where two do not
    fit) and two scratch tiles, nb rows at the operand pitch (nb in fp32,
    nb + 4 in fp64 at nb = 32, where the DMMA fragments need it) — the
    largest."""
    nb = 32
    xch = 2 * (8 * 32 + 32) + 32
    assert tmo.XCH_ELEMS == xch
    assert (tmo.operand_pitch(nb, 4), tmo.operand_pitch(nb, 8)) == (32, 36)
    assert [tmo.smem_bytes(k, nb, 4) for k in tmo.MACRO_OPS] == [
        (3 * nb * nb + 2 * nb + xch) * 4, 10 * nb * nb * 4,
        (4 * nb * nb + 2 * nb + xch) * 4, 10 * nb * nb * 4]
    assert tmo.smem_bytes("SSRFB", nb, 4) == tmo.walk_smem_bytes(nb, 4)
    assert tmo.engine_smem_bytes(nb, 8) == 10 * nb * 36 * 8
    # At nb = 98 only one buffer fits.
    assert tmo.walk_stages(98, 4) == 1
    assert tmo.engine_smem_bytes(98, 4) == 6 * 98 * 98 * 4
    budget = engine.DEFAULT_SMEM_BUDGET
    fits = [nb for nb in range(1, 129) if tmo.engine_smem_bytes(nb, 4) <= budget]
    assert max(fits) == 98
    engine.check_smem(98, 4)
    with pytest.raises(ValueError, match="shared-memory budget"):
        engine.check_smem(99, 4)


@pytest.mark.parametrize("kind", ["GEQRT", "LARFB", "TSQRT", "SSRFB"])
def test_wrapper_on_cpu_runs_plain_version_without_launching(kind):
    """On a CPU workspace each wrapper equals its plain version and counts
    no launch."""
    p, q, nb = 3, 3, 8
    rng = np.random.default_rng(40)
    state = engine.FactorState(*(torch.from_numpy(rng.standard_normal(s))
                                 for s in [(p, q, nb, nb), (3, nb, nb), (3, nb),
                                           (p, 3, nb, nb), (p, 3, nb)]))
    idx = torch.tensor({"GEQRT": [[0, 0, 0], [2, 2, 2]], "LARFB": [[0, 0, 1]],
                        "TSQRT": [[0, 1, 0], [1, 2, 1]],
                        "SSRFB": [[0, 1, 2]]}[kind], dtype=torch.int32)
    a = engine.FactorState(*(x.clone() for x in state))
    b = engine.FactorState(*(x.clone() for x in state))
    before = dict(tmo.LAUNCHES)
    tmo.run_batch(kind, a, idx, use_kernel=True)
    tmo.run_batch(kind, b, idx, use_kernel=False)
    assert tmo.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.tiles, state.tiles)


def test_wrapper_checks_shapes_and_index_dtype():
    tiles = torch.zeros(2, 2, 4, 4)
    with pytest.raises(ValueError):
        tmo.geqrt(tiles, torch.zeros(2, 4, 4), torch.zeros(2, 4),
                  torch.zeros(1, 3, dtype=torch.int64))
    with pytest.raises(ValueError):
        tmo.larfb(tiles, torch.zeros(3, 4, 4), torch.zeros(1, 3, dtype=torch.int32))

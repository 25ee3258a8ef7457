"""The port's CUDA kernels on a Hopper card, against their plain
versions: the four wavefront macro-op kernels and both megakernels.

Every test is marked ``cuda`` and skips without an sm_90 device.  The
file imports torch, numpy and ``repro_torch`` only, so it also runs where
the JAX package is not installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerance of one kernel launch against its plain version: 4 * eps * nb *
max(1, max |plain|), a few nb-term sums' summation-order rounding; a NaN
on either side fails.  Lowerings that run the same task bodies on the
same inputs (megakernel and wavefront kernels; a batched slice and its
single run) must agree bitwise.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine
from repro_torch.kernels import macro_ops as tmo


def _need_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")


def _workspace(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ragged(ws):
    """Odd slices of a stack hold a matrix nb/2 rows and columns short of
    the grid, zero-padded, as a shape bucket stages them."""
    h = ws.shape[-1] // 2
    ws[1::2, -1, :, h:, :] = 0
    ws[1::2, :, -1, :, h:] = 0
    return ws


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["GEQRT", "LARFB", "TSQRT", "SSRFB"])
def test_kernel_matches_plain_on_hopper(kind, dtype):
    """Each CUDA kernel against its plain version on the card, on a
    (4, 5) grid at nb = 32 with the schedule's largest batch of its kind.
    Tolerance: 4 * eps * nb * max(1, max |plain|), a few nb-term sums'
    summation-order rounding (chip_smoke.py measured at most about a
    ninth of it at the main path's shapes); a NaN on either side fails."""
    _need_hopper()
    p, q, nb = 4, 5, 32
    r = min(p, q)
    rng = np.random.default_rng(50)
    dt = getattr(torch, dtype)
    state = engine.FactorState(*(
        torch.from_numpy(rng.standard_normal(s)).to("cuda", dt)
        for s in [(p, q, nb, nb), (r, nb, nb), (r, nb), (p, r, nb, nb), (p, r, nb)]))
    idx_np = max((lv[kind] for lv in engine.wavefront_task_arrays(p, q)
                  if kind in lv), key=len)
    idx = torch.from_numpy(idx_np).cuda()
    a = engine.FactorState(*(x.clone() for x in state))
    b = engine.FactorState(*(x.clone() for x in state))
    before = tmo.LAUNCHES[kind]
    tmo.run_batch(kind, a, idx, use_kernel=True)
    tmo.run_batch(kind, b, idx, use_kernel=False)
    torch.cuda.synchronize()
    assert tmo.LAUNCHES[kind] == before + 1
    scale = max(1.0, max(float(y.abs().max()) for y in b))
    tol = 4 * torch.finfo(dt).eps * nb * scale
    for x, y in zip(a, b):
        assert torch.isfinite(x).all() and torch.isfinite(y).all()
        assert float((x - y).abs().max()) <= tol



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p,q", [(8, 8), (5, 3)])
def test_megakernels_match_plain_walk_on_hopper(p, q, dtype):
    """Both megakernels against their plain walks within 4 * eps * nb *
    max(1, max |plain|) (chip_smoke.py's kernel tolerance), the megakernel
    against the wavefront kernels bitwise, and each batched slice against
    a single megakernel run bitwise."""
    _need_hopper()
    nb = 32
    dt = getattr(torch, dtype)
    table = engine.megakernel_table(p, q, torch.device("cuda"))
    base = torch.from_numpy(_ragged(_workspace((3, p, q, nb, nb), 60, dtype))).cuda()
    tol = 4 * torch.finfo(dt).eps * nb
    single = engine.init_state(base[0].clone())
    plain = engine.init_state(base[0].clone())
    wave = engine.init_state(base[0].clone())
    tmo.megakernel(single, *table)
    tmo.megakernel_plain(plain, *table)
    engine.run_levels(wave, use_kernel=True)
    stacked = engine.init_state(base.clone())
    stacked_plain = engine.init_state(base.clone())
    tmo.megakernel_batched(stacked, *table)
    tmo.megakernel_batched_plain(stacked_plain, *table)
    torch.cuda.synchronize()
    for got, want in ((single, plain), (stacked, stacked_plain)):
        scale = max(1.0, max(float(y.abs().max()) for y in want))
        for x, y in zip(got, want):
            assert torch.isfinite(x).all() and torch.isfinite(y).all()
            assert float((x - y).abs().max()) <= tol * scale
    for x, y in zip(single, wave):
        assert torch.equal(x, y)
    for b in range(3):
        alone = engine.init_state(base[b].clone())
        tmo.megakernel(alone, *table)
        torch.cuda.synchronize()
        for x, y in zip(stacked, alone):
            assert torch.equal(x[b], y)


@pytest.mark.cuda
def test_qr_on_a_stack_is_one_launch_on_hopper():
    """``repro_torch.qr`` on a (4, 256, 256) stack: one batched megakernel
    launch, every slice inside the conformance bar."""
    _need_hopper()
    a = torch.from_numpy(_workspace((4, 256, 256), 61, "float32")).cuda()
    tmo.reset_launch_counts()
    q, r = repro_torch.qr(a)
    torch.cuda.synchronize()
    assert {k: v for k, v in tmo.LAUNCHES.items() if v} == {
        "MEGAKERNEL_BATCHED": 1}
    bar = 100 * np.finfo(np.float32).eps * 256
    q64, r64, a64 = q.double(), r.double(), a.double()
    eye = torch.eye(256, dtype=torch.float64, device="cuda")
    assert float((q64.mT @ q64 - eye).abs().max()) <= bar
    assert float((torch.linalg.matrix_norm(a64 - q64 @ r64)
                  / torch.linalg.matrix_norm(a64)).max()) <= bar

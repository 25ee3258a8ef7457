"""The port's CUDA kernels on a Hopper card, against their plain
versions: the four wavefront macro-op kernels (their task bodies at
several tile sizes), the Q-formation updates, both megakernels over the
factorization's and Q formation's tables, the MHT panel kernel on each
of its paths, the WY trailing kernel, and the single-tile TSQRT / SSRFB
entry points; and the QR service on the card (one batched megakernel
launch a bucket, fault recovery, ``qr(verify=True)``).

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
from repro_torch.core import blocked, engine
from repro_torch.core import tilegraph as ttg
from repro_torch.kernels import macro_ops as tmo
from repro_torch.kernels import ops, tile_ops
from worker_threads import share_the_cores  # noqa: F401  (autouse)


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
@pytest.mark.parametrize("nb", [16, 32, 64])
@pytest.mark.parametrize("kind", ["GEQRT", "LARFB", "TSQRT", "SSRFB"])
def test_tile_bodies_match_plain_on_hopper(kind, nb, dtype):
    """Each task body at nb in {16, 32, 64} (the register column loops
    below 32, the shared-memory ones above) against its plain version on a
    (3, 3) grid holding a tile with an exactly zero tail column (the
    tau = 0 path) and a zero-padded ragged tile, within 4 * eps * nb *
    max(1, max |plain|); the zero columns give exactly tau = 0 on both
    sides."""
    _need_hopper()
    p = q = 3
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(80 + nb)
    state = engine.FactorState(*(
        torch.from_numpy(rng.standard_normal(s)).to("cuda", dt)
        for s in [(p, q, nb, nb), (p, nb, nb), (p, nb), (p, p, nb, nb),
                  (p, p, nb)]))
    # A zero column stays zero under the updates before it, so its tail is
    # exactly zero when it pivots: column 3 of diagonal tile (0, 0), and
    # column 5 of the stacked pair [triu((0, 0)); (1, 0)].
    state.tiles[0, 0, :, 3] = 0
    state.tiles[0, 0, :5, 5] = 0
    state.tiles[1, 0, :, 5] = 0
    h = nb // 2                            # tile (2, 2): ragged, zero-padded
    state.tiles[2, 2, h:, :] = 0
    state.tiles[2, 2, :, h:] = 0
    idx = torch.tensor({"GEQRT": [[0, 0, 0], [2, 2, 2]], "LARFB": [[0, 0, 1]],
                        "TSQRT": [[0, 1, 0]], "SSRFB": [[0, 1, 2]]}[kind],
                       dtype=torch.int32, device="cuda")
    a = engine.FactorState(*(x.clone() for x in state))
    b = engine.FactorState(*(x.clone() for x in state))
    before = tmo.LAUNCHES[kind]
    tmo.run_batch(kind, a, idx, use_kernel=True)
    tmo.run_batch(kind, b, idx, use_kernel=False)
    torch.cuda.synchronize()
    assert tmo.LAUNCHES[kind] == before + 1
    _within(tuple(a), tuple(b), nb, dt)
    if kind == "GEQRT":
        for x in (a, b):
            assert float(x.d_taus[0, 3]) == 0.0
            assert bool((x.d_taus[2, h:] == 0).all())
    if kind == "TSQRT":
        for x in (a, b):
            assert float(x.t_taus[1, 0, 5]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p,q,batch", [(8, 8, 3), (5, 3, 3), (5, 3, 7)])
def test_megakernels_match_plain_walk_on_hopper(p, q, batch, dtype):
    """Both megakernels against their plain walks within 4 * eps * nb *
    max(1, max |plain|) (chip_smoke.py's kernel tolerance), the megakernel
    against the wavefront kernels bitwise, and each batched slice against
    a single megakernel run bitwise; 7 slices of a (5, 3) grid give runs
    that cross slice boundaries."""
    _need_hopper()
    nb = 32
    dt = getattr(torch, dtype)
    table = engine.megakernel_table(p, q, torch.device("cuda"))
    base = torch.from_numpy(_ragged(_workspace((batch, p, q, nb, nb), 60,
                                               dtype))).cuda()
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
    for b in range(batch):
        alone = engine.init_state(base[b].clone())
        tmo.megakernel(alone, *table)
        torch.cuda.synchronize()
        for x, y in zip(stacked, alone):
            assert torch.equal(x[b], y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_megakernel_at_nb64_on_hopper(dtype):
    """At nb = 64 the megakernel's operand slots hold two buffers in fp32
    and one in fp64 (the double buffers do not fit): both walks against
    their plain versions within 4 * eps * nb * max(1, max |plain|), the
    megakernel equal to the wavefront kernels and every batched slice to
    its single run, bitwise."""
    _need_hopper()
    p, q, nb, batch = 4, 3, 64, 3
    dt = getattr(torch, dtype)
    assert tmo.megakernel_stages(nb, dt.itemsize) == (2 if dtype == "float32"
                                                       else 1)
    table = engine.megakernel_table(p, q, torch.device("cuda"))
    base = torch.from_numpy(_ragged(_workspace((batch, p, q, nb, nb), 62,
                                               dtype))).cuda()
    single = engine.init_state(base[0].clone())
    plain = engine.init_state(base[0].clone())
    wave = engine.init_state(base[0].clone())
    tmo.megakernel(single, *table)
    tmo.megakernel_plain(plain, *table)
    engine.run_levels(wave, use_kernel=True)
    stacked = engine.init_state(base.clone())
    tmo.megakernel_batched(stacked, *table)
    torch.cuda.synchronize()
    _within(tuple(single), tuple(plain), nb, dt)
    for x, y in zip(single, wave):
        assert torch.equal(x, y)
    for b in range(batch):
        alone = engine.init_state(base[b].clone())
        tmo.megakernel(alone, *table)
        torch.cuda.synchronize()
        for x, y in zip(stacked, alone):
            assert torch.equal(x[b], y)


@pytest.mark.cuda
def test_qr_on_a_stack_is_one_launch_on_hopper():
    """``repro_torch.qr`` on a (4, 256, 256) stack: one batched megakernel
    launch factors it and one over the Q table forms Q, every slice inside
    the conformance bar."""
    _need_hopper()
    a = torch.from_numpy(_workspace((4, 256, 256), 61, "float32")).cuda()
    tmo.reset_launch_counts()
    q, r = repro_torch.qr(a)
    torch.cuda.synchronize()
    assert {k: v for k, v in tmo.LAUNCHES.items() if v} == {
        "MEGAKERNEL_BATCHED": 1, "MEGAKERNEL_Q_BATCHED": 1}
    bar = 100 * np.finfo(np.float32).eps * 256
    q64, r64, a64 = q.double(), r.double(), a.double()
    eye = torch.eye(256, dtype=torch.float64, device="cuda")
    assert float((q64.mT @ q64 - eye).abs().max()) <= bar
    assert float((torch.linalg.matrix_norm(a64 - q64 @ r64)
                  / torch.linalg.matrix_norm(a64)).max()) <= bar


def _within(got, want, width, dt):
    """max |kernel - plain| <= 4 * eps * width * max(1, max |plain|)."""
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    tol = 4 * torch.finfo(dt).eps * width * scale
    for x, y in zip(got, want):
        assert torch.isfinite(x).all() and torch.isfinite(y).all()
        assert float((x - y).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,row0", [((3, 576, 32), 160), ((3000, 32), 0),
                                        ((16, 200), 0)], ids=str)
def test_mht_panel_matches_plain_on_hopper(shape, row0, dtype):
    """The panel kernel (one CTA per panel of a stack; row blocks of
    several CTAs meeting at group barriers for 3000 rows; a wide panel)
    against ``macro_ops.panel_body``, within 4 * eps * (pivot columns) *
    max(1, max |plain|), one launch each."""
    _need_hopper()
    dt = getattr(torch, dtype)
    a = torch.from_numpy(_workspace(shape, 70, dtype)).cuda()
    before = tmo.LAUNCHES["MHT_PANEL"]
    packed, taus = ops.mht_panel(a, row0=row0)
    want_p, want_t = tmo.panel_body(a, row0)
    torch.cuda.synchronize()
    assert tmo.LAUNCHES["MHT_PANEL"] == before + 1
    kf = taus.shape[-1]
    assert kf == min(shape[-1], shape[-2] - row0)
    _within((packed, taus), (want_p, want_t[..., :kf]), kf, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,path", [((4096, 32), "cluster"),
                                        ((30000, 32), "group")], ids=str)
def test_mht_panel_paths_on_hopper(shape, path, dtype):
    """The panel kernel on one shape of each path that ``layout`` picks: a
    (4096, 32) panel on one cluster of 16 CTAs, and a (30000, 32) panel,
    taller than a cluster holds, on a cooperative group; against
    ``macro_ops.panel_body`` within 4 * eps * 32 * max(1, max |plain|)."""
    _need_hopper()
    from repro_torch.kernels import mht_panel as kpanel

    dt = getattr(torch, dtype)
    assert kpanel.layout(*shape, torch.finfo(dt).bits // 8).path == path
    a = torch.from_numpy(_workspace(shape, 78, dtype)).cuda()
    before = tmo.LAUNCHES["MHT_PANEL"]
    packed, taus = ops.mht_panel(a)
    want_p, want_t = tmo.panel_body(a, 0)
    torch.cuda.synchronize()
    assert tmo.LAUNCHES["MHT_PANEL"] == before + 1
    assert kpanel.LAST_GRID["path"] == path
    _within((packed, taus), (want_p, want_t), shape[-1], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bmkn", [(3, 576, 32, 160), (1, 2000, 32, 300),
                                  (2, 40, 20, 7), (1, 4096, 32, 300),
                                  (1, 8000, 32, 64), (2, 30000, 32, 40)],
                         ids=str)
def test_wy_trailing_matches_plain_on_hopper(bmkn, dtype):
    """The trailing kernel on V and T of a factored panel, in place on a
    column view of a wider matrix, against ``macro_ops.wy_body`` within
    4 * eps * k * max(1, max |plain|); the columns left of the view are
    untouched.  One shape per layout: clusters of 3 (fp64: 6), 8 (fp64:
    8 at one CTA an SM), 1 and 16 CTAs sized for two CTAs an SM (4096 rows; fp64 one),
    16 CTAs at one an SM (8000 rows, fp32), and the streaming layout
    (30000 rows; 8000 in fp64)."""
    _need_hopper()
    from repro_torch.kernels import wy_trailing as ktrail

    bsz, m, k, n = bmkn
    dt = getattr(torch, dtype)
    lay = ktrail.layout(m, n, k, bsz, torch.finfo(dt).bits // 8)
    packed, taus = tmo.panel_body(
        torch.from_numpy(_workspace((bsz, m, k), 71, dtype)).cuda(), 0)
    v = blocked.unpack_v_panel(packed, 0)
    t = blocked.larft(v, taus)
    whole = torch.from_numpy(_workspace((bsz, m, n + 3), 72, dtype)).cuda()
    keep = whole[..., :3].clone()
    want = tmo.wy_body(v, t, whole[..., 3:])
    before = tmo.LAUNCHES["WY_TRAILING"]
    ops.wy_trailing_(v, t, whole[..., 3:])
    torch.cuda.synchronize()
    assert tmo.LAUNCHES["WY_TRAILING"] == before + 1
    assert ktrail.LAST_GRID["layout"] == lay.path
    assert ktrail.LAST_GRID["cluster"] == lay.cluster
    _within((whole[..., 3:],), (want,), k, dt)
    assert torch.equal(whole[..., :3], keep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_single_tile_entries_match_plain_on_hopper(dtype):
    """``tile_ops.tsqrt`` / ``ssrfb`` (the wavefront kernels on one staged
    task) against their plain bodies, within 4 * eps * nb * max(1,
    max |plain|)."""
    _need_hopper()
    nb = 32
    dt = getattr(torch, dtype)
    r_t = torch.triu(torch.from_numpy(_workspace((nb, nb), 73, dtype)).cuda())
    a_t = torch.from_numpy(_workspace((nb, nb), 74, dtype)).cuda()
    before = dict(tmo.LAUNCHES)
    got = tile_ops.tsqrt(r_t, a_t)
    want = tmo.tsqrt_factor(r_t[None], a_t[None])
    _within(got, [w[0] for w in want], nb, dt)
    _, v2, t2, _ = tmo.tsqrt_body(r_t[None], a_t[None])
    ck, ci = (torch.from_numpy(_workspace((nb, nb), s, dtype)).cuda()
              for s in (75, 76))
    got = tile_ops.ssrfb(v2[0], t2[0], ck, ci)
    want = tmo.ssrfb_body(v2, t2, ck[None], ci[None])
    torch.cuda.synchronize()
    _within(got, [w[0] for w in want], nb, dt)
    assert tmo.LAUNCHES["TSQRT_TILE"] == before["TSQRT_TILE"] + 1
    assert tmo.LAUNCHES["SSRFB_TILE"] == before["SSRFB_TILE"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 300, 96), (2500, 800), (12, 500),
                                   (2000, 120)], ids=str)
def test_qr_off_the_tiled_route_on_hopper(shape):
    """``repro_torch.qr`` through the auto route's panel path (blocked
    MHT on a stack and past the tiled ceiling, one wide panel, TSQR): only the
    panel and trailing kernels launch, and every matrix meets the
    conformance bar."""
    _need_hopper()
    a = torch.from_numpy(_workspace(shape, 77, "float32")).cuda()
    tmo.reset_launch_counts()
    q, r = repro_torch.qr(a)
    torch.cuda.synchronize()
    launched = {k for k, v in tmo.LAUNCHES.items() if v}
    assert "MHT_PANEL" in launched
    assert launched <= {"MHT_PANEL", "WY_TRAILING", "WY_TRAILING_Q"}
    m, n = shape[-2:]
    bar = 100 * np.finfo(np.float32).eps * max(m, n)
    q64, r64, a64 = q.double(), r.double(), a.double()
    eye = torch.eye(q.shape[-1], dtype=torch.float64, device="cuda")
    assert float((q64.mT @ q64 - eye).abs().max()) <= bar
    assert float((torch.linalg.matrix_norm(a64 - q64 @ r64)
                  / torch.linalg.matrix_norm(a64)).max()) <= bar


# ---------------------------------------------------------------------------
# Q formation and the update walk (DMMA products in fp64, FMA in fp32)
# ---------------------------------------------------------------------------

def _state(p, q, nb, dt, seed):
    rng = np.random.default_rng(seed)
    r = min(p, q)
    return engine.FactorState(*(
        torch.from_numpy(rng.standard_normal(s)).to("cuda", dt)
        for s in [(p, q, nb, nb), (r, nb, nb), (r, nb), (p, r, nb, nb),
                  (p, r, nb)]))


def _tf32_round(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nb", [16, 32, 64])
@pytest.mark.parametrize("kind", ["QLARFB", "QSSRFB"])
def test_q_kernels_match_plain_on_hopper(kind, nb, dtype):
    """Each Q update's walk kernel against its plain version on the Q
    schedule's largest batch of its kind (a 5 x 5 grid, qe = 5), within
    4 * eps * nb * max(1, max |plain|); the factored state is not
    written."""
    _need_hopper()
    p = q = qe = 5
    dt = getattr(torch, dtype)
    state = _state(p, q, nb, dt, 90 + nb)
    before = [x.clone() for x in state]
    idx = torch.from_numpy(max((lv[kind] for lv in engine.q_task_arrays(p, q, qe)
                                if kind in lv), key=len)).cuda()
    e0 = torch.from_numpy(_workspace((p, qe, nb, nb), 91, dtype)).cuda()
    got, want = e0.clone(), e0.clone()
    launched = tmo.LAUNCHES[kind]
    tmo.run_q_batch(kind, state, got, idx, use_kernel=True)
    tmo.run_q_batch(kind, state, want, idx, use_kernel=False)
    torch.cuda.synchronize()
    assert tmo.LAUNCHES[kind] == launched + 1
    _within((got,), (want,), nb, dt)
    assert all(torch.equal(x, y) for x, y in zip(state, before))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["LARFB", "SSRFB"])
def test_updates_beat_the_one_pass_tf32_control_on_hopper(kind, dtype):
    """The redesigned LARFB / SSRFB (the update walk: FMA passes in fp32,
    DMMA in fp64) within 4 * eps * nb * max(1, max |plain|) of the plain
    version on a 6 x 6 grid's largest batch, while the control misses
    that bound: in fp32 the plain version on inputs rounded to TF32 (one
    pass of TF32 products), in fp64 the kernel's outputs rounded to
    fp32."""
    _need_hopper()
    p = q = 6
    nb = 32
    dt = getattr(torch, dtype)
    state = _state(p, q, nb, dt, 95)
    idx = torch.from_numpy(max((lv[kind] for lv in engine.wavefront_task_arrays(p, q)
                                if kind in lv), key=len)).cuda()
    got = engine.FactorState(*(x.clone() for x in state))
    want = engine.FactorState(*(x.clone() for x in state))
    tmo.run_batch(kind, got, idx, use_kernel=True)
    tmo.run_batch(kind, want, idx, use_kernel=False)
    torch.cuda.synchronize()
    _within(got, want, nb, dt)
    if dt == torch.float32:
        ctrl = engine.FactorState(*(_tf32_round(x) for x in state))
        tmo.run_batch(kind, ctrl, idx, use_kernel=False)
        torch.cuda.synchronize()
    else:
        ctrl = [torch.where(g != s, g.float().double(), g)
                for g, s in zip(got, state)]
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    tol = 4 * torch.finfo(dt).eps * nb * scale
    assert max(float((c - w).abs().max()) for c, w in zip(ctrl, want)) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p,q", [(8, 8), (5, 3), (3, 5)])
def test_q_megakernel_equals_wavefront_on_hopper(p, q, dtype):
    """Q formation by one megakernel launch over the Q table equals the
    wavefront walk bitwise (both run the same update bodies on the same
    operands), reduced and full, and lies within 10 eps max(m, n) of the
    plain Q loop."""
    _need_hopper()
    nb = 32
    dt = getattr(torch, dtype)
    tiles = torch.from_numpy(_workspace((p, q, nb, nb), 93, dtype)).cuda()
    f = engine.factor_tiles(tiles, p=p, q=q, nb=nb, use_kernel=True,
                            dispatch_mode="wavefront")
    for ncols in (min(p, q) * nb, p * nb):
        tmo.reset_launch_counts()
        mega = engine.form_q_tiles(f, ncols, dispatch_mode="megakernel")
        torch.cuda.synchronize()
        assert {k: v for k, v in tmo.LAUNCHES.items() if v} == {"MEGAKERNEL_Q": 1}
        wave = engine.form_q_tiles(f, ncols, dispatch_mode="wavefront")
        plain = ttg._form_q_tiled(f, ncols)
        torch.cuda.synchronize()
        assert torch.equal(mega, wave)
        tol = 10 * torch.finfo(dt).eps * max(p, q) * nb
        assert float((ttg._join_tiles(mega) - plain).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_q_batched_slices_equal_single_runs_on_hopper(dtype):
    """A 7-slice (ragged) stack's Q by one batched megakernel launch:
    every slice equals the single megakernel's Q of it, bitwise."""
    _need_hopper()
    p, q, nb, batch = 5, 3, 32, 7
    dt = getattr(torch, dtype)
    tiles = torch.from_numpy(_ragged(_workspace((batch, p, q, nb, nb), 94,
                                                dtype))).cuda()
    f = engine.factor_tiles_batched(tiles, p=p, q=q, nb=nb, use_kernel=True,
                                    dispatch_mode="megakernel")
    tmo.reset_launch_counts()
    stacked = engine.form_q_tiles(f, p * nb, dispatch_mode="megakernel")
    torch.cuda.synchronize()
    assert {k: v for k, v in tmo.LAUNCHES.items() if v} == {
        "MEGAKERNEL_Q_BATCHED": 1}
    for b in range(batch):
        single = engine.form_q_tiles(engine.FactorState(*(x[b] for x in f)),
                                     p * nb, dispatch_mode="megakernel")
        assert torch.equal(stacked[b], single)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p,q", [(5, 3), (4, 6)])
def test_stacked_wavefront_equals_single_runs_on_hopper(p, q, dtype):
    """The wavefront kernels on a ragged 7-slice stack filled to 5: one
    launch per (level, kind) for the whole stack, to factor and to form Q
    (one schedule's launches); every filled slice's factored state and Q
    equal the single wavefront run of that slice bitwise, and slices 5-6
    stay the zero state and the identity Q."""
    _need_hopper()
    nb, batch, filled = 32, 7, 5
    dt = getattr(torch, dtype)
    ws = _ragged(_workspace((batch, p, q, nb, nb), 97, dtype))
    ws[filled:] = 0
    base = torch.from_numpy(ws).cuda()
    tmo.reset_launch_counts()
    f = engine.factor_tiles_batched(base.clone(), p=p, q=q, nb=nb,
                                    use_kernel=True,
                                    dispatch_mode="wavefront", filled=filled)
    e = engine.form_q_tiles(f, p * nb, dispatch_mode="wavefront",
                            filled=filled)
    torch.cuda.synchronize()
    assert {k: v for k, v in tmo.LAUNCHES.items() if v} == {
        k: v for k, v in dict(engine.dispatch_counts(p, q, batch=batch),
                              **engine.q_dispatch_counts(p, q, p,
                                                         batch=batch)).items()
        if v}
    zero = engine.init_state(torch.zeros_like(base[0]))
    eye = engine.q_workspace((), p, p, nb, dt, base.device)
    for b in range(batch):
        if b < filled:
            single = engine.factor_tiles(base[b].clone(), p=p, q=q, nb=nb,
                                         use_kernel=True,
                                         dispatch_mode="wavefront")
            e_single = engine.form_q_tiles(single, p * nb,
                                           dispatch_mode="wavefront")
        else:
            single, e_single = zero, eye
        torch.cuda.synchronize()
        for x, y in zip(f, single):
            assert torch.equal(x[b], y), b
        assert torch.equal(e[b], e_single), b


@pytest.mark.cuda
def test_stacked_wavefront_at_the_expert_class_on_hopper():
    """The qwen2-moe expert class's shape, 360 fp32 momenta of 2048 x
    1408 (a 64 x 44 grid at nb = 32, past the table budget, so the auto
    rule runs wavefront): one schedule's launches for the stack, and
    slices 0, 179 and 359 equal their single runs bitwise, factored state
    and thin Q.  Each field of the stack holds 4.15 GB, so slice 359's
    fields start past 2^31 bytes from their bases."""
    _need_hopper()
    p, q, nb, batch = 64, 44, 32, 360
    assert engine.resolve_dispatch_mode(p, q, nb) == "wavefront"
    g = torch.Generator(device="cuda").manual_seed(98)
    tiles = torch.randn((batch, p, q, nb, nb), generator=g, device="cuda")
    picks = (0, 179, 359)
    inputs = {b: tiles[b].clone() for b in picks}
    assert 359 * tiles[0].numel() * 4 > 2 ** 31
    tmo.reset_launch_counts()
    f = engine.factor_tiles_batched(tiles, p=p, q=q, nb=nb, use_kernel=True)
    e = engine.form_q_tiles(f, q * nb)
    torch.cuda.synchronize()
    assert {k: v for k, v in tmo.LAUNCHES.items() if v} == dict(
        engine.dispatch_counts(p, q, batch=batch),
        **engine.q_dispatch_counts(p, q, q, batch=batch))
    for b in picks:
        single = engine.factor_tiles(inputs.pop(b), p=p, q=q, nb=nb,
                                     use_kernel=True)
        e_single = engine.form_q_tiles(single, q * nb)
        torch.cuda.synchronize()
        for x, y in zip(f, single):
            assert torch.equal(x[b], y), b
        assert torch.equal(e[b], e_single), b
        del single, e_single


@pytest.mark.cuda
def test_qr_forms_q_on_the_kernels_on_hopper():
    """``repro_torch.qr`` at 640^2 forms Q in one megakernel launch and at
    1024^2 (wavefront) in at most two launches a Q level, no eager loop;
    each Q within 4 sqrt(N) eps of the plain lowering's and inside the
    conformance bar."""
    _need_hopper()
    eps = float(np.finfo(np.float32).eps)
    for n, want in ((640, {"MEGAKERNEL": 1, "MEGAKERNEL_Q": 1}), (1024, None)):
        a = torch.from_numpy(_workspace((n, n), 96, "float32")).cuda()
        tmo.reset_launch_counts()
        qk, rk = repro_torch.qr(a)
        torch.cuda.synchronize()
        launches = {k: v for k, v in tmo.LAUNCHES.items() if v}
        g = n // 32
        if want is None:
            want = dict(engine.dispatch_counts(g, g),
                        **engine.q_dispatch_counts(g, g, g))
            assert launches["QLARFB"] + launches["QSSRFB"] <= \
                2 * len(engine.q_task_arrays(g, g, g))
        assert launches == want
        q0, _ = repro_torch.qr(a, config=repro_torch.QRConfig(use_kernel=False))
        assert float((qk - q0).abs().max()) <= 4 * n ** 0.5 * eps
        q64 = qk.double()
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        assert float((q64.mT @ q64 - eye).abs().max()) <= 100 * eps * n


# ---------------------------------------------------------------------------
# the QR service on the card
# ---------------------------------------------------------------------------

def _serving_wave(seed):
    shapes = [(128, 128), (120, 110), (96, 64), (64, 64), (130, 120)] * 2
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.cuda
def test_service_runs_one_batched_megakernel_per_bucket_on_hopper():
    """A warm wave of the serving mix: one batched megakernel launch per
    bucket and one over its Q table, no plan built, no escalation, every
    answer on the card inside the conformance bar of its own shape."""
    _need_hopper()
    from repro_torch.serving import QRService

    svc = QRService(verify=True)
    svc.submit_many(_serving_wave(0))
    compiles = svc.stats()["compiles"]
    wave = _serving_wave(1)
    tmo.reset_launch_counts()
    results = svc.submit_many(wave)
    launches = {k: v for k, v in tmo.LAUNCHES.items() if v}
    buckets = {k for k, _, _ in svc._plans}
    assert launches == {"MEGAKERNEL_BATCHED": len(buckets),
                        "MEGAKERNEL_Q_BATCHED": len(buckets)}
    assert svc.stats()["compiles"] == compiles
    assert svc.stats()["escalations"] == 0
    eps = float(np.finfo(np.float32).eps)
    for a, res in zip(wave, results):
        assert res.ok and res.q.device.type == "cuda"
        q, r = res.q.double().cpu().numpy(), res.r.double().cpu().numpy()
        bar = 100 * eps * max(a.shape)
        assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) <= bar
        assert np.abs(q.T @ q - np.eye(q.shape[1])).max() <= bar


@pytest.mark.cuda
def test_service_faults_recover_on_hopper():
    """A budget (vmem) fault walks the bucket from the megakernel to the
    wavefront kernels at plan time; a dispatch fault recovers each
    request below the bucket's rung; every answer stays inside the bar."""
    _need_hopper()
    from repro_torch.robustness import inject
    from repro_torch.serving import QRService

    wave = _serving_wave(2)[:4]
    eps = float(np.finfo(np.float32).eps)
    for fault, hop in ((inject.Fault(site="vmem", match="megakernel"),
                        ("megakernel", "wavefront", "injected_vmem")),
                       (inject.Fault(site="dispatch", match="128x128"),
                        ("megakernel", "per-request", "injected_dispatch"))):
        svc = QRService(verify=True)
        with inject.active(fault):
            results = svc.submit_many(wave)
        assert hop in [(e.rung_from, e.rung_to, e.rule)
                       for e in svc.escalations]
        for a, res in zip(wave, results):
            assert res.ok and res.r.device.type == "cuda"
            q, r = res.q.double().cpu().numpy(), res.r.double().cpu().numpy()
            assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) <= \
                100 * eps * max(a.shape)


@pytest.mark.cuda
def test_qr_verify_on_hopper():
    """``qr(verify=True)`` on the card: the health check runs on the card
    and escalates nothing on healthy input; the answer is the unverified
    solve's."""
    _need_hopper()
    from repro_torch.observability import metrics

    a = torch.from_numpy(_workspace((3, 256, 256), 97, "float32")).cuda()
    before = metrics.counter_total("robustness.escalations")
    q, r = repro_torch.qr(a, config=repro_torch.QRConfig(verify=True))
    q0, r0 = repro_torch.qr(a)
    assert metrics.counter_total("robustness.escalations") == before
    assert torch.equal(q, q0) and torch.equal(r, r0)


@pytest.mark.cuda
def test_batched_orthogonalize_runs_the_kernels_on_hopper():
    """A Muon step's classes on the card: a (3, 288, 288) class on the
    batched megakernel (one launch and one over its Q table), a (3, 288,
    96) class on the panel kernels; every O within 4 sqrt(N) eps of the
    plain lowering's on the card (well-conditioned Gaussian momenta)."""
    _need_hopper()
    from repro_torch.optim import batched_orthogonalize

    torch.backends.cuda.matmul.allow_tf32 = False
    leaves = [torch.from_numpy(_workspace(s, 98 + i, "float32")).cuda()
              for i, s in enumerate([(3, 288, 288), (3, 96, 288)])]
    tmo.reset_launch_counts()
    outs = batched_orthogonalize(leaves)
    torch.cuda.synchronize()
    launches = {k: v for k, v in tmo.LAUNCHES.items() if v}
    assert launches["MEGAKERNEL_BATCHED"] == 1
    assert launches["MEGAKERNEL_Q_BATCHED"] == 1
    assert launches["MHT_PANEL"] > 0
    plain = batched_orthogonalize(
        leaves, config=repro_torch.QRConfig(use_kernel=False))
    eps = float(torch.finfo(torch.float32).eps)
    for leaf, o, o0 in zip(leaves, outs, plain):
        assert o.shape == leaf.shape and o.device.type == "cuda"
        assert float((o - o0).abs().max()) <= 4 * 288 ** 0.5 * eps


@pytest.mark.cuda
def test_training_step_on_hopper():
    """Two QR-Muon steps of the smollm-135m smoke model on the card with
    batched orthogonalization: finite losses, within 1e-3 relative of the
    same run whose orthogonalization runs the plain lowering."""
    _need_hopper()
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.models import init_params
    from repro_torch.training import RunConfig, TrainConfig, Trainer

    cfg = get_smoke_config("smollm-135m")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    start = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    losses = []
    for qc in (None, repro_torch.QRConfig(use_kernel=False)):
        tr = Trainer(cfg, TrainConfig(batched_ortho=True, qr_config=qc),
                     RunConfig(total_steps=2, warmup_steps=1, log_every=1),
                     data, device="cuda", log_fn=lambda s: None,
                     params=copy.deepcopy(start))
        losses.append([m["loss"] for m in tr.run()["history"]])
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


@pytest.mark.cuda
def test_sweep_writes_a_cache_plan_selects_on_hopper(tmp_path):
    """A 256^2 sweep on the card (reps 1) times the kernel candidates,
    writes a cache that passes its gate, and ``plan`` then selects the
    entry's pick through the ``tuned`` rule; the active cache is restored
    afterwards."""
    from repro_torch.tuning import TuningCache, set_active_cache
    from repro_torch.tuning.sweep import check_cache, sweep_shapes

    _need_hopper()
    tmo.reset_launch_counts()
    cache = sweep_shapes([(256, 256)], reps=1, device="cuda")
    (e,) = cache.entries()
    assert e.backend == "cuda"
    assert e.device_kind == torch.cuda.get_device_name()
    assert {"tiled[b32,wavefront]", "tiled[b32,megakernel]",
            "tiled[b64,wavefront]", "geqrf_ht"} <= set(e.timings_dict)
    assert tmo.LAUNCHES["MEGAKERNEL"] > 0 and tmo.LAUNCHES["SSRFB"] > 0
    assert check_cache(cache) == []
    path = str(tmp_path / "sweep.json")
    cache.save(path)
    prev = set_active_cache(TuningCache.load(path))
    try:
        s = repro_torch.plan((256, 256), torch.float32, explain=True)
        assert s.explain.selected.rule == "tuned"
        assert (s.config.method, s.config.use_kernel) == (
            e.best.method, e.best.use_kernel)
    finally:
        set_active_cache(prev)


@pytest.mark.cuda
def test_mesh_training_on_hopper(tmp_path):
    """Two QR-Muon steps of the smollm-135m smoke model with
    ``qr_shard_leaves`` on a (1, 1) CUDA mesh (one gloo rank): the state
    placed as DTensors on the card, the stacks on the kernels, finite
    losses within 1e-3 relative of the mesh-free run's."""
    _need_hopper()
    import copy

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.models import init_params
    from repro_torch.training import RunConfig, TrainConfig, Trainer

    cfg = get_smoke_config("smollm-135m")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    start = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        losses = []
        for m in (None, mesh):
            tr = Trainer(cfg, TrainConfig(qr_shard_leaves=True),
                         RunConfig(total_steps=2, warmup_steps=1,
                                   log_every=1),
                         data, device="cuda", mesh=m, log_fn=lambda s: None,
                         params=copy.deepcopy(start))
            tmo.reset_launch_counts()
            losses.append([h["loss"] for h in tr.run()["history"]])
            if m is not None:
                p = next(iter(tr.state.params.parameters()))
                assert isinstance(p, DTensor) and p.device.type == "cuda"
                assert sum(tmo.LAUNCHES.values()) > 0
    finally:
        dist.destroy_process_group()
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3)

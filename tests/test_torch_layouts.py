"""Host-side shapes of the port's redesigned kernels, on the CPU: the
trailing kernel's layout (``kernels/wy_trailing.py: layout``), the
megakernel's shared-memory sizing against the engine's guards and the
reference's auto rule, and the megakernel's runs
(``engine.megakernel_runs``), the contiguous pieces of each level's work
list its CTAs walk with tile reuse and one-ahead prefetch.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what they are handed is decided here, in Python, from the shape alone.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import engine as teng
from repro_torch.kernels import macro_ops as tmo
from repro_torch.kernels import ops as tops
from repro_torch.kernels import wy_trailing as ttrail
from worker_threads import share_the_cores  # noqa: F401  (autouse)

tplan = importlib.import_module("repro_torch.core.plan")

BUDGET = teng.DEFAULT_SMEM_BUDGET


# ---------------------------------------------------------------------------
# wy_trailing: cluster or streaming layout
# ---------------------------------------------------------------------------

# (batch, m, k, n), itemsize -> (path, cluster, per_sm): the main paths'
# shapes (a 4096^2 panel step, the (60, 576, 192) stack's first step, the
# (8, 6144, 576) TSQR leaves' first step) and a panel past the cluster.
LAYOUTS = [
    ((1, 4096, 32, 4064), 4, ("cluster", 16, 2)),
    ((1, 4096, 32, 4064), 8, ("cluster", 16, 1)),
    ((60, 576, 32, 160), 4, ("cluster", 3, 2)),
    ((60, 576, 32, 160), 8, ("cluster", 6, 2)),
    ((8, 6144, 32, 544), 4, ("cluster", 16, 1)),
    ((8, 6144, 32, 544), 8, ("streaming", 0, 0)),
    ((1, 30000, 32, 32), 4, ("streaming", 0, 0)),
    ((1, 30000, 32, 32), 8, ("streaming", 0, 0)),
    ((1, 16, 16, 984), 4, ("cluster", 1, 2)),
    ((2, 40, 20, 7), 8, ("cluster", 1, 2)),
]


@pytest.mark.parametrize("bmkn,itemsize,want", LAYOUTS, ids=str)
def test_wy_trailing_layout_per_shape(bmkn, itemsize, want):
    """The layout each main-path shape takes: a cluster of at most 16 CTAs
    whose rows (a multiple of 8) cover C, in shared memory within the
    budget (two CTAs an SM where it says so), with the carve-up of
    ``csrc/wy_trailing.cu``; streaming past what 16 CTAs hold, at the
    streaming kernel's own size."""
    bsz, m, k, n = bmkn
    lay = ttrail.layout(m, n, k, bsz, itemsize)
    assert (lay.path, lay.cluster, lay.per_sm) == want
    assert lay.smem_bytes <= BUDGET
    if lay.per_sm == 2:
        assert 2 * (lay.smem_bytes + ttrail.CTA_RESERVE) <= ttrail.SM_SMEM
    if lay.path == "cluster":
        assert 1 <= lay.cluster <= ttrail.MAX_CLUSTER
        assert lay.rows % 8 == 0 and lay.cluster * lay.rows >= m
        assert (lay.cluster - 1) * lay.rows < m   # no idle CTA
        kp = -(-k // 4) * 4
        ncm = 4 * -(-(ttrail.BN // 4) // lay.cluster)
        elems = (lay.rows * (kp + ttrail.PAD) + lay.rows * (ttrail.BN + ttrail.PAD)
                 + 2 * lay.cluster * kp * ncm + kp * ncm + 2 * kp * ttrail.BN
                 + -(-k * k // 4) * 4)
        assert lay.smem_bytes == 32 + elems * itemsize   # + 4 mbarriers
    else:
        assert lay.smem_bytes == ttrail.smem_bytes(k, itemsize)
        assert lay.smem_bytes == tops.wy_trailing_smem_bytes(k, itemsize)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_wy_trailing_streams_past_the_cluster(itemsize):
    """Growing m, the layout stays a cluster sized for two CTAs an SM,
    then for one, until 16 CTAs no longer hold the rows, and streams from
    there on; every cluster is the smallest that holds the rows at about
    CLUSTER_ROWS a CTA and fits."""
    k, seq = 32, []
    for m in range(256, 40001, 256):
        lay = ttrail.layout(m, 4064, k, 1, itemsize)
        assert lay.smem_bytes <= BUDGET
        key = (lay.path, lay.per_sm)
        if not seq or seq[-1] != key:
            seq.append(key)
        if lay.path == "cluster":
            assert lay.cluster >= min(16, math.ceil(m / ttrail.CLUSTER_ROWS))
            assert lay.rows * lay.cluster >= m
            if lay.cluster > 1:   # one CTA fewer would not fit
                fewer = -(-math.ceil(m / (lay.cluster - 1)) // 8) * 8
                assert (lay.cluster - 1 < math.ceil(m / ttrail.CLUSTER_ROWS)
                        or ttrail._cluster_smem(fewer, k, lay.cluster - 1,
                                                itemsize) > BUDGET
                        or lay.per_sm == 2)
    assert seq == [("cluster", 2), ("cluster", 1), ("streaming", 0)]


def test_wy_trailing_records_no_launch_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version: no launch is
    counted and the last launch's layout is not touched."""
    before = dict(ttrail.LAST_GRID)
    tmo.reset_launch_counts()
    rng = np.random.default_rng(3)
    v, t, c = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((2, 40, 8), (2, 8, 8), (2, 40, 9)))
    want = tmo.wy_body(v, t, c)
    tops.wy_trailing_(v, t, c)
    assert torch.equal(c, want)
    assert tmo.LAUNCHES["WY_TRAILING"] == 0 and ttrail.LAST_GRID == before


# ---------------------------------------------------------------------------
# the megakernel's shared memory and the auto rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nb", [16, 32, 64])
def test_megakernel_smem_and_auto_rule(nb, itemsize):
    """At nb 16/32/64, fp32/fp64: the auto rule resolves as the
    reference's (its 15-tile model, against the card's budget), the launch's double-buffered size is
    what ``check_smem`` holds against the budget, and wherever the auto
    rule picks the megakernel its launch fits."""
    p = q = 6
    mode = teng.resolve_dispatch_mode(p, q, nb, itemsize)
    assert mode == jeng.resolve_dispatch_mode(p, q, nb, itemsize,
                                              vmem_budget=BUDGET)
    need = tmo.megakernel_launch_smem_bytes(nb, itemsize)
    if need <= BUDGET:
        teng.check_smem(nb, itemsize, "megakernel")
    else:
        with pytest.raises(ValueError, match=str(need)):
            teng.check_smem(nb, itemsize, "megakernel")
    if mode == "megakernel":
        assert need <= BUDGET
    # nb = 64 fp64: the double buffers alone would be 8 tiles of 64 rows
    # at pitch 68 = 272 KiB.
    pitch = tmo.operand_pitch(nb, itemsize)
    two = (8 * nb * pitch + max(2 * nb * nb + 2 * nb + tmo.XCH_ELEMS,
                                2 * nb * pitch)) * itemsize
    assert tmo.megakernel_stages(nb, itemsize) == (2 if two <= BUDGET else 1)


def test_forced_megakernel_raises_naming_the_size():
    """A forced megakernel whose launch does not fit raises before any
    launch, naming the size it needs (nb = 128 fp32: one buffer per slot
    and the scratch are ~387 KiB)."""
    need = tmo.megakernel_launch_smem_bytes(128, 4)
    assert need > BUDGET
    with pytest.raises(ValueError, match=f"{need} > {BUDGET}"):
        teng.factor_tiles(torch.zeros(1, 1, 128, 128), p=1, q=1, nb=128,
                          use_kernel=True, dispatch_mode="megakernel")
    cfg = tplan.QRConfig(method="tiled", block=64, dispatch_mode="megakernel")
    from repro_torch.core import tilegraph as ttg
    assert ttg._smem_tiled(640, 640, cfg, 8) == \
        tmo.megakernel_launch_smem_bytes(64, 8)


# ---------------------------------------------------------------------------
# the megakernel's runs
# ---------------------------------------------------------------------------

def _level(p, q, lv):
    table, _, nslots = teng.megakernel_task_table(p, q)
    rows = table[lv * nslots:(lv + 1) * nslots]
    return rows[:int((rows[:, 0] != 4).sum())]


def _walk(rows, batch, start, end):
    """The kernel's decisions over one run (``megakernel_walk``): for each
    item after the first, whether it keeps the V tile and T of the item
    before it."""
    n = len(rows)
    out = []
    for w in range(start + 1, end):
        b, t = divmod(w, n)
        pb, pt = divmod(w - 1, n)
        chain = (b == pb and rows[t, 0] == rows[pt, 0]
                 and rows[t, 0] in (1, 3))
        out.append((w, chain and rows[t, 12] != 0, chain and rows[t, 15] != 0))
    return out


RUN_CASES = [(3, 3, 1, 1), (5, 3, 7, 4), (5, 3, 7, 13), (8, 8, 1, 119),
             (8, 8, 3, 40), (18, 18, 60, 264), (18, 18, 15, 264),
             (20, 20, 1, 119), (4, 6, 9, 1000), (6, 4, 2, 5)]


@pytest.mark.parametrize("p,q,batch,grid", RUN_CASES, ids=str)
def test_megakernel_runs_cover_each_level_once(p, q, batch, grid):
    """Every level's runs cover its work list exactly once, in order, one
    run per CTA, each with the level's task count, its first task's table
    slot and that task's (kind, k, i, j); a level of at most ``grid`` items gives a CTA at most
    one; each run weighs at most an even share of the level's
    weight plus one heaviest task and a sixteenth of an even run of them
    at each end; a boundary falls inside a same-(k, i) SSRFB or same-k
    LARFB group only where both of the group's ends are farther than that
    sixteenth."""
    runs = teng.megakernel_runs(p, q, batch, grid)
    _, nlevels, _ = teng.megakernel_task_table(p, q)
    assert runs.shape == (nlevels, grid, 8) and runs.dtype == np.int32
    table, _, nslots = teng.megakernel_task_table(p, q)
    for lv in range(nlevels):
        rows = _level(p, q, lv)
        n = len(rows)
        total = batch * n
        assert (runs[lv, :, 2] == n).all()
        assert (runs[lv, :, 3] == runs[lv, :, 0] % n).all()
        np.testing.assert_array_equal(
            runs[lv, :, 4:], table[lv * nslots + runs[lv, :, 3], :4])
        r = runs[lv, :, :2]
        assert r[0, 0] == 0 and r[-1, 1] == total
        assert (r[1:, 0] == r[:-1, 1]).all() and (r[:, 1] >= r[:, 0]).all()
        covered = np.concatenate([np.arange(a, b) for a, b in r])
        np.testing.assert_array_equal(covered, np.arange(total))
        slack = total // grid // 16
        weights = np.tile(teng._task_weights(rows), batch)
        heavy = teng.HEAVY_TASK_WEIGHT
        if total <= grid:
            assert (r[:, 1] - r[:, 0]).max() == 1
        for a, b in r:
            assert weights[a:b].sum() <= (weights.sum() / grid + heavy
                                          + 2 * slack * heavy)
        chained = teng._chained(rows)
        for c in range(1, grid):
            x = int(r[c, 0])
            b, t = divmod(x, n)
            if x < total and t > 0 and chained[t]:
                g0 = t
                while chained[g0]:
                    g0 -= 1
                g1 = t
                while g1 < n and chained[g1]:
                    g1 += 1
                assert min(t - g0, g1 - t) > slack or x == int(r[c - 1, 0])


@pytest.mark.parametrize("p,q,batch,grid", RUN_CASES, ids=str)
def test_megakernel_runs_keep_only_shared_tiles(p, q, batch, grid):
    """Walking each run as the kernel does, a kept V tile or T is the one
    the item before it read, in the same slice; a run never keeps a tile
    across a slice boundary; and with one CTA per level on one matrix the
    kept tiles are the table's chained REUSE rows (the reference's reuse
    count of T fetches)."""
    runs = teng.megakernel_runs(p, q, batch, grid)
    _, nlevels, _ = teng.megakernel_task_table(p, q)
    kinds = list(tmo.MACRO_OPS)
    kept_t = 0
    for lv in range(nlevels):
        rows = _level(p, q, lv)
        n = len(rows)
        for start, end in runs[lv, :, :2]:
            for w, keep_v, keep_t in _walk(rows, batch, start, end):
                b, t = divmod(w, n)
                pb, pt = divmod(w - 1, n)
                cur = (kinds[rows[t, 0]], *rows[t, 1:4].tolist())
                prev = (kinds[rows[pt, 0]], *rows[pt, 1:4].tolist())
                if keep_v or keep_t:
                    assert b == pb and cur[0] == prev[0]
                if keep_v:
                    assert teng._task_reads(*cur)[0] == teng._task_reads(*prev)[0]
                    assert teng._task_reads(*cur)[0] not in teng._task_writes(*prev)
                if keep_t:
                    assert teng._task_t_source(*cur) == teng._task_t_source(*prev)
                kept_t += keep_t
    if batch == 1 and grid == 1:
        assert kept_t == teng.schedule_stats(p, q)["megakernel"]["reused_t_fetches"]

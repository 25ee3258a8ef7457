"""The port's distributed QR (``repro_torch.core.distgraph``, the
collective TSQR of ``repro_torch.core.tsqr``, ``repro_torch.distributed``)
against the JAX package's, on the CPU.

Two runs per module, started together and shared by every test here:

  * the port: four gloo ranks, each a process started from this file's
    rank program, joined through a ``file://`` store under ``tmp_path``
    (no TCP port), each writing what it computed to an ``.npz``;
  * the reference: one process with four forced host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) running the
    reference's ``shard_map`` paths on the same numpy inputs.  Its
    ``sharded_tiled_qr`` runs ``use_kernel=True`` (Pallas in interpret
    mode): on the installed jax its plain path fails at d > 1 (ROADMAP
    C8).

Tolerances: every factorization meets the conformance bar ``100 * eps *
max(m, n)`` on ||Q^T Q - I||_max and ||A - QR||_F / ||A||_F, and agrees
with the reference elementwise within that bar (R scaled by max |R|);
every rank holds the same bits; ``d == 1`` equals the tiled backend bit
for bit; ``compressed_psum``'s mean equals the mean of the ranks' decoded
contributions to fp32 rounding and the true mean within 1/127 of each
block's max.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import distgraph as jdist
import repro_torch
from repro_torch.core import distgraph as tdist
from repro_torch.core import tsqr as ttsqr
from repro_torch.distributed import sharding
from worker_threads import share_the_cores  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TILE = 16
# (m, n, requested domains): d = 2 and 4, p not divisible by d (160 rows
# are 10 tile rows), and a grid smaller than the world (2 tile rows).
SHARDED = [(256, 64, 2), (256, 64, 4), (160, 96, 2), (160, 96, 4),
           (32, 16, None)]
SHARDED_IDS = [f"{m}x{n}-d{d}" for m, n, d in SHARDED]
# Planning cases: (shape, block, ndomains, use_kernel) at 4 ranks.
DECISIONS = [((256, 64), 16, None, False), ((160, 96), 16, 4, False),
             ((32, 16), 16, None, False), ((64, 128), 16, None, False),
             ((512, 512), 32, 7, False), ((4096, 4096), 32, None, False),
             ((4096, 4096), 32, 2, False), ((8192, 2048), 32, None, False),
             ((256, 64), 16, None, True), ((4096, 4096), 32, None, True),
             ((4096, 4096), 32, 2, True), ((2048, 1024), 32, 1, True)]
DECISION_IDS = [f"{s[0]}x{s[1]}-b{b}-d{d}-{'k' if k else 'p'}"
                for s, b, d, k in DECISIONS]


def _mat(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _bar(m, n):
    return 100.0 * float(np.finfo(np.float32).eps) * max(m, n)


_RANK_PROGRAM = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    import repro_torch
    from repro_torch.core import distgraph, tilegraph, tsqr
    from repro_torch.distributed import compressed_psum
    from repro_torch.observability import metrics

    cases = json.loads(sys.argv[5])
    res = {}
    def mat(m, n, seed):
        return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)
    for m, n, d in cases["sharded"]:
        a = torch.from_numpy(mat(m, n, m + n))
        for uk in (False, True):
            q, r = distgraph.sharded_tiled_qr(a, tile=cases["tile"], use_kernel=uk,
                                              ndomains=d)
            res[f"st_{m}x{n}_{d}_{int(uk)}_q"] = q.numpy()
            res[f"st_{m}x{n}_{d}_{int(uk)}_r"] = r.numpy()
    # Through the planner: mode "r" and sign_fix, kernels' plain versions.
    a = mat(256, 64, 320)
    cfg = repro_torch.QRConfig(method="sharded_tiled", block=16, use_kernel=True)
    res["plan_r"] = repro_torch.qr(a, config=cfg.replace(mode="r"), device="cpu").numpy()
    q, r = repro_torch.qr(a, config=cfg.replace(sign_fix=True), device="cpu")
    res["plan_sf_q"], res["plan_sf_r"] = q.numpy(), r.numpy()
    # One domain on four ranks, and wide input: the tiled backend's bits.
    for key, (m, n, d) in {"d1": (96, 64, 1), "wide": (64, 128, None)}.items():
        a = torch.from_numpy(mat(m, n, 5))
        q, r = distgraph.sharded_tiled_qr(a, tile=16, ndomains=d)
        qt, rt = tilegraph.tiled_qr(a, tile=16)
        res[key + "_bitwise"] = np.array([torch.equal(q, qt) and torch.equal(r, rt)])
    # The collective TSQR: this rank's 64 rows of a 256 x 32 matrix.
    a = mat(256, 32, 7)
    mine = torch.from_numpy(a[rank * 64:(rank + 1) * 64])
    res["tsqr_r"] = tsqr.tsqr_tree_sharded(mine, None, qr_block=8).numpy()
    q, r = tsqr.distributed_qr(mine, None, qr_block=8)
    res["dqr_q"], res["dqr_r"] = q.numpy(), r.numpy()
    q, r = tsqr.distributed_qr(mine, None, qr_block=8, use_kernel=True)
    res["dqr_k_q"], res["dqr_k_r"] = q.numpy(), r.numpy()
    # compressed_psum: rank i's row of two seeded (4, 1000) arrays.
    g = np.random.default_rng(11).standard_normal((world, 1000)).astype(np.float32)
    e = 0.01 * np.random.default_rng(12).standard_normal((world, 1000)).astype(np.float32)
    red, err = compressed_psum({"g": torch.from_numpy(g[rank])}, None,
                               {"g": torch.from_numpy(e[rank])})
    res["psum"], res["psum_err"] = red["g"].numpy(), err["g"].numpy()
    res["solves_d4"] = np.array([metrics.counter_value(
        "distributed.solves", domains=4, mode="reduced")])
    # The auto route counts the group's ranks only on an opt-in (C10).
    plain = repro_torch.plan((4096, 4096), torch.float32,
                             repro_torch.QRConfig(use_kernel=False),
                             backend="cpu", explain=True)
    res["auto_4096"] = np.array([plain.config.method])
    res["auto_4096_why"] = np.array([
        plain.explain.decision("sharded_past_ceiling").reason])
    res["auto_4096_optin"] = np.array([repro_torch.plan(
        (4096, 4096), torch.float32,
        repro_torch.QRConfig(use_kernel=False, ndomains=world),
        backend="cpu").config.method])
    # C10: each rank's own seeded 256 x 128 fp64 matrix raises on every
    # rank; identical copies keep the bits of a solve without the check.
    mine = torch.from_numpy(np.random.default_rng(rank).standard_normal((256, 128)))
    try:
        distgraph.sharded_tiled_qr(mine, tile=32, device="cpu")
        res["c10_raised"] = np.array([""])
    except ValueError as e:
        res["c10_raised"] = np.array([type(e).__name__])
    # Copies of different shapes, one of them a single domain (16 x 16:
    # one tile row): every rank raises, none returns a local result.
    shaped = (16, 16) if rank == 0 else (256, 128)
    try:
        distgraph.sharded_tiled_qr(torch.from_numpy(mat(*shaped, 21)),
                                   tile=32, device="cpu")
        res["c10_shapes_raised"] = np.array([""])
    except ValueError as e:
        res["c10_shapes_raised"] = np.array([type(e).__name__])
    same = torch.from_numpy(mat(256, 128, 21))
    checked = distgraph.sharded_tiled_qr(same, tile=32, device="cpu")
    from repro_torch.distributed import sharding
    real = sharding.check_same_copies
    sharding.check_same_copies = lambda *a, **k: None
    try:
        unchecked = distgraph.sharded_tiled_qr(same, tile=32, device="cpu")
    finally:
        sharding.check_same_copies = real
    res["c10_same_bits"] = np.array([all(torch.equal(x, y) for x, y in
                                         zip(checked, unchecked))])
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
""")


_REFERENCE_PROGRAM = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.core import QRConfig, plan
    from repro.core.distgraph import sharded_tiled_qr
    from repro.core.tsqr import distributed_qr, tsqr_tree_sharded
    from repro.distributed.compression import compressed_psum
    assert jax.local_device_count() == 4, jax.local_device_count()
    out, cases = sys.argv[1], json.loads(sys.argv[2])
    res = {}
    def mat(m, n, seed):
        return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)
    for m, n, d in cases["sharded"]:
        q, r = sharded_tiled_qr(jnp.asarray(mat(m, n, m + n)), tile=cases["tile"],
                                use_kernel=True, ndomains=d)
        res[f"st_{m}x{n}_{d}_q"], res[f"st_{m}x{n}_{d}_r"] = np.asarray(q), np.asarray(r)
    mesh = jax.make_mesh((4,), ("x",))
    a = jnp.asarray(mat(256, 32, 7))
    f = jax.jit(shard_map(lambda al: tsqr_tree_sharded(al, "x", qr_block=8),
                          mesh=mesh, in_specs=P("x", None), out_specs=P()))
    res["tsqr_r"] = np.asarray(f(a))
    f = jax.jit(shard_map(lambda al: distributed_qr(al, "x", qr_block=8), mesh=mesh,
                          in_specs=P("x", None), out_specs=(P("x", None), P())))
    q, r = f(a)
    res["dqr_q"], res["dqr_r"] = np.asarray(q), np.asarray(r)
    g = np.random.default_rng(11).standard_normal((4, 1000)).astype(np.float32)
    e = 0.01 * np.random.default_rng(12).standard_normal((4, 1000)).astype(np.float32)
    f = jax.jit(shard_map(lambda gg, ee: compressed_psum({"g": gg[0]}, "x", {"g": ee[0]}),
                          mesh=mesh, in_specs=(P("x"), P("x")),
                          out_specs=({"g": P()}, {"g": P("x")})))
    red, err = f(jnp.asarray(g), jnp.asarray(e))
    res["psum"], res["psum_err"] = np.asarray(red["g"]), np.asarray(err["g"])
    decisions = []
    for shape, block, nd, uk in cases["decisions"]:
        s = plan(tuple(shape), jnp.float32, QRConfig(method="sharded_tiled",
                 block=block, ndomains=nd, use_kernel=uk), explain=True)
        c = s.config
        decisions.append(dict(block=c.block, ndomains=c.ndomains,
                              q_method=c.q_method, dispatch_mode=c.dispatch_mode,
                              rules=[x.rule for x in s.explain.decisions]))
    res["auto_4096"] = np.array([plan((4096, 4096), jnp.float32).config.method])
    np.savez(out, **res)
    with open(out + ".json", "w") as fh:
        json.dump(decisions, fh)
""")


def _env():
    # One thread a process: five processes share the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs, started together: ``(ranks, reference, decisions)`` —
    each rank's arrays, the reference's arrays and its plans."""
    tmp = tmp_path_factory.mktemp("distgraph")
    cases = json.dumps({"sharded": SHARDED, "tile": TILE,
                        "decisions": DECISIONS})
    ref_out = str(tmp / "reference.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_PROGRAM, ref_out, cases],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    rank_out = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(r), str(WORLD),
         str(tmp / "store"), rank_out[r], cases],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [dict(np.load(f)) for f in rank_out]
    with open(ref_out + ".json") as fh:
        decisions = json.load(fh)
    return ranks, dict(np.load(ref_out)), decisions


def _conforms(a, q, r):
    m, n = a.shape
    k = min(m, n)
    a64, q64, r64 = (np.asarray(x, np.float64) for x in (a, q, r))
    bar = _bar(m, n)
    orth = np.abs(q64.T @ q64 - np.eye(k)).max()
    rec = np.linalg.norm(q64 @ r64 - a64) / np.linalg.norm(a64)
    assert orth <= bar and rec <= bar, (orth, rec, bar)
    assert np.abs(np.tril(r64[:, :k], -1)).max() == 0.0


def _agrees(got, want, m, n, scale=1.0):
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= _bar(m, n) * scale, (err, _bar(m, n) * scale)


# ----------------------------------------------------------- on the ranks


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("m,n,d", SHARDED, ids=SHARDED_IDS)
def test_sharded_tiled_matches_reference(runs, m, n, d, use_kernel):
    """Each rank's (Q, R) meets the bar and agrees with the reference's
    4-device ``sharded_tiled_qr`` within it."""
    ranks, ref, _ = runs
    a = _mat(m, n, m + n)
    key = f"st_{m}x{n}_{d}"
    want_q, want_r = ref[key + "_q"], ref[key + "_r"]
    q = ranks[0][f"{key}_{int(use_kernel)}_q"]
    r = ranks[0][f"{key}_{int(use_kernel)}_r"]
    assert q.shape == want_q.shape and r.shape == want_r.shape
    _conforms(a, q, r)
    _agrees(q, want_q, m, n)
    _agrees(r, want_r, m, n, scale=float(np.abs(want_r).max()))


@pytest.mark.parametrize("m,n,d", SHARDED, ids=SHARDED_IDS)
def test_every_rank_holds_the_same_bits(runs, m, n, d):
    """The reference's invariant: after the merge every rank holds the
    identical R (and the all-gathered Q); idle ranks (the 2-tile-row grid
    runs 2 domains on 4 ranks) receive rank 0's."""
    ranks, _, _ = runs
    for uk in (0, 1):
        for part in ("q", "r"):
            key = f"st_{m}x{n}_{d}_{uk}_{part}"
            for other in ranks[1:]:
                assert np.array_equal(other[key], ranks[0][key]), key


def test_planner_modes_on_ranks(runs):
    """``qr`` with method "sharded_tiled" through the planner: ``sign_fix``
    gives diag(R) >= 0 in the bar, and mode "r" (one merge, no CQR2
    pass) is that R up to the signs, within the bar."""
    ranks, _, _ = runs
    a = _mat(256, 64, 320)
    r0 = ranks[0]
    _conforms(a, r0["plan_sf_q"], r0["plan_sf_r"])
    assert (np.diagonal(r0["plan_sf_r"]) >= 0).all()
    signs = np.sign(np.diagonal(r0["plan_r"]))
    _agrees(r0["plan_r"] * signs[:, None], r0["plan_sf_r"], 256, 64,
            scale=float(np.abs(r0["plan_sf_r"]).max()))
    for other in ranks[1:]:
        assert np.array_equal(other["plan_r"], r0["plan_r"])


@pytest.mark.parametrize("case", ["d1", "wide"])
def test_one_domain_is_tiled_bit_for_bit_on_ranks(runs, case):
    """``ndomains=1`` and wide input on four ranks run the tiled backend
    itself."""
    ranks, _, _ = runs
    assert all(bool(r[case + "_bitwise"][0]) for r in ranks)


@pytest.mark.parametrize("what", ["tsqr_r", "dqr"])
def test_collective_tsqr_matches_reference(runs, what):
    """``tsqr_tree_sharded`` and ``distributed_qr`` (plain and through the
    kernel wrappers) against the reference's ``shard_map`` versions on a
    256 x 32 matrix in four row blocks."""
    ranks, ref, _ = runs
    a = _mat(256, 32, 7)
    scale = float(np.abs(ref["dqr_r"]).max())
    if what == "tsqr_r":
        for r in ranks:
            _agrees(r["tsqr_r"], ref["tsqr_r"], 256, 32, scale)
            assert np.array_equal(r["tsqr_r"], ranks[0]["tsqr_r"])
        return
    for tag in ("dqr", "dqr_k"):
        q = np.concatenate([r[tag + "_q"] for r in ranks])
        _conforms(a, q, ranks[0][tag + "_r"])
        _agrees(q, ref["dqr_q"], 256, 32)
        _agrees(ranks[0][tag + "_r"], ref["dqr_r"], 256, 32, scale)
        assert all(np.array_equal(r[tag + "_r"], ranks[0][tag + "_r"])
                   for r in ranks)


def test_compressed_psum_four_ranks(runs):
    """The mean of the ranks' decoded contributions, on every rank; each
    rank's residual is its own ``(g + e) - Q(g + e)``; the reference's
    collective agrees."""
    from repro_torch.distributed import dequantize, quantize

    ranks, ref, _ = runs
    g = np.random.default_rng(11).standard_normal((WORLD, 1000)).astype(
        np.float32)
    e = 0.01 * np.random.default_rng(12).standard_normal(
        (WORLD, 1000)).astype(np.float32)
    target = torch.from_numpy(g + e)
    dec = torch.stack([dequantize(*quantize(t), t.shape) for t in target])
    want = dec.mean(0).numpy()
    tiny = 4 * float(np.finfo(np.float32).eps) * float(np.abs(want).max())
    blockmax = float(np.abs(g + e).max())
    for i, r in enumerate(ranks):
        assert np.abs(r["psum"] - want).max() <= tiny
        assert np.abs(r["psum"] - (g + e).mean(0)).max() <= blockmax / 127
        assert np.array_equal(r["psum_err"], (target[i] - dec[i]).numpy())
        assert np.array_equal(r["psum"], ranks[0]["psum"])
    assert np.abs(ranks[0]["psum"] - ref["psum"]).max() <= tiny
    assert np.abs(np.concatenate([r["psum_err"] for r in ranks])
                  - ref["psum_err"]).max() <= tiny


def test_auto_route_and_metrics_see_the_group(runs):
    """With four ranks and the opt-in ``QRConfig(ndomains=4)`` the auto
    route sends 4096^2 to ``sharded_tiled`` as the reference's 4-device
    plan does; without it a rank's own plan stays local (``geqrf_ht``,
    the rule rejected naming the opt-in: ROADMAP C10); every sharded
    solve at d = 4 counts ``distributed.solves``."""
    ranks, ref, _ = runs
    assert str(ref["auto_4096"][0]) == "sharded_tiled"
    for r in ranks:
        assert str(r["auto_4096_optin"][0]) == "sharded_tiled"
        assert str(r["auto_4096"][0]) == "geqrf_ht"
        assert "opt-in" in str(r["auto_4096_why"][0])
        # 256x64 and 160x96 at d = 4, plain and kernel, plus the planner's
        # sign_fix solve (256x64: 16 tile rows -> 4 domains).
        assert float(r["solves_d4"][0]) == 5.0


@pytest.mark.parametrize("case", ["c10_raised", "c10_shapes_raised"],
                         ids=["content", "shapes"])
def test_divergent_copies_raise_on_every_rank(runs, case):
    """ROADMAP C10: four ranks each holding their own 256 x 128 matrix,
    or rank 0 a 16 x 16 one (a single domain, which alone would not
    collect) and the others 256 x 128, all raise
    ``DivergentCopiesError`` (a ``ValueError``) instead of returning a
    factorization that mixes the copies or waiting on each other."""
    ranks, _, _ = runs
    assert all(str(r[case][0]) == "DivergentCopiesError" for r in ranks)


def test_identical_copies_keep_their_bits(runs):
    """The copies check changes no bit of a solve on identical copies."""
    ranks, _, _ = runs
    assert all(bool(r["c10_same_bits"][0]) for r in ranks)


@pytest.mark.parametrize("ranks,opt_in,want", [
    (4, None, "geqrf_ht"), (4, 4, "sharded_tiled"), (4, 2, "sharded_tiled"),
    (2, 2, "sharded_tiled"), (1, 2, "geqrf_ht"), (4, 1, "geqrf_ht")])
def test_auto_rule_counts_ranks_only_on_opt_in(ranks, opt_in, want,
                                                monkeypatch):
    """The auto rule on a group of ``ranks``: ``QRConfig(ndomains=k > 1)``
    opts in; without it (or with k = 1) the rule is rejected and names
    the opt-in when the group has more than one rank."""
    monkeypatch.setattr(sharding, "world_size", lambda: ranks)
    s = repro_torch.plan((4096, 4096), torch.float32, repro_torch.QRConfig(
        use_kernel=False, ndomains=opt_in), backend="cpu", explain=True)
    assert s.config.method == want
    why = s.explain.decision("sharded_past_ceiling").reason
    if want != "sharded_tiled":
        assert ("opt-in" in why) == (ranks > 1), why


def test_fingerprint_tells_copies_apart():
    """Shape, dtype and content (a permuted copy, and a +e/-e/-e/+e
    change on a rectangle's corners, which keeps every row and column
    sum) change the fingerprint; the same tensor gives the same bits."""
    a = torch.from_numpy(_mat(64, 32, 3))
    f = sharding.fingerprint(a)
    assert torch.equal(f, sharding.fingerprint(a.clone()))
    for other in (a.double(), a[:, :16], a.flip(0), a.T.contiguous(),
                  a + torch.finfo(torch.float32).eps):
        assert not torch.equal(f.view(torch.int64),
                               sharding.fingerprint(other).view(torch.int64))
    # On a grid of sixteenths every sum is exact: the corners' change
    # keeps each row and column sum bit for bit.
    g = torch.round(a * 16) / 16
    corners = g.clone()
    corners[3, 5] += 0.25
    corners[3, 20] -= 0.25
    corners[40, 5] -= 0.25
    corners[40, 20] += 0.25
    assert torch.equal(corners.sum(0), g.sum(0))
    assert torch.equal(corners.sum(1), g.sum(1))
    assert not torch.equal(sharding.fingerprint(g).view(torch.int64),
                           sharding.fingerprint(corners).view(torch.int64))


# ------------------------------------------------------------ in process


@pytest.mark.parametrize("case", DECISIONS, ids=DECISION_IDS)
def test_resolve_matches_reference(runs, case, monkeypatch):
    """``_resolve_sharded`` at four ranks decides what the reference's
    does at four devices: block (grown), domains, Q method, the lowering
    on the per-domain grid, and the decision trail."""
    _, _, decisions = runs
    want = decisions[DECISIONS.index(case)]
    monkeypatch.setattr(sharding, "world_size", lambda: WORLD)
    shape, block, nd, uk = case
    s = repro_torch.plan(shape, torch.float32, repro_torch.QRConfig(
        method="sharded_tiled", block=block, ndomains=nd, use_kernel=uk),
        backend="cpu", explain=True)
    c = s.config
    assert dict(block=c.block, ndomains=c.ndomains, q_method=c.q_method,
                dispatch_mode=c.dispatch_mode,
                rules=[x.rule for x in s.explain.decisions]) == want


@pytest.mark.parametrize("m,n,tile,requested,count", [
    (32, 32, 16, 8, 8), (512, 64, 16, 7, 8), (16, 64, 16, 8, 8),
    (512, 64, 16, 8, 2), (4096, 4096, 32, None, 4), (160, 96, 16, 3, 4),
    (96, 64, 16, None, 1)])
def test_effective_domains_matches_reference(m, n, tile, requested, count):
    assert tdist.effective_domains(m, n, tile, requested, count) == \
        jdist.effective_domains(m, n, tile, requested, count)


def test_plan_without_group_is_not_sharded():
    """Cards present but no process group: 4096^2 stays off
    ``sharded_tiled`` (one rank), and the plan counts one device."""
    s = repro_torch.plan((4096, 4096), torch.float32, backend="cuda",
                         explain=True)
    assert s.config.method != "sharded_tiled"
    assert s.explain.ndevices == 1
    assert "single device" in s.explain.decision("sharded_past_ceiling").reason
    assert sharding.world_size() == 1


def test_d1_without_group_is_tiled_bit_for_bit():
    """``method="sharded_tiled"`` with no process group (and
    ``ndomains=1``) equals ``method="tiled"`` bit for bit."""
    a = _mat(80, 48, 4)
    for extra in ({}, {"ndomains": 1}, {"mode": "r"}):
        cfg = repro_torch.QRConfig(method="sharded_tiled", block=16, **extra)
        got = repro_torch.qr(a, config=cfg, device="cpu")
        want = repro_torch.qr(a, config=cfg.replace(method="tiled"),
                              device="cpu")
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert torch.equal(g, w)


def test_kernels_never_run_a_tile_they_cannot_hold():
    """A per-domain grid that needs tile 128 (one domain at 8192 x 2048)
    raises by name on the kernel path; the plain lowering plans."""
    with pytest.raises(ValueError, match="needs tile 128"):
        repro_torch.plan((8192, 2048), torch.float32,
                         repro_torch.QRConfig(method="sharded_tiled"),
                         backend="cuda")
    s = repro_torch.plan((8192, 2048), torch.float32, repro_torch.QRConfig(
        method="sharded_tiled", use_kernel=False), backend="cuda")
    assert s.config.block == 128


def test_mode_and_group_validation(monkeypatch):
    with pytest.raises(ValueError, match="modes"):
        tdist.sharded_tiled_qr(torch.zeros(32, 16), mode="full")
    with pytest.raises(ValueError, match="thin Q"):
        repro_torch.plan((256, 128), torch.float32, repro_torch.QRConfig(
            method="sharded_tiled", mode="full"), backend="cpu")
    monkeypatch.setattr(sharding, "group_size", lambda group=None: 3)
    with pytest.raises(ValueError, match="power-of-two"):
        ttsqr.butterfly_merge_r(torch.eye(4), None, lambda s: s[:4])
    with pytest.raises(ValueError, match="ndomains"):
        sharding.row_domain_mesh(4)

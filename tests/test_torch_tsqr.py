"""The port's single-device TSQR (``repro_torch.core.tsqr``) against the
JAX package's: the R of the reduction tree (leaves and merges, an odd
block carried up a level), thin Q with and without refinement, and the
``tsqr`` method on a stack.

Inputs are made with numpy from fixed seeds and handed to both packages;
float64 cases enable x64 on the JAX side with the scoped
``jax.enable_x64(True)``.

Tolerance: R and Q are held to ``10 * eps * m * max(1, max |jax|)`` — the
same blocked factorizations summed in other orders (a tenth of the
conformance bar, whose ``100 * eps * m`` they must also meet).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsqr as jtsqr
import repro_torch
from repro_torch.core import tsqr as ttsqr
from repro_torch.core.plan import QRConfig
from worker_threads import share_the_cores  # noqa: F401  (autouse)

DTYPES = ("float32", "float64")


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,nblocks", [(64, 8, 4), (96, 12, 3), (80, 10, 8)])
def test_tsqr_r_and_qr_match_jax(m, n, nblocks, dtype):
    """R of the tree and (Q, R) with and without refinement, at qr_block
    4 (several panels per leaf); the kernel path (on the CPU: the kernels'
    plain versions) too."""
    a = np.random.default_rng(m + n).standard_normal((m, n)).astype(dtype)
    kw = dict(nblocks=nblocks, qr_block=4)
    with _x64(dtype):
        ja = jnp.asarray(a)
        want = [np.asarray(jtsqr.tsqr_r(ja, **kw))]
        for refine in (False, True):
            want += [np.asarray(x) for x in jtsqr.tsqr_qr(ja, refine=refine, **kw)]
    tol = 10 * float(np.finfo(dtype).eps) * m
    bar = 100 * float(np.finfo(dtype).eps) * m
    for use_kernel in (False, True):
        ta = torch.from_numpy(a)
        got = [ttsqr.tsqr_r(ta, use_kernel=use_kernel, **kw)]
        for refine in (False, True):
            got += list(ttsqr.tsqr_qr(ta, refine=refine, use_kernel=use_kernel,
                                      **kw))
        for g, w in zip(got, want):
            _close(g.numpy(), w, tol)
        q, r = (x.numpy().astype(np.float64) for x in got[3:])
        assert np.abs(q.T @ q - np.eye(n)).max() <= bar
        assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) <= bar
    with pytest.raises(ValueError, match="not divisible"):
        ttsqr.tsqr_r(torch.from_numpy(a), nblocks=7)


def test_tsqr_stack_is_one_tree():
    """A (3, 96, 16) stack through the ``tsqr`` method equals each matrix
    solved alone (on the card each tree level is one factorization of
    every matrix's blocks); every mode the method has."""
    a = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 96, 16)))
    for mode in ("reduced", "r"):
        cfg = QRConfig(method="tsqr", block=8, mode=mode, sign_fix=True)
        out = repro_torch.qr(a, config=cfg, device="cpu")
        out = out if isinstance(out, tuple) else (out,)
        for i in range(3):
            one = repro_torch.qr(a[i], config=cfg, device="cpu")
            one = one if isinstance(one, tuple) else (one,)
            for x, y in zip(out, one):
                torch.testing.assert_close(x[i], y, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="thin Q only"):
        repro_torch.qr(a, config=QRConfig(method="tsqr", mode="full"),
                       device="cpu")


# ---------------------------------------------------------------------------
# the collective layer (more ranks: tests/test_torch_distgraph.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_collective_tsqr_on_one_rank_matches_jax(use_kernel):
    """Without a process group (one rank, no merge round)
    ``tsqr_tree_sharded`` and ``distributed_qr`` against the reference's
    ``shard_map`` versions on a one-device mesh, within ``10 * eps * m``
    (scaled by max |R|) and the conformance bar."""
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map

    m, n = 96, 12
    a = np.random.default_rng(21).standard_normal((m, n)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("x",))
    rows = P("x", None)
    want_r = np.asarray(shard_map(
        lambda x: jtsqr.tsqr_tree_sharded(x, "x", qr_block=4), mesh=mesh,
        in_specs=rows, out_specs=P())(jnp.asarray(a)))
    want_q, want_r2 = (np.asarray(x) for x in shard_map(
        lambda x: jtsqr.distributed_qr(x, "x", qr_block=4), mesh=mesh,
        in_specs=rows, out_specs=(rows, P()))(jnp.asarray(a)))
    ta = torch.from_numpy(a)
    tol = 10 * float(np.finfo(np.float32).eps) * m
    _close(ttsqr.tsqr_tree_sharded(ta, None, qr_block=4,
                                   use_kernel=use_kernel).numpy(), want_r, tol)
    q, r = ttsqr.distributed_qr(ta, None, qr_block=4, use_kernel=use_kernel)
    _close(q.numpy(), want_q, tol)
    _close(r.numpy(), want_r2, tol)
    bar = 100 * float(np.finfo(np.float32).eps) * m
    q64, r64 = q.double().numpy(), r.double().numpy()
    assert np.abs(q64.T @ q64 - np.eye(n)).max() <= bar
    assert np.linalg.norm(a - q64 @ r64) / np.linalg.norm(a) <= bar


def test_butterfly_stacks_the_lower_rank_on_top(monkeypatch):
    """Both partners of a round reduce the same stack — the lower rank's R
    on top — so they end with the same bits (two ranks simulated: the
    exchange hands each the other's R)."""
    from repro_torch.distributed import sharding

    g = torch.Generator().manual_seed(0)
    r0, r1 = (torch.triu(torch.randn(6, 6, generator=g)) for _ in range(2))
    stacks, results = [], []

    def combine(stack):
        stacks.append(stack.clone())
        return ttsqr._local_r(stack, qr_block=4)

    for rank, mine, theirs in ((0, r0, r1), (1, r1, r0)):
        monkeypatch.setattr(sharding, "group_size", lambda group=None: 2)
        monkeypatch.setattr(sharding, "group_rank",
                            lambda group=None, rank=rank: rank)

        def exchange(t, peer, group, rank=rank, theirs=theirs):
            assert peer == 1 - rank and torch.equal(t, (r0, r1)[rank])
            return theirs

        monkeypatch.setattr(sharding, "exchange", exchange)
        results.append(ttsqr.butterfly_merge_r(mine, None, combine))
    assert torch.equal(stacks[0], stacks[1])
    assert torch.equal(stacks[0][:6], r0)
    assert torch.equal(results[0], results[1])

"""The port's batched optimizer-step orthogonalization
(``repro_torch.optim.batched_ortho``) against the reference's, on the
CPU, and its robustness seam.

Tolerances: a member's sign-fixed thin Q against the reference's (or the
leafwise route's) within the conformance bar ``100 * eps * max(m, n)``
of the member's shape, elementwise; a Muon step's params within ``lr *``
that bar.  Plans are compared exactly: the same class keys, members,
routes and methods.

Robustness (the port's rule for kernels, ROADMAP C): an injected
``output`` corruption walks ``batched -> leafwise``; a class that ran on
the kernels and whose own output fails its health check raises
``KernelFault`` — the plain leafwise route never hides a broken kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import batched_ortho as RB
from repro.optim import qr_orthogonalize_2d as ref_orth
from repro.serving.bucketing import BucketingPolicy as RPolicy
from repro_torch import QRConfig
from repro_torch.observability import metrics
from repro_torch.optim import (DEFAULT_ORTHO_POLICY, muon_init, muon_update,
                               plan_batched_ortho, qr_orthogonalize_2d)
from repro_torch.optim import batched_ortho as TB
from repro_torch.robustness import escalate, inject, verify
from repro_torch.serving.bucketing import BucketingPolicy, pad_dim
from worker_threads import share_the_cores  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)


def _bar(shape, eps=EPS32):
    return 100.0 * eps * max(shape[-2:])


def _mk(shapes, seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _ortho(leaves, **kw):
    return TB.batched_orthogonalize([torch.from_numpy(l) for l in leaves],
                                    device="cpu", **kw)


def _leafwise(leaf):
    stack = leaf.reshape((-1,) + tuple(leaf.shape[-2:]))
    return torch.stack([qr_orthogonalize_2d(x) for x in stack]).reshape(
        leaf.shape)


def _assert_parity(leaves, outs):
    """Each output against the leafwise route, within the bar."""
    for leaf, o in zip(leaves, outs):
        t = torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else leaf
        assert o.shape == t.shape and o.dtype == t.dtype
        err = float((o.float() - _leafwise(t).float()).abs().max())
        assert err <= _bar(t.shape), (t.shape, err)


# ------------------------------------------------------------- planning


PLAN_MIXES = {
    "headline": [((3, 48, 48), np.float32), ((3, 48, 48), np.float32),
                 ((3, 96, 48), np.float32), ((3, 48, 96), np.float32),
                 ((40, 24), np.float32)],
    "ragged": [((45, 30), np.float32), ((48, 32), np.float32),
               ((48, 48), np.float32), ((2, 2, 48, 48), np.float32)],
    "dtypes": [((48, 48), np.float32), ((48, 48), np.float64),
               ((2, 48, 48), np.float64), ((64, 32), np.float32)],
    "smollm_like": [((3, 48, 48), np.float32), ((3, 48, 16), np.float32),
                    ((3, 48, 16), np.float32), ((3, 48, 48), np.float32),
                    ((3, 48, 96), np.float32), ((3, 48, 96), np.float32),
                    ((3, 96, 48), np.float32)],
}


@pytest.mark.parametrize("mix", sorted(PLAN_MIXES))
def test_plan_matches_reference(mix):
    """The same shape list plans to the same class keys, members, routes
    and methods in both packages (CPU backend)."""
    shapes = PLAN_MIXES[mix]
    with jax.enable_x64(True):
        ref = RB.plan_batched_ortho(shapes, backend="cpu")
    mine = plan_batched_ortho(shapes, backend="cpu")

    def rows(plan):
        return [(c.key.m, c.key.n, c.key.dtype, c.members, c.route,
                 c.method, c.dispatch_mode) for c in plan.classes]

    assert rows(mine) == rows(ref)
    assert (mine.dispatches, mine.n_matrices, mine.member_leaf) == (
        ref.dispatches, ref.n_matrices, ref.member_leaf)


def test_plan_dispatch_count_is_classes_not_leaves():
    """Twin of the reference's headline test."""
    plan = plan_batched_ortho(PLAN_MIXES["headline"], backend="cpu")
    assert plan.n_leaves == 5 and plan.n_matrices == 13
    routes = {(c.key.m, c.key.n): c.route for c in plan.classes}
    assert routes == {(48, 48): "batched", (96, 48): "batched",
                      (48, 32): "leafwise"}
    assert plan.dispatches == 3
    assert plan.batched_matrices == 12 and plan.leafwise_matrices == 1
    assert sorted(i for c in plan.classes for i in c.members) == \
        list(range(13))


def test_plan_singleton_class_routes_leafwise():
    (cls,) = plan_batched_ortho([((64, 32), np.float32)],
                                backend="cpu").classes
    assert cls.route == "leafwise" and "singleton" in cls.reason


def test_plan_batched_class_carries_explain_trail():
    (cls,) = plan_batched_ortho([((48, 48), np.float32)] * 3,
                                backend="cpu").classes
    assert cls.route == "batched" and cls.method is not None
    sel = cls.explain.selected
    assert sel is not None and sel.rule in cls.reason


def test_plan_rejects_vector_leaves():
    with pytest.raises(ValueError):
        plan_batched_ortho([((64,), np.float32)], backend="cpu")


def test_custom_policy_changes_classes():
    shapes = [((40, 40), np.float32), ((48, 48), np.float32)]
    fine = plan_batched_ortho(shapes, backend="cpu",
                              policy=BucketingPolicy(tile=8, max_waste=0.0))
    coarse = plan_batched_ortho(
        shapes, backend="cpu", policy=BucketingPolicy(tile=48,
                                                      max_waste=0.25))
    assert len(fine.classes) == 2 and len(coarse.classes) == 1
    ref = RB.plan_batched_ortho(shapes, backend="cpu",
                                policy=RPolicy(tile=48, max_waste=0.25))
    assert [c.members for c in coarse.classes] == \
        [c.members for c in ref.classes]


def test_default_policy_pads_at_tile_granularity():
    assert DEFAULT_ORTHO_POLICY == BucketingPolicy(tile=16, max_waste=0.0,
                                                   max_batch=512)
    kw = dict(tile=16, max_waste=0.0)
    for d in (48, 96, 192, 576, 1536):
        assert pad_dim(d, **kw) == d
    assert pad_dim(45, **kw) == 48


# --------------------------------------------------------------- parity


PARITY_MIXES = {
    "ragged": ([(48, 48), (96, 48), (48, 96), (45, 30), (3, 48, 48),
                (2, 2, 48, 48)], "auto"),
    "wide": ([(3, 24, 72), (3, 24, 72), (2, 16, 40)], "auto"),
    "tiled": ([(2, 96, 64), (96, 64), (64, 96)], "tiled"),
}


@pytest.mark.parametrize("mix", sorted(PARITY_MIXES))
def test_matches_reference(mix):
    """Every member against the reference's ``batched_orthogonalize`` on
    the same inputs: within the conformance bar of its shape."""
    from repro.core import QRConfig as RConfig

    shapes, method = PARITY_MIXES[mix]
    leaves = _mk(shapes)
    ref = RB.batched_orthogonalize([jnp.asarray(l) for l in leaves],
                                   backend="cpu",
                                   config=RConfig(method=method))
    outs = _ortho(leaves, config=QRConfig(method=method))
    for leaf, r, o in zip(leaves, ref, outs):
        assert o.shape == leaf.shape and o.dtype == torch.float32
        assert np.abs(o.numpy() - np.asarray(r)).max() <= _bar(leaf.shape)
    _assert_parity(leaves, outs)


def test_wide_singleton_keeps_its_orientation():
    """ROADMAP C6: a wide matrix alone in its class routes leafwise; the
    reference returns its Q transposed, (n, m), the port (m, n), equal to
    the reference's ``qr_orthogonalize_2d`` within the bar."""
    (leaf,) = _mk([(16, 40)])
    (ref,) = RB.batched_orthogonalize([jnp.asarray(leaf)], backend="cpu")
    assert ref.shape == (40, 16)
    (out,) = _ortho([leaf])
    assert out.shape == (16, 40)
    want = np.asarray(ref_orth(jnp.asarray(leaf)))
    assert np.abs(out.numpy() - want).max() <= _bar(leaf.shape)
    assert np.abs(out.numpy() - np.asarray(ref).T).max() <= _bar(leaf.shape)


def test_bf16_storage_matches_reference():
    """bf16 leaves accumulate in fp32 and return bf16 in both packages:
    within the bar plus one bf16 rounding."""
    leaves = _mk([(48, 48), (48, 48), (96, 48)])
    ref = RB.batched_orthogonalize(
        [jnp.asarray(l).astype(jnp.bfloat16) for l in leaves], backend="cpu")
    outs = TB.batched_orthogonalize(
        [torch.from_numpy(l).to(torch.bfloat16) for l in leaves],
        device="cpu")
    tol_b = float(torch.finfo(torch.bfloat16).eps)
    for leaf, r, o in zip(leaves, ref, outs):
        assert o.dtype == torch.bfloat16
        err = np.abs(o.float().numpy() - np.asarray(r.astype(jnp.float32)))
        assert err.max() <= _bar(leaf.shape) + tol_b
    _assert_parity([torch.from_numpy(l).to(torch.bfloat16) for l in leaves],
                   outs)


def test_fp64_stays_fp64_and_matches_reference():
    leaves = _mk([(2, 48, 48), (96, 48), (96, 48)], dtype=np.float64)
    with jax.enable_x64(True):
        ref = RB.batched_orthogonalize([jnp.asarray(l) for l in leaves],
                                       backend="cpu")
        ref = [np.asarray(r) for r in ref]
    outs = _ortho(leaves)
    eps64 = float(np.finfo(np.float64).eps)
    for leaf, r, o in zip(leaves, ref, outs):
        assert o.dtype == torch.float64 and r.dtype == np.float64
        assert np.abs(o.numpy() - r).max() <= _bar(leaf.shape, eps64)


def test_singleton_fallback_is_bitwise():
    (leaf,) = _mk([(56, 24)])
    (out,) = _ortho([leaf])
    assert torch.equal(out, qr_orthogonalize_2d(torch.from_numpy(leaf)))


def test_precomputed_plan_reuse():
    leaves = _mk([(48, 48), (48, 48), (96, 48), (96, 48)])
    plan = plan_batched_ortho([(l.shape, l.dtype) for l in leaves],
                              backend="cpu")
    outs = _ortho(leaves, ortho_plan=plan)
    _assert_parity(leaves, outs)
    assert plan.dispatches == 2


def test_kernel_wrappers_match_plain_lowering():
    """``use_kernel=True`` on the CPU runs the kernel wrappers' plain
    versions (tiled megakernel walk, panel kernels): the same answers as
    the plain lowering within the bar."""
    leaves = _mk([(2, 300, 280), (3, 96, 32)])
    kern = _ortho(leaves, config=QRConfig(use_kernel=True))
    plain = _ortho(leaves, config=QRConfig(use_kernel=False))
    for leaf, a, b in zip(leaves, kern, plain):
        assert float((a - b).abs().max()) <= _bar(leaf.shape)


# ---------------------------------------------------------- muon_update


def _lm_like():
    rng = np.random.default_rng(7)

    def mk(*s):
        return torch.from_numpy((0.02 * rng.standard_normal(s)).astype(
            np.float32))

    params = {"embed.table": mk(128, 48), "layers.wq": mk(3, 48, 48),
              "layers.wk": mk(3, 48, 48), "layers.wv": mk(3, 48, 48),
              "layers.wo": mk(3, 48, 48), "layers.w_in": mk(3, 96, 48),
              "layers.w_out": mk(3, 48, 96), "layers.g": mk(3, 48)}
    grads = {k: 5 * mk(*p.shape) for k, p in params.items()}
    return params, grads


def test_muon_update_batched_matches_leafwise():
    """Twin of the reference's: params within lr * bar, momentum and
    second moments bitwise."""
    params, grads = _lm_like()
    state = muon_init(params)
    p_ref, s_ref = muon_update(grads, state, params, lr=0.02, device="cpu")
    p_bat, s_bat = muon_update(grads, state, params, lr=0.02,
                               batched_ortho=True, device="cpu")
    assert list(p_ref) == list(p_bat)
    for k in p_ref:
        tol = 0.02 * _bar(p_ref[k].shape if p_ref[k].ndim >= 2 else (1, 1))
        assert float((p_ref[k] - p_bat[k]).abs().max()) <= tol, k
    for k in s_ref.mu:
        assert torch.equal(s_ref.mu[k], s_bat.mu[k])
        assert torch.equal(s_ref.nu[k], s_bat.nu[k])


def test_muon_update_batched_two_steps():
    params, grads = _lm_like()
    p1, s1 = muon_update(grads, muon_init(params), params, lr=0.02,
                         batched_ortho=True, device="cpu")
    p2, s2 = muon_update(grads, s1, p1, lr=0.02, batched_ortho=True,
                         device="cpu")
    assert s2.step == 2
    assert all(torch.isfinite(v).all() for v in p2.values())


def test_muon_update_batched_emits_dispatch_metrics():
    params, grads = _lm_like()
    d0 = metrics.counter_value("optim.ortho_dispatches", route="batched")
    muon_update(grads, muon_init(params), params, lr=0.02,
                batched_ortho=True, device="cpu")
    assert metrics.counter_value("optim.ortho_dispatches",
                                 route="batched") > d0


# ------------------------------------------------------------ robustness


class TestBatchedOrthoChaos:
    """Twins of ``tests/test_robustness.py::TestBatchedOrthoChaos``, and
    the port's rule for a class that ran on the kernels."""

    def test_corrupt_slice_escalates_to_leafwise(self):
        leaves = [np.random.default_rng(19).standard_normal(
            (3, 32, 16)).astype(np.float32)]
        before = metrics.counter_total("optim.ortho_escalations")
        hops = metrics.counter_value("robustness.escalations",
                                     **{"from": "batched", "to": "leafwise",
                                        "reason": "health_check_failed"})
        with inject.active(inject.Fault(site="output", match="ortho:32x16",
                                        slice_index=1)):
            outs = _ortho(leaves, config=QRConfig(use_kernel=False,
                                                  verify=True))
        q = outs[0].numpy()
        assert np.isfinite(q).all()
        for i in range(3):
            defect = np.linalg.norm(q[i].T @ q[i] - np.eye(16))
            assert defect < verify.tolerance(np.float32, 32, 16)
        assert metrics.counter_total("optim.ortho_escalations") == before + 1
        assert metrics.counter_value(
            "robustness.escalations",
            **{"from": "batched", "to": "leafwise",
               "reason": "health_check_failed"}) == hops + 1

    def test_verify_off_matches_baseline(self):
        leaves = [np.random.default_rng(20).standard_normal(
            (2, 24, 8)).astype(np.float32)]
        a = _ortho(leaves, config=QRConfig(use_kernel=False))
        b = _ortho(leaves, config=QRConfig(use_kernel=False, verify=False))
        assert torch.equal(a[0], b[0])

    def test_injected_fault_on_kernel_class_escalates(self):
        """An injected corruption walks the ladder on a kernel-run class
        too: it is the fault harness, not the kernel."""
        leaves = [np.random.default_rng(21).standard_normal(
            (3, 32, 16)).astype(np.float32)]
        before = metrics.counter_total("optim.ortho_escalations")
        with inject.active(inject.Fault(site="output", match="ortho:32x16",
                                        slice_index=2)):
            outs = _ortho(leaves, config=QRConfig(use_kernel=True,
                                                  verify=True))
        assert torch.isfinite(outs[0]).all()
        assert metrics.counter_total("optim.ortho_escalations") == before + 1

    def test_kernel_class_own_bad_output_raises(self, monkeypatch):
        """A kernel-run class whose own output fails the health check
        raises ``KernelFault``, nothing escalated; the same bad output of
        a plain-lowering class escalates, as the reference's does."""
        from repro_torch.core.plan import QRSolver

        real = QRSolver.orthogonalize

        def broken(self, a):
            q = real(self, a).clone()
            q[1] *= 2.0               # slot 1: not orthonormal
            return q

        monkeypatch.setattr(QRSolver, "orthogonalize", broken)
        leaves = [np.random.default_rng(22).standard_normal(
            (3, 32, 16)).astype(np.float32)]
        before = metrics.counter_total("optim.ortho_escalations")
        with pytest.raises(escalate.KernelFault, match="slot 1"):
            _ortho(leaves, config=QRConfig(use_kernel=True, verify=True))
        assert metrics.counter_total("optim.ortho_escalations") == before
        outs = _ortho(leaves, config=QRConfig(use_kernel=False, verify=True))
        q = outs[0].numpy()
        assert np.abs(q[1].T @ q[1] - np.eye(16)).max() < \
            verify.tolerance(np.float32, 32, 16)
        assert metrics.counter_total("optim.ortho_escalations") == before + 1

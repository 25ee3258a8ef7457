"""The port's robustness layer (``repro_torch.robustness``) against the
reference's (``repro.robustness``): every injectable fault class fired
against the port's consumers (the service and plain ``qr()``) on the CPU,
and the port's answers held against the reference's.

Each test class twins one of tests/test_robustness.py.  Left out, with
the modules they need: ``TestBatchedOrthoChaos`` (the optimizer, ROADMAP
A10), ``TestWatchdogMedian`` and the LM fault-tolerance drill (A14).
The reference's jaxpr pins have no counterpart (the
port traces no programs); their twins check that verify-off runs the
plain solve and gives its bits.

Comparisons with the reference: the same injected faults give the same
escalation records (rung from, rung to, rule), the same quarantine
reasons and the same ``robustness.escalations`` counters;
``verify.check_batch`` on the same stacks gives the same verdicts and
residuals within 10·eps; ``inject.poison`` with the same seed poisons the
same elements; ``qr_algorithm_eig`` matches within 1e-4 relative.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro_torch
from repro.observability import metrics as jmetrics
from repro.robustness import inject as jinject
from repro.robustness import verify as jverify
from repro.serving import BucketingPolicy as JPolicy
from repro.serving import QRService as JService
from repro_torch.core import engine
from repro_torch.core.api import QRConfig, plan, qr
from repro_torch.kernels import _build
from repro_torch.observability import metrics
from repro_torch.robustness import escalate, guards, inject, verify
from repro_torch.serving import BucketingPolicy, QRService
from worker_threads import share_the_cores  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _disarm():
    """No fault leaks across tests; both registries start empty."""
    for mod in (inject, jinject):
        mod.reset()
    for reg in (metrics, jmetrics):
        reg.reset()
    yield
    for mod in (inject, jinject):
        mod.reset()


def _svc(**kw):
    kw.setdefault("policy", BucketingPolicy(tile=16, max_batch=4))
    kw.setdefault("device", "cpu")
    return QRService(**kw)


def _ref_svc(**kw):
    kw.setdefault("policy", JPolicy(tile=16, max_batch=4))
    kw.setdefault("use_kernel", False)
    return JService(**kw)


def _randn(m, n, seed=0):
    return np.asarray(
        np.random.default_rng(seed).standard_normal((m, n)), np.float32)


def _np(x):
    return None if x is None else np.asarray(x)


def _resid(a, q, r):
    a, q, r = map(_np, (a, q, r))
    return np.linalg.norm(a - q @ r) / max(np.linalg.norm(a), 1e-30)


def _tol(a):
    return verify.tolerance(np.asarray(a).dtype, *np.asarray(a).shape)


def _hops(escalations):
    return [(e.rung_from, e.rung_to, e.rule) for e in escalations]


def _escalation_counters(reg):
    return [(s["labels"], s["value"]) for s in
            reg.snapshot()["counters"].get("robustness.escalations", [])]


# ------------------------------------------------------------- admission

class TestAdmission:
    def test_rejects_nonfinite_with_named_reason(self):
        a = _randn(8, 4)
        a[2, 1] = np.nan
        with pytest.raises(guards.AdmissionError) as ei:
            guards.admit(a)
        assert ei.value.reason == "nonfinite_input"

    def test_rejects_bad_ndim_and_dtype(self):
        with pytest.raises(guards.AdmissionError) as ei:
            guards.admit(np.zeros(3, np.float32))
        assert ei.value.reason == "bad_ndim"
        with pytest.raises(guards.AdmissionError) as ei:
            guards.admit(np.zeros((3, 3), np.int32))
        assert ei.value.reason == "non_float_dtype"

    def test_condition_guard_is_opt_in(self):
        a = np.eye(4, dtype=np.float32)
        a[3, 3] = 1e-12
        guards.admit(a)
        with pytest.raises(guards.AdmissionError) as ei:
            guards.admit(a, policy=guards.AdmissionPolicy(max_cond=1e6))
        assert ei.value.reason == "ill_conditioned"
        assert guards.estimate_condition(np.eye(3)) == pytest.approx(1.0)

    def test_service_quarantines_bad_request_in_mixed_bucket(self):
        svc = _svc(verify=True)
        good = [_randn(24, 12, seed=s) for s in range(3)]
        bad = good[1].copy()
        bad[0, 0] = np.inf
        rids = [svc.submit(good[0]), svc.submit(bad), svc.submit(good[2])]
        res = svc.flush()
        assert res[rids[1]].error == "quarantined:nonfinite_input"
        assert res[rids[1]].q is None and not res[rids[1]].ok
        for rid, a in ((rids[0], good[0]), (rids[2], good[2])):
            assert res[rid].ok
            assert _resid(a, res[rid].q, res[rid].r) < _tol(a)
        assert svc.stats()["quarantined"] == 1

    def test_flush_with_only_quarantined_requests(self):
        svc = _svc()
        bad = _randn(8, 4)
        bad[:] = np.nan
        rid = svc.submit(bad)
        res = svc.flush()
        assert set(res) == {rid} and not res[rid].ok
        assert svc.flush() == {}


# ---------------------------------------------------------------- verify

def _stack(seeds, m, n, dtype="float32"):
    """A stack of seeded matrices and its float64 QR, all in ``dtype``."""
    a = np.stack([_randn(m, n, seed=s) for s in seeds]).astype(np.float64)
    q, r = np.linalg.qr(a)
    return a.astype(dtype), q.astype(dtype), r.astype(dtype)


class TestVerify:
    def test_tolerance_matches_conformance_rule(self):
        from test_conformance import _tol as conf_tol
        for dtype in (np.float32, np.float64):
            for m, n in ((64, 32), (8, 128)):
                assert verify.tolerance(dtype, m, n) == conf_tol(dtype, m, n)
                assert verify.tolerance(dtype, m, n) == \
                    jverify.tolerance(dtype, m, n)
        assert verify.tolerance(torch.float32, 64, 32) == \
            verify.tolerance(np.float32, 64, 32)

    def test_healthy_factorization_passes(self):
        a = torch.from_numpy(_randn(32, 16, seed=3))
        q, r = torch.linalg.qr(a)
        rep = verify.check_qr(a, q, r)
        assert rep.ok and rep.reason is None

    def test_corrupt_q_fails_with_reason(self):
        a = torch.from_numpy(_randn(32, 16, seed=3))
        q, r = torch.linalg.qr(a)
        bad = q.clone()
        bad[0, 0] = float("nan")
        rep = verify.check_qr(a, bad, r)
        assert not rep.ok and rep.reason == "nonfinite_output"
        rep = verify.check_qr(a, 2.0 * q, r)
        assert not rep.ok and rep.reason in ("residual_exceeds_tol",
                                             "ortho_defect_exceeds_tol")

    def test_r_only_gram_check(self):
        a = torch.from_numpy(_randn(32, 16, seed=4))
        r = torch.linalg.qr(a, mode="r")[1]
        assert verify.check_r(a, r).ok
        bad = verify.check_r(a, 1.5 * r)
        assert not bad.ok and bad.reason == "gram_residual_exceeds_tol"

    def test_batch_identifies_single_bad_slice(self):
        a, q, r = (torch.from_numpy(x) for x in _stack(range(4), 16, 8))
        q[2] = float("nan")
        reports = verify.check_batch(a, q, r)
        assert [rep.ok for rep in reports] == [True, True, False, True]
        assert reports[2].reason == "nonfinite_output"

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_check_batch_matches_reference(self, dtype):
        """The same stacks through both: the same verdicts and reasons,
        residuals and defects within 10·eps (the port's statistics are
        float64, the reference's in the input's dtype)."""
        a, q, r = _stack(range(5), 24, 12, dtype)
        q[1] *= 2.0                         # residual and orthogonality
        q[3, 0, 0] = np.nan                 # non-finite
        r[4] *= 1.5                         # residual only
        eps = float(np.finfo(dtype).eps)
        ctx = (jax.enable_x64(True) if dtype == "float64"
               else contextlib.nullcontext())
        with ctx:
            want = jverify.check_batch(jnp.asarray(a), jnp.asarray(q),
                                       jnp.asarray(r))
            want_r = jverify.check_batch(jnp.asarray(a), None,
                                         jnp.asarray(r))
        got = verify.check_batch(*(torch.from_numpy(x) for x in (a, q, r)))
        got_r = verify.check_batch(torch.from_numpy(a), None,
                                   torch.from_numpy(r))
        for mine, ref in zip(got + got_r, want + want_r):
            assert (mine.ok, mine.reason, mine.tol) == \
                (ref.ok, ref.reason, ref.tol)
            for x, y in ((mine.residual, ref.residual),
                         (mine.ortho_defect, ref.ortho_defect)):
                if np.isfinite(y):
                    assert abs(x - y) <= 10 * eps * max(1.0, abs(y)), (x, y)
                else:
                    assert not np.isfinite(x)
        assert [g.ok for g in got] == [True, False, True, False, False]

    def test_stats_ignore_the_callers_tf32_setting(self):
        """The statistics are float64, so a caller's TF32 matmul switch
        cannot move a verdict."""
        a, q, r = (torch.from_numpy(x) for x in _stack(range(2), 32, 16))
        before = verify.check_batch(a, q, r)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            after = verify.check_batch(a, q, r)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        assert before == after and all(rep.ok for rep in after)

    def test_env_default_resolution(self, monkeypatch):
        monkeypatch.delenv("REPRO_VERIFY", raising=False)
        assert verify.verify_enabled(None) is False
        monkeypatch.setenv("REPRO_VERIFY", "1")
        assert verify.verify_enabled(None) is True
        assert verify.verify_enabled(False) is False
        monkeypatch.setenv("REPRO_VERIFY", "off")
        assert verify.verify_enabled(None) is False

    def test_qrconfig_verify_validation(self):
        with pytest.raises(ValueError, match="verify"):
            QRConfig(verify="yes")
        assert QRConfig(verify=True).verify is True


# ------------------------------------------------------------ escalation

class TestEscalation:
    def test_ladder_is_monotone(self):
        assert escalate.ladder_below("megakernel") == (
            "wavefront", "oracle", "lapack")
        assert escalate.ladder_below("lapack") == ()
        assert escalate.ladder_below("planned") == ("oracle", "lapack")
        from repro.robustness import escalate as jescalate
        assert escalate.LADDER == jescalate.LADDER

    def test_classify_keeps_injected_site(self):
        assert escalate.classify(
            inject.InjectedFault("compile", "x"), "compile") \
            == "injected_compile"
        assert escalate.classify(ValueError("x"), "dispatch") \
            == "dispatch_failed"

    def test_record_fires_counter(self):
        labels = {"from": "megakernel", "to": "wavefront", "reason": "t"}
        before = metrics.counter_value("robustness.escalations", **labels)
        esc = escalate.record("megakernel", "wavefront", "t", "detail")
        assert esc.rule == "t" and esc.reason == "detail"
        assert metrics.counter_value("robustness.escalations",
                                     **labels) == before + 1

    def test_solve_below_recovers_and_exhausts(self):
        a = _randn(20, 10, seed=5)
        q, r, rung, escs = escalate.solve_below(a, start="megakernel",
                                                device="cpu")
        assert rung in ("oracle", "lapack") and escs == []
        assert q.device.type == "cpu"
        assert _resid(a, q, r) < _tol(a)
        with inject.active(inject.Fault(site="dispatch", times=None)):
            with pytest.raises(escalate.EscalationExhausted) as ei:
                escalate.solve_below(a, start="megakernel", device="cpu")
        assert len(ei.value.escalations) == 2

    def test_lapack_verify_failure_returns_factors(self):
        a = _randn(12, 6, seed=6)
        q, r, rung, _ = escalate.solve_below(a, start="oracle", device="cpu")
        assert rung == "lapack" or rung == "oracle"

    def test_build_failure_is_reraised_not_escalated(self, monkeypatch):
        """A kernel library that does not build raises through the ladder
        (plain qr() and the service), and the service's flush stays
        atomic; so does a real launch failure on the kernel path, while
        on the plain path it degrades."""
        def no_build(*args, **kwargs):
            raise _build.BuildError("nvcc not found")

        a = torch.from_numpy(_randn(40, 24, seed=7))
        cfg = QRConfig(method="tiled", block=8, use_kernel=True, verify=True)
        monkeypatch.setattr(engine, "prepare_dispatch", no_build)
        monkeypatch.setattr(engine, "factor_tiles_batched", no_build)
        with pytest.raises(_build.BuildError):
            qr(a, config=cfg, device="cpu")
        svc = _svc(use_kernel=True)
        rid = svc.submit(a)
        with pytest.raises(_build.BuildError):
            svc.flush()
        assert [r.rid for r in svc._pending] == [rid]
        assert svc.escalations == [] and svc.stats()["escalations"] == 0
        monkeypatch.setattr(engine, "factor_tiles_batched",
                            lambda *a, **k: (_ for _ in ()).throw(
                                RuntimeError("launch failed")))
        with pytest.raises(RuntimeError, match="launch failed"):
            qr(a, config=cfg, device="cpu")
        plain = QRConfig(method="tiled", block=8, use_kernel=False,
                         verify=True)
        q, r = qr(a, config=plain, device="cpu")
        assert _resid(a, q, r) < _tol(a)

    def test_real_kernel_launch_failure_propagates(self, monkeypatch):
        """A real (not injected) exception on a kernel rung raises out of
        the service's flush, restores the requests and records no hop;
        the same exception on the plain path walks the ladder."""
        def launch_failed(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(engine, "factor_tiles_batched", launch_failed)
        arrs = [_randn(24, 12, seed=s) for s in range(3)]
        svc = _svc(use_kernel=True, verify=True)
        rids = [svc.submit(a) for a in arrs]
        with pytest.raises(RuntimeError, match="illegal memory access"):
            svc.flush()
        assert [r.rid for r in svc._pending] == rids
        assert svc.escalations == [] and svc.stats()["escalations"] == 0
        plain = _svc(verify=True)
        outs = plain.submit_many(arrs)
        assert all(o.ok for o in outs)
        assert _hops(plain.escalations)[0] == (
            "oracle", "per-request", "dispatch_failed")
        for a, o in zip(arrs, outs):
            assert _resid(a, o.q, o.r) < _tol(a)

    @pytest.mark.parametrize("kernel", [True, False])
    def test_real_health_failure_on_a_kernel_rung_raises(self, monkeypatch,
                                                        kernel):
        """A kernel's own output that fails its health check raises
        KernelFault from the service and from qr(verify=True); on the
        plain path the slice re-solves below, as in the reference."""
        from repro_torch.serving import qr_service

        real = qr_service._factor_stack_padded

        def bad_slice(*args, **kwargs):
            out = tuple(x.clone() for x in real(*args, **kwargs))
            out[-1][0] = float("nan")
            return out

        monkeypatch.setattr(qr_service, "_factor_stack_padded", bad_slice)
        arrs = [_randn(24, 12, seed=s) for s in range(2)]
        svc = _svc(use_kernel=kernel, verify=True)
        if kernel:
            with pytest.raises(escalate.KernelFault, match="slice 0"):
                svc.submit_many(arrs)
            assert len(svc._pending) == 2
        else:
            outs = svc.submit_many(arrs)
            assert all(o.ok for o in outs)
            assert _hops(svc.escalations)[0] == (
                "oracle", "per-request", "health_check_failed")
        a = torch.from_numpy(_randn(40, 24, seed=8))
        solver = plan(tuple(a.shape), a.dtype,
                      QRConfig(method="tiled", block=8, use_kernel=kernel),
                      backend="cpu")

        class Broken:
            config = solver.config

            @staticmethod
            def solve(x):
                q, r = solver.solve(x)
                return q, torch.full_like(r, float("nan"))

        if kernel:
            with pytest.raises(escalate.KernelFault):
                escalate.checked_solve(Broken, a)
        else:
            q, r = escalate.checked_solve(Broken, a)
            assert _resid(a, q, r) < _tol(a)

    def test_budget_hop_walks_to_wavefront_without_tripping(self,
                                                            monkeypatch):
        """A real budget rejection of a forced megakernel moves the bucket
        megakernel -> wavefront at plan time on every flush, and does not
        count towards the breaker."""
        monkeypatch.setattr(engine, "DEFAULT_TABLE_BUDGET", 64)
        svc = _svc(policy=BucketingPolicy(tile=8, max_batch=2),
                   use_kernel=True, dispatch_mode="megakernel", verify=True,
                   breaker_threshold=2)
        for s in range(3):
            a = _randn(16, 8, seed=s)
            out = svc.submit_many([a])[0]
            assert out.ok and _resid(a, out.q, out.r) < _tol(a)
        assert _hops(svc.escalations) == [
            ("megakernel", "wavefront", "compile_failed")] * 3
        assert not svc.escalations[0].injected
        st = svc.stats()
        assert st["breaker_trips"] == 0 and st["breaker_open"] == 0


# ------------------------------------------------------------- injection

class TestInjection:
    def test_poison_is_deterministic(self):
        a = _randn(16, 16, seed=7)
        p1 = inject.poison(a, kind="nan", frac=0.1, seed=3)
        p2 = inject.poison(a, kind="nan", frac=0.1, seed=3)
        assert np.array_equal(np.isnan(p1), np.isnan(p2))
        assert np.isnan(p1).sum() == max(1, int(0.1 * a.size))

    @pytest.mark.parametrize("seed,frac,kind", [(0, 0.05, "nan"),
                                                (3, 0.1, "inf"),
                                                (11, 0.5, "nan")])
    def test_poison_matches_reference(self, seed, frac, kind):
        a = _randn(24, 12, seed=seed)
        mine = inject.poison(a, kind=kind, frac=frac, seed=seed)
        ref = jinject.poison(a, kind=kind, frac=frac, seed=seed)
        np.testing.assert_array_equal(mine, ref)

    def test_corrupt_output_on_tensors(self):
        q = torch.zeros(3, 4, 2)
        with inject.active(inject.Fault(site="output", slice_index=1)):
            bad_q, = inject.corrupt_output((q,), "x")
        assert torch.isnan(bad_q[1]).all() and not torch.isnan(bad_q[0]).any()
        assert not torch.isnan(q).any()          # the input is not written
        with inject.active(inject.Fault(site="output", kind="inf")):
            assert torch.isinf(inject.corrupt_output(q[0], "x")).all()

    def test_times_gating_and_scoping(self):
        f = inject.Fault(site="compile", times=2)
        with inject.active(f):
            assert inject.enabled()
            for _ in range(2):
                with pytest.raises(inject.InjectedFault):
                    inject.check("compile", "anything")
            inject.check("compile", "anything")
        assert not inject.enabled()
        inject.check("compile", "anything")

    def test_match_is_substring_on_tag(self):
        with inject.active(inject.Fault(site="dispatch", match="64x64")):
            inject.check("dispatch", "32x32:oracle")
            with pytest.raises(inject.InjectedFault) as ei:
                inject.check("dispatch", "64x64:megakernel")
        assert ei.value.site == "dispatch"

    def test_input_corruption_exercises_admission(self):
        svc = _svc()
        with inject.active(inject.Fault(site="input", match="24x12")):
            rid = svc.submit(_randn(24, 12, seed=8))
        res = svc.flush()
        assert res[rid].error == "quarantined:nonfinite_input"
        assert metrics.counter_value("robustness.faults_injected",
                                     site="input") >= 1


# -------------------------------------------------- service chaos matrix

class TestServiceChaos:
    def test_compile_fault_escalates_to_working_rung(self):
        svc = _svc(verify=True)
        arrs = [_randn(24, 12, seed=s) for s in range(3)]
        with inject.active(inject.Fault(site="compile", match="32x16")):
            outs = svc.submit_many(arrs)
        assert all(o.ok for o in outs)
        for a, o in zip(arrs, outs):
            assert _resid(a, o.q, o.r) < _tol(a)
        assert "injected_compile" in [e.rule for e in svc.escalations]

    def test_dispatch_fault_recovers_per_request(self):
        svc = _svc(verify=True)
        arrs = [_randn(24, 12, seed=s) for s in range(3)]
        with inject.active(inject.Fault(site="dispatch", match="32x16")):
            outs = svc.submit_many(arrs)
        assert all(o.ok for o in outs)
        for a, o in zip(arrs, outs):
            assert _resid(a, o.q, o.r) < _tol(a)

    def test_output_corruption_caught_and_healed_per_slice(self):
        svc = _svc(verify=True)
        arrs = [_randn(24, 12, seed=s) for s in range(3)]
        with inject.active(inject.Fault(site="output", match="32x16",
                                        slice_index=1)):
            outs = svc.submit_many(arrs)
        assert all(o.ok for o in outs)
        for a, o in zip(arrs, outs):
            assert np.isfinite(_np(o.q)).all()
            assert _resid(a, o.q, o.r) < _tol(a)
        assert svc.stats()["health_check_failures"] >= 1
        assert any(e.rule == "health_check_failed"
                   for e in svc.escalations)

    def test_vmem_fault_walks_megakernel_to_wavefront(self):
        svc = _svc(policy=BucketingPolicy(tile=8, max_batch=2),
                   use_kernel=True, dispatch_mode="megakernel", verify=True)
        arrs = [_randn(16, 8, seed=s) for s in range(2)]
        with inject.active(inject.Fault(site="vmem", match="megakernel")):
            outs = svc.submit_many(arrs)
        assert all(o.ok for o in outs)
        for a, o in zip(arrs, outs):
            assert _resid(a, o.q, o.r) < _tol(a)
        hops = [(e.rung_from, e.rung_to) for e in svc.escalations]
        assert ("megakernel", "wavefront") in hops

    def test_latency_fault_only_slows(self):
        svc = _svc()
        with inject.active(inject.Fault(site="latency", delay_s=0.05)):
            outs = svc.submit_many([_randn(12, 6, seed=9)])
        assert outs[0].ok

    def test_mode_r_verify_and_recovery(self):
        svc = _svc(verify=True)
        arrs = [_randn(24, 12, seed=s) for s in range(2)]
        with inject.active(inject.Fault(site="output", match="32x16",
                                        slice_index=0)):
            outs = svc.submit_many(arrs, mode="r")
        assert all(o.ok and o.q is None for o in outs)
        for a, o in zip(arrs, outs):
            r = _np(o.r)
            gram = np.linalg.norm(a.T @ a - r.T @ r) \
                / np.linalg.norm(a) ** 2
            assert gram < _tol(a)

    @pytest.mark.parametrize("site,kw,mode", [
        ("compile", {}, "reduced"),
        ("dispatch", {}, "reduced"),
        ("output", {"slice_index": 1}, "reduced"),
        ("output", {"slice_index": 0}, "r"),
        ("input", {}, "reduced"),
        ("vmem", {}, "reduced"),
    ])
    def test_faults_match_reference(self, site, kw, mode):
        """One fault of each site through the reference's service (its
        jnp oracle; the megakernel in interpret mode for ``vmem``) and the
        port's (``device="cpu"``): the same escalation records, the same
        quarantine reasons, the same escalation counters, and every
        answer within 10·eps·max(m, n)·max(1, max |ref|) of the
        reference's."""
        if site == "vmem":
            match, shape = "megakernel", (16, 8)
            mine = _svc(policy=BucketingPolicy(tile=8, max_batch=2),
                        use_kernel=True, dispatch_mode="megakernel",
                        verify=True)
            ref = _ref_svc(policy=JPolicy(tile=8, max_batch=2),
                           use_kernel=True, interpret=True,
                           dispatch_mode="megakernel", verify=True)
        else:
            match, shape = "24x12" if site == "input" else "32x16", (24, 12)
            mine, ref = _svc(verify=True), _ref_svc(verify=True)
        arrs = [_randn(*shape, seed=s) for s in range(3)]
        with inject.active(inject.Fault(site=site, match=match, **kw)):
            outs = mine.submit_many(arrs, mode=mode)
        with jinject.active(jinject.Fault(site=site, match=match, **kw)):
            want = ref.submit_many(arrs, mode=mode)
        assert _hops(mine.escalations) == _hops(ref.escalations)
        assert len(mine.escalations) >= (site not in ("input",))
        assert [o.error for o in outs] == [o.error for o in want]
        assert _escalation_counters(metrics) == \
            _escalation_counters(jmetrics)
        eps = float(np.finfo(np.float32).eps)
        for o, w in zip(outs, want):
            for x, y in ((o.q, w.q), (o.r, w.r)):
                if y is None:
                    assert x is None
                    continue
                y = np.asarray(y)
                tol = 10 * eps * max(shape) * max(1.0, float(np.abs(y).max()))
                assert float(np.abs(_np(x) - y).max()) <= tol


# -------------------------------------------------------- circuit breaker

class TestCircuitBreaker:
    def test_trips_evicts_and_pins(self):
        svc = _svc(verify=True, breaker_threshold=2)
        fault = inject.Fault(site="dispatch", match="32x16", times=None)
        with inject.active(fault):
            for s in range(2):
                svc.submit_many([_randn(24, 12, seed=s)])
        st = svc.stats()
        assert st["breaker_trips"] == 1 and st["breaker_open"] == 1
        assert not any(ck[0].m == 32 and ck[0].n == 16 for ck in svc._plans)
        with inject.active(inject.Fault(site="dispatch", match="32x16",
                                        times=None)):
            outs = svc.submit_many([_randn(24, 12, seed=11)])
        assert outs[0].ok
        assert svc.stats()["breaker_open"] == 1

    def test_breaker_raises_after_a_real_failure_on_the_kernel_path(
            self, monkeypatch):
        """A kernel-path bucket whose breaker would open with a real
        failure among its escalations raises instead of pinning the
        bucket to torch.linalg.qr; one opened by injected faults alone
        pins, as in the reference."""
        def oracle_failed(*args, **kwargs):
            raise RuntimeError("oracle failed")

        monkeypatch.setattr(escalate, "_oracle_qr", oracle_failed)
        svc = _svc(use_kernel=True, verify=True, breaker_threshold=2)
        with inject.active(inject.Fault(site="dispatch",
                                        match="32x16:megakernel")):
            with pytest.raises(escalate.KernelFault, match="not all"):
                svc.submit_many([_randn(24, 12, seed=0)])
        assert svc.stats()["breaker_open"] == 0
        monkeypatch.undo()
        pinned = _svc(use_kernel=True, verify=True, breaker_threshold=2)
        with inject.active(inject.Fault(site="dispatch",
                                        match="32x16:megakernel",
                                        times=None)):
            for s in range(2):
                out = pinned.submit_many([_randn(24, 12, seed=s)])[0]
                assert out.ok
        assert pinned.stats()["breaker_open"] == 1

    def test_resets_on_tuning_fingerprint_change(self):
        """A new tuning cache resets an open breaker (the new
        measurements may route the bucket around what kept failing), as
        the reference's does on the same steps."""
        from repro.tuning import cache as jcache
        from repro_torch.tuning import cache as tcache

        mine = _svc(verify=True, breaker_threshold=1)
        ref = _ref_svc(verify=True, breaker_threshold=1)
        arrs = [_randn(24, 12, seed=12)]
        with inject.active(inject.Fault(site="dispatch", match="32x16")):
            mine.submit_many(arrs)
        with jinject.active(jinject.Fault(site="dispatch", match="32x16")):
            ref.submit_many(arrs)
        assert mine.stats()["breaker_open"] == ref.stats()["breaker_open"] == 1
        prev = tcache.set_active_cache(tcache.TuningCache(
            source="test:breaker-reset"))
        jprev = jcache.set_active_cache(jcache.TuningCache(
            source="test:breaker-reset"))
        try:
            outs = mine.submit_many([_randn(24, 12, seed=13)])
            ref.submit_many([_randn(24, 12, seed=13)])
            assert outs[0].ok
            assert mine.stats()["breaker_open"] == \
                ref.stats()["breaker_open"] == 0
            assert mine.stats()["breaker_resets"] == 1
            assert metrics.counter_value(
                "serving.breaker_resets", service=mine._sid) == \
                jmetrics.counter_value("serving.breaker_resets",
                                       service=ref._sid)
        finally:
            tcache.set_active_cache(prev)
            jcache.set_active_cache(jprev)

    def test_trip_matches_reference(self):
        """The breaker's records, hop for hop, beside the reference's."""
        mine = _svc(verify=True, breaker_threshold=2)
        ref = _ref_svc(verify=True, breaker_threshold=2)
        for s in range(3):
            arrs = [_randn(24, 12, seed=s)]
            with inject.active(inject.Fault(site="dispatch", match="32x16",
                                            times=None)):
                mine.submit_many(arrs)
            with jinject.active(jinject.Fault(site="dispatch", match="32x16",
                                              times=None)):
                ref.submit_many(arrs)
        assert _hops(mine.escalations) == _hops(ref.escalations)
        for key in ("breaker_trips", "breaker_open", "escalations",
                    "dispatches", "matrices_served"):
            assert mine.stats()[key] == ref.stats()[key], key


# -------------------------------------------------------- flush atomicity

class TestFlushAtomicity:
    def test_error_restores_unprocessed_requests(self):
        svc = _svc(escalate=False)
        arrs = [_randn(24, 12, seed=s) for s in range(3)]
        rids = [svc.submit(a) for a in arrs]
        with inject.active(inject.Fault(site="dispatch", match="32x16")):
            with pytest.raises(inject.InjectedFault):
                svc.flush()
        assert len(svc._pending) == 3
        res = svc.flush()
        for rid, a in zip(rids, arrs):
            assert res[rid].ok
            assert _resid(a, res[rid].q, res[rid].r) < _tol(a)

    def test_compile_error_restores_requests(self):
        svc = _svc(escalate=False)
        rid = svc.submit(_randn(24, 12, seed=14))
        with inject.active(inject.Fault(site="compile", match="32x16")):
            with pytest.raises(inject.InjectedFault):
                svc.flush()
        assert [r.rid for r in svc._pending] == [rid]
        assert svc.flush()[rid].ok


# ------------------------------------------------------------- plain qr()

class TestCheckedQr:
    def test_output_corruption_recovered(self):
        a = _randn(20, 10, seed=15)
        with inject.active(inject.Fault(site="output", match="qr:20x10")):
            q, r = qr(a, config=QRConfig(verify=True), device="cpu")
        assert np.isfinite(_np(q)).all()
        assert _resid(a, q, r) < _tol(a)
        assert metrics.counter_value(
            "robustness.escalations",
            **{"from": "planned", "to": "oracle",
               "reason": "health_check_failed"}) == 1

    def test_mode_r_recovery(self):
        a = _randn(20, 10, seed=16)
        with inject.active(inject.Fault(site="output", match="qr:20x10")):
            r = qr(a, config=QRConfig(mode="r", verify=True), device="cpu")
        assert np.isfinite(_np(r)).all()

    def test_batched_input_heals_only_bad_slice(self):
        a = np.stack([_randn(16, 8, seed=s) for s in range(3)])
        healthy = qr(a, config=QRConfig(verify=False), device="cpu")
        with inject.active(inject.Fault(site="output", match="qr:3x16x8",
                                        slice_index=2)):
            q, r = qr(a, config=QRConfig(verify=True), device="cpu")
        q, r = _np(q), _np(r)
        assert np.isfinite(q).all() and np.isfinite(r).all()
        for i in range(3):
            assert _resid(a[i], q[i], r[i]) < _tol(a[i])
        for i in range(2):   # the healthy slices ship as solved
            np.testing.assert_array_equal(q[i], _np(healthy[0][i]))

    def test_verify_off_runs_the_plain_solve(self, monkeypatch):
        """The port's twin of the reference's jaxpr pin: verify off (and
        unset, with no ``REPRO_VERIFY``) never reaches the checker, and
        every setting returns the direct solve's bits on a healthy
        input."""
        monkeypatch.delenv("REPRO_VERIFY", raising=False)
        a = torch.from_numpy(_randn(32, 16, seed=17))
        q0, r0 = plan(a.shape, a.dtype, QRConfig(), backend="cpu").solve(a)
        for cfg in (QRConfig(verify=True), QRConfig(verify=False),
                    QRConfig()):
            q, r = qr(a, config=cfg, device="cpu")
            assert torch.equal(q, q0) and torch.equal(r, r0)
        monkeypatch.setattr(escalate, "checked_solve",
                            lambda *args: pytest.fail("checker reached"))
        qr(a, config=QRConfig(verify=False), device="cpu")
        qr(a, config=QRConfig(), device="cpu")

    def test_env_knob_turns_verification_on(self, monkeypatch):
        a = _randn(20, 10, seed=18)
        monkeypatch.setenv("REPRO_VERIFY", "1")
        with inject.active(inject.Fault(site="output", match="qr:20x10")):
            q, r = qr(a, device="cpu")
        assert np.isfinite(_np(q)).all() and _resid(a, q, r) < _tol(a)
        monkeypatch.setenv("REPRO_VERIFY", "0")
        with inject.active(inject.Fault(site="output", match="qr:20x10")):
            q, _ = qr(a, device="cpu")
        assert np.isfinite(_np(q)).all()   # verify off: no output hook ran

    def test_qr_algorithm_eig_matches_reference(self):
        """A seeded symmetric 16 x 16 with distinct eigenvalues, 200
        unshifted QR iterations in both packages: within 1e-4 relative."""
        from repro.core.api import qr_algorithm_eig as jeig
        rng = np.random.default_rng(21)
        qm, _ = np.linalg.qr(rng.standard_normal((16, 16)))
        lam = np.sort(rng.uniform(0.5, 10.0, 16))[::-1]
        a = (qm @ np.diag(lam) @ qm.T).astype(np.float32)
        a = (a + a.T) / 2
        mine = repro_torch.qr_algorithm_eig(a, iters=200, device="cpu")
        ref = np.asarray(jeig(jnp.asarray(a), iters=200))
        assert mine.shape == (16,)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        np.testing.assert_allclose(mine.numpy(), lam, rtol=0, atol=1e-2)


# ----------------------------------------------- end-to-end acceptance

class TestAcceptance:
    def test_three_simultaneous_fault_classes_one_flush(self):
        """(a) NaN request in a mixed bucket, (b) plan-build failure on
        one bucket, (c) health-check failure on a dispatch — all armed at
        once; one flush quarantines (a), escalates (b) and (c), returns
        conformance-correct results for every clean request, and records
        the reference's hops for the same flush."""
        small = [_randn(24, 12, seed=s) for s in range(3)]
        large = [_randn(40, 24, seed=s + 10) for s in range(2)]
        poisoned = inject.poison(small[1], kind="nan", seed=0)
        runs = []
        for svc, mod in ((_svc(verify=True), inject),
                         (_ref_svc(verify=True), jinject)):
            with mod.active(mod.Fault(site="compile", match="48x32"),
                            mod.Fault(site="output", match="32x16",
                                      slice_index=0)):
                rids_small = [svc.submit(small[0]), svc.submit(poisoned),
                              svc.submit(small[2])]
                rids_large = [svc.submit(a) for a in large]
                runs.append((svc, rids_small, rids_large, svc.flush()))
        (svc, rids_small, rids_large, res), ref_run = runs
        assert res[rids_small[1]].error == "quarantined:nonfinite_input"
        clean = [(rids_small[0], small[0]), (rids_small[2], small[2]),
                 (rids_large[0], large[0]), (rids_large[1], large[1])]
        for rid, a in clean:
            assert res[rid].ok, res[rid].error
            assert np.isfinite(_np(res[rid].q)).all()
            assert _resid(a, res[rid].q, res[rid].r) < _tol(a)
        rules = {e.rule for e in svc.escalations}
        assert {"injected_compile", "health_check_failed"} <= rules
        st = svc.stats()
        assert st["quarantined"] == 1 and st["escalations"] >= 2
        assert _hops(svc.escalations) == _hops(ref_run[0].escalations)
        assert metrics.counter_total("robustness.escalations") == \
            jmetrics.counter_total("robustness.escalations")
